"""The physics cases as driver programs, ported from the JAX package's
``drivers/`` scripts onto this package.

Each module parses the same flags as its counterpart, runs on the card
(``--cpu`` runs it on the CPU) and has ``main(argv=None)``, which returns
its results as a dict, so that a caller can check numbers rather than
printed text.  Run one as

    python -m cdmft_lanc_ed_torch.drivers.cdn_hm_2dsquare --input FILE
"""
