"""The parallel layer on torch.distributed: a 2-D ("sector", "dw")
DeviceMesh, the sector-parallel split of same-bucket batches, and the
dw-sharded H·v of large sectors (block-sparse factors, two all-to-alls
per application) and of dense-factor sectors."""
