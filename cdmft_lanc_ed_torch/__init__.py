"""cdmft_lanc_ed_torch: the PyTorch/CUDA port of the JAX/TPU package.

Cluster-DMFT with Lanczos exact diagonalization of cluster-impurity+bath
Hamiltonians in conserved (N_up, N_dw) sectors, on one NVIDIA H100.  The
public names follow the JAX package (and the reference's ``USE CDMFT_ED``
API), so each function's counterpart is found by name.  Entry points run
on the card unless given ``device="cpu"``.

The port covers the real-Hamiltonian CDMFT loop (the 2x2 plaquette with
replica baths; the f32 Krylov H·v in the hand-written CUDA kernel
``csrc/fused_real_matvec.cu``), doped loops (the chemical-potential
search), complex Hamiltonians (BHZ, Kane-Mele; ``csrc/fused_pair_matvec.cu``),
sectors of Ns >= 16 (``csrc/blk_spmm.cu``), the lattice kinetic energy,
the reference-format text files (``io.py``), real-space CDMFT over
inequivalent clusters (``lattice_solver.py``), the periodization schemes
(``periodize.py``), custom observables (``custom_obs.py``), band
structures and topological invariants (``postprocess.py``), the
reference-named ``ed_*`` aliases (``compat.py``) and the driver programs
(``drivers/``, run as ``python -m cdmft_lanc_ed_torch.drivers.<name>``).
Multi-card meshes are not ported.
"""
from .config import EDConfig, ed_read_input, read_input
from .bath import (BathBasis, DmftBath, get_bath_dimension,
                   pack_dmft_bath, unpack_dmft_bath, set_hbath,
                   hbath_basis_from_hloc, delta_bath, g0and_bath, invg0_bath)
from .solver import EDSolver
from .eigenspace import EigenState, StateList
from .utils.reshape import lso2nnn, nnn2lso, so2nn, nn2so

__version__ = "0.1.0"
