"""cdmft_lanc_ed_torch: the PyTorch/CUDA port of the JAX/TPU package.

Cluster-DMFT with Lanczos exact diagonalization of cluster-impurity+bath
Hamiltonians in conserved (N_up, N_dw) sectors, on one NVIDIA H100.  The
public names follow the JAX package (and the reference's ``USE CDMFT_ED``
API), so each function's counterpart is found by name.  Entry points run
on the card unless given ``device="cpu"``.

This slice ports the real-Hamiltonian main path: the 2x2-plaquette CDMFT
loop with replica baths, ``ed_precision`` "mixed" or "complex128" (on a
real Hamiltonian both take the real path), with the f32 Krylov H·v in a
hand-written CUDA kernel (``csrc/fused_real_matvec.cu``).
"""
from .config import EDConfig, ed_read_input, read_input
from .bath import (BathBasis, DmftBath, get_bath_dimension,
                   pack_dmft_bath, unpack_dmft_bath, set_hbath,
                   delta_bath, g0and_bath, invg0_bath)
from .solver import EDSolver
from .eigenspace import EigenState, StateList
from .utils.reshape import lso2nnn, nnn2lso, so2nn, nn2so

__version__ = "0.1.0"
