"""Index reshapes between 'lso' (flat Nlat*Nspin*Norb) and 'nnn'
([Nlat,Nlat,Nspin,Nspin,Norb,Norb]) layouts.

Reference: ED_AUX_FUNX.f90:81-88 (index_stride_lso) and :151-350
(lso2nnn/nnn2lso reshape family).  The flat index convention is
``io = iorb + ilat*Norb + ispin*Norb*Nlat`` (0-based).
Implemented as pure reshape/transpose of host numpy arrays (the port
converts nnn <-> lso on the host and moves lso arrays to the device).
"""
from __future__ import annotations



def index_stride_lso(ilat: int, ispin: int, iorb: int, nlat: int, norb: int) -> int:
    """0-based flat index (ED_AUX_FUNX.f90:81-88)."""
    return iorb + ilat * norb + ispin * norb * nlat


def lso2nnn(h, nlat: int, nspin: int, norb: int):
    """[Nlso,Nlso,...] -> [Nlat,Nlat,Nspin,Nspin,Norb,Norb,...].

    Trailing axes (e.g. frequency) preserved.
    """
    extra = h.shape[2:]
    h6 = h.reshape((nspin, nlat, norb, nspin, nlat, norb) + extra)
    # (ispin,ilat,iorb, jspin,jlat,jorb, ...) -> (ilat,jlat,ispin,jspin,iorb,jorb,...)
    perm = (1, 4, 0, 3, 2, 5) + tuple(range(6, 6 + len(extra)))
    return h6.transpose(perm)


def nnn2lso(h, nlat: int, nspin: int, norb: int):
    """[Nlat,Nlat,Nspin,Nspin,Norb,Norb,...] -> [Nlso,Nlso,...]."""
    extra = h.shape[6:]
    perm = (2, 0, 4, 3, 1, 5) + tuple(range(6, 6 + len(extra)))
    h6 = h.transpose(perm)
    n = nlat * nspin * norb
    return h6.reshape((n, n) + extra)


def so2nn(h, nspin: int, norb: int):
    """[Nspin*Norb,Nspin*Norb,...] -> [Nspin,Nspin,Norb,Norb,...]."""
    extra = h.shape[2:]
    h4 = h.reshape((nspin, norb, nspin, norb) + extra)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(extra)))
    return h4.transpose(perm)


def nn2so(h, nspin: int, norb: int):
    """[Nspin,Nspin,Norb,Norb,...] -> [Nspin*Norb,Nspin*Norb,...]."""
    extra = h.shape[4:]
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(extra)))
    h4 = h.transpose(perm)
    n = nspin * norb
    return h4.reshape((n, n) + extra)


def assert_nnn_shape(h, nlat: int, nspin: int, norb: int, name: str = "H"):
    want = (nlat, nlat, nspin, nspin, norb, norb)
    if tuple(h.shape[:6]) != want:
        raise ValueError(f"{name}: expected leading shape {want}, got {h.shape}")
