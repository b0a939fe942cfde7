"""The solver's mesh and the sector-parallel batch split.

Port of the JAX package's ``parallel/multichip.py``.  A 2-D
``DeviceMesh`` with axes ("sector", "dw") runs same-bucket sector batches
data-parallel along "sector" while each large sector's vector is sharded
along "dw" (``sharded_large``).  Under torch.distributed every rank runs
the whole solve (SPMD): along "sector", each rank of a column solves its
share of a batch (:func:`shard_batched_stack`) and the eigenpairs are
gathered so every rank holds all of them (:func:`gather_batched`); along
"dw", the ranks of a column hold rows of one vector.  Ranks of one "dw"
column that share a "sector" index compute the same thing, as the JAX
package's replicated shardings do.

The JAX module's ELL-gather functions (``stack_device_ops``,
``make_batched_sharded_matvec``, ``lanczos_step``) ride the
``ops/spmv.py`` path, which the port leaves out; they are not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from .distributed import MESH_DIMS

# the mesh installed for the solver's hot paths (None: one card)
_ACTIVE_MESH: Optional[DeviceMesh] = None


def set_solver_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Install a mesh for the solver: its "sector" axis splits
    same-bucket batches, its "dw" axis shards the vectors of sectors of
    dim >= 64·lanc_dim_threshold (diag) and the GF chains of large
    sectors (gf).  ``None`` uninstalls it."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_solver_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE_MESH


def make_mesh(n_devices: int, n_sector: int = 1, device=None) -> DeviceMesh:
    """The (n_sector, n_devices // n_sector) ("sector", "dw") mesh over
    the ranks of the initialised default process group, which must
    number ``n_devices`` (every rank runs the solve)."""
    if n_devices % n_sector:
        raise ValueError(f"make_mesh: {n_sector} sector columns do not "
                         f"divide {n_devices} ranks")
    if dist.get_world_size() != n_devices:
        raise ValueError(f"make_mesh: the process group has "
                         f"{dist.get_world_size()} ranks, not {n_devices}")
    ranks = torch.arange(n_devices).reshape(n_sector, n_devices // n_sector)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=MESH_DIMS)


def axis_info(mesh: Optional[DeviceMesh], axis: str):
    """(process group, size, this rank's index) of mesh axis ``axis``;
    (None, 1, 0) without a mesh or without that axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    i = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.size(i), mesh.get_local_rank(axis)


def has_axis(mesh: Optional[DeviceMesh], axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def sector_axis_size(mesh: Optional[DeviceMesh]) -> int:
    """Size of the mesh's "sector" axis (1 when absent): the
    sector-parallel dispatch width of the batched eigensolver."""
    return axis_info(mesh, "sector")[1]


def shard_batched_stack(items: Sequence, mesh: Optional[DeviceMesh],
                        axis: str = "sector"):
    """This rank's contiguous share of the batch ``items`` (a sequence,
    or a tensor's leading axis) along mesh axis ``axis``: the SPMD form of
    the JAX function, which shards a stacked operator's batch axis.  The
    batch length must be a multiple of the axis size (diag pads it)."""
    _, size, idx = axis_info(mesh, axis)
    n = len(items)
    if n % size:
        raise ValueError(f"shard_batched_stack: a batch of {n} does not "
                         f"split over {size} ranks")
    per = n // size
    return items[idx * per:(idx + 1) * per]


def gather_batched(local: list, mesh: Optional[DeviceMesh],
                   axis: str = "sector") -> list:
    """The shares of :func:`shard_batched_stack` (picklable per-member
    results) gathered from every rank of ``axis``, in batch order."""
    group, size, _ = axis_info(mesh, axis)
    if size == 1:
        return list(local)
    parts = [None] * size
    dist.all_gather_object(parts, list(local), group=group)
    return [r for part in parts for r in part]
