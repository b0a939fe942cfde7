"""Process-group initialisation and the ("sector", "dw") mesh.

Port of the JAX package's ``parallel/distributed.py``.  Every rank runs
the same program (SPMD), one process per card under ``torchrun``:

    torchrun --nproc-per-node 4 my_driver.py

    from cdmft_lanc_ed_torch.parallel.distributed import init_distributed
    from cdmft_lanc_ed_torch.parallel import multichip
    mesh = init_distributed(n_sector=2)       # RANK, WORLD_SIZE, ... env
    multichip.set_solver_mesh(mesh)
    ... EDSolver(cfg).solve(...) on every rank ...

The backend is NCCL on the card and gloo on the CPU (or the caller's
``backend=``: gloo also moves CUDA tensors, staged through the host, which
lets two ranks share one card).  Unlike the JAX function, nothing is
swallowed: a failed initialisation raises.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

MESH_DIMS = ("sector", "dw")


def init_distributed(n_sector: int = 1, *, device=None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, store=None) -> DeviceMesh:
    """Initialise the default process group (unless it already is) and
    return the global ("sector", "dw") mesh of shape (n_sector,
    world // n_sector); ``n_sector`` is lowered until it divides the
    world size, as the JAX package lowers it.

    ``world_size``/``rank`` default to ``WORLD_SIZE``/``RANK`` of the
    environment (torchrun), ``init_method`` to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``); ``store`` (e.g. a ``FileStore``)
    replaces the rendezvous.  ``device=None`` is the card (raises without
    CUDA); on the card each rank takes ``LOCAL_RANK`` (else its rank)
    modulo the card count."""
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        if store is not None:
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world_size)
        else:
            dist.init_process_group(backend,
                                    init_method=init_method or "env://",
                                    rank=rank, world_size=world_size)
    n = dist.get_world_size()
    n_sector = max(1, min(int(n_sector), n))
    while n % n_sector:
        n_sector -= 1
    return init_device_mesh(device.type, (n_sector, n // n_sector),
                            mesh_dim_names=MESH_DIMS)
