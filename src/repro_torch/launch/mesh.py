"""Mesh construction (the port's counterpart of ``repro.launch.mesh``):
``make_local_mesh`` over the ranks of the running ``torch.distributed``
world, and ``make_production_mesh``, the 16 x 16 pod layout (2 x 16 x 16
across two pods) over placeholder ``"meta"`` devices, which the dry run
(``launch.dryrun``) traces one rank of.

Functions, not module-level constants, so importing this module touches
no device or process-group state.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.tp import Mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """``repro``'s production mesh: one pod is 16 x 16 = 256 ranks on
    ``("data", "model")``; two pods are 2 x 16 x 16 = 512 on ``("pod",
    "data", "model")``, the pod axis extending data parallelism. Every
    rank's device is ``"meta"``: the mesh places shapes, touches no
    process group and allocates nothing.

    On H100 nodes the ranks map row-major onto cards, ``model``
    innermost, 8 cards to a node: rank r is card r % 8 of node r // 8, so
    a model group of 16 spans two nodes and a data group one card of
    every second node (``launch.dryrun`` charges each group's collectives
    at NVLink's or InfiniBand's rate accordingly)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return Mesh(axes, shape, ("meta",) * n)


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over the ranks that exist: the ranks
    of the initialized ``torch.distributed`` world (one when none is), row
    major, rank r on ``cuda:r`` modulo the cards there are, or on the CPU
    without one. ``data * model`` must equal the number of ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != world:
        raise ValueError(f"mesh (data={data}, model={model}) needs "
                         f"{data * model} ranks, have {world}")
    cards = torch.cuda.device_count()
    devices = tuple(f"cuda:{r % cards}" if cards else "cpu"
                    for r in range(world))
    return Mesh(("data", "model"), (data, model), devices)
