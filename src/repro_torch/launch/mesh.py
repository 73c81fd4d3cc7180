"""Local mesh construction (the port's counterpart of
``repro.launch.mesh.make_local_mesh``).

A function, not a module-level constant, so importing this module touches
no device or process-group state. ``make_production_mesh`` (the 16 x 16
pod layout) comes with the analytic H100 cost model (ROADMAP A12c).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.tp import Mesh

__all__ = ["make_local_mesh"]


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
