"""Optimizers and learning-rate schedules of the port (``repro.optim``)."""
from repro_torch.optim.optimizers import (adamw, clip_by_global_norm,
                                          global_norm, sgd_momentum)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["adamw", "sgd_momentum", "clip_by_global_norm", "global_norm",
           "warmup_cosine", "constant"]
