"""SLO-aware chunked-prefill scheduling of the port
(``repro.serving.sched``'s counterpart):

- ``config``: ``SLOClass`` (a request class's TTFT/TPOT objectives and
  priority) and ``SchedConfig`` (chunk size, step token budget, admission
  policy);
- ``slo``: ``SLOQueue`` (priority + earliest-TTFT-deadline admission with
  ``RequestQueue``'s replay, retry and gate contracts) and ``plan_chunks``,
  the per-step token budgeter;
- ``chunker``: ``ChunkRunner``, the (rows, S) window forward that advances
  every mid-prefill slot by its planned chunk in one call, over dense slot
  rows or paged block tables, replayed as one CUDA graph per window shape
  on the card.
"""
from repro_torch.serving.sched.chunker import ChunkRunner
from repro_torch.serving.sched.config import (DEFAULT_SLO_CLASSES,
                                              SchedConfig, SLOClass)
from repro_torch.serving.sched.slo import SLOQueue, plan_chunks

__all__ = [
    "ChunkRunner",
    "DEFAULT_SLO_CLASSES",
    "SLOClass",
    "SLOQueue",
    "SchedConfig",
    "plan_chunks",
]
