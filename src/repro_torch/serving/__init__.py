"""Continuous-batching serving of the port: ``RequestQueue`` (FIFO
admission, per-request metrics) -> ``ContinuousScheduler`` (interleaved
prefill / decode / evict) -> ``SlotPool`` (dense slot rows) or the paged
pool (``repro_torch.paging.PagePool``).

Scheduling under SLOs: ``SchedConfig`` switches the engine to chunked
prefill under a per-step token budget, with ``SLOClass``-driven priority
and deadline admission (``SLOQueue``); ``TrafficConfig`` /
``make_schedule`` / ``run_open_loop`` drive the engine from a seeded
open-loop Poisson or bursty arrival schedule.

Fault tolerance: ``FaultConfig`` / ``FaultInjector`` (a seeded chaos
schedule) and ``ResilienceConfig`` (deadlines, retries, admission pauses);
the engine's finite guard quarantines a non-finite slot.
"""
from repro_torch.serving.engine import ContinuousScheduler
from repro_torch.serving.faults import (FaultConfig, FaultInjector,
                                        ResilienceConfig)
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.sched import SchedConfig, SLOClass, SLOQueue
from repro_torch.serving.slots import SlotPool
from repro_torch.serving.traffic import (Arrival, TrafficConfig,
                                         make_schedule, run_open_loop)

__all__ = ["ContinuousScheduler", "Request", "RequestQueue", "SlotPool",
           "FaultConfig", "FaultInjector", "ResilienceConfig",
           "SchedConfig", "SLOClass", "SLOQueue",
           "Arrival", "TrafficConfig", "make_schedule", "run_open_loop"]
