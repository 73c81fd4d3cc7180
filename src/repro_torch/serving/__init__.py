"""Continuous-batching serving of the port over the dense slot pool."""
from repro_torch.serving.engine import ContinuousScheduler
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.slots import SlotPool

__all__ = ["ContinuousScheduler", "Request", "RequestQueue", "SlotPool"]
