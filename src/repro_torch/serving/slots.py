"""Slot-allocated KV cache pool of the port: one fixed ``max_slots x
max_len`` cache (``LM.init_cache``) plus a host-side LIFO free list.
Admission scatters a freshly prefilled cache into the allocated rows;
eviction only returns the slot, whose stale rows the next insert
overwrites."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.paging.pages import tree_nbytes


class SlotPool:
    def __init__(self, model, max_slots: int, max_len: int,
                 cache_dtype=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.model = model
        self.max_slots = max_slots
        self.max_len = max_len
        self.layers = model.init_cache(max_slots, max_len,
                                       dtype=cache_dtype)["layers"]
        self._free: List[int] = list(range(max_slots))[::-1]
        self._live = np.zeros(max_slots, bool)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return self.max_slots - len(self._free)

    @property
    def nbytes(self) -> int:
        """Device bytes of the cache tensors."""
        return tree_nbytes(self.layers)

    @property
    def all_free(self) -> bool:
        return len(self._free) == self.max_slots and not self._live.any()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._live[slot] = True
        return slot

    def free(self, slot: int) -> None:
        if not (0 <= slot < self.max_slots and self._live[slot]):
            raise ValueError(f"slot {slot} is not live")
        self._live[slot] = False
        self._free.append(slot)

    def insert(self, slots, req_layers) -> None:
        """Scatter a prefilled cache (batch dim k) into rows ``slots``."""
        self.layers = self.model.insert_cache(self.layers, req_layers, slots)
