"""Cache rollback for rejected speculative tokens (``repro.spec.rollback``'s
counterpart).

The verify window writes K/V for all ``k+1`` positions before acceptance
is known; a round that accepts ``n_acc < k`` drafts leaves the rejected
tokens' K/V at ``pos + n_acc + 1 .. pos + k``. Rollback restores the
invariant that the committed cache is what sequential decode would hold:

* **dense slot pools** roll back by length bookkeeping alone: the
  engine's per-slot position is the only valid length, every attention
  mask derives from it, and the next window rewrites the rejected
  positions before any query can attend them. ``rollback_dense`` keeps
  the call site symmetric with the paged one.
* **paged pools** also own pages: the window may have grown the slot's
  block table into pages that now hold only garbage. ``rollback_paged``
  truncates the table to the committed length (``PagePool.truncate``);
  tail pages go back to the free list. Committed length >= prompt length,
  so registered prompt pages never drop, and the engine's growth horizon
  made every window page private before the speculative writes.
"""
from __future__ import annotations

__all__ = ["rollback_dense", "rollback_paged"]


def rollback_dense(pool, slot: int, n_tokens: int) -> int:
    """Pure bookkeeping: the engine's position already reflects
    ``n_tokens``; no page exists to reclaim. Returns 0."""
    del pool, slot, n_tokens
    return 0


def rollback_paged(pool, slot: int, n_tokens: int) -> int:
    """Truncate ``slot``'s block table to ``n_tokens`` committed tokens;
    returns the number of tail pages reclaimed."""
    return pool.truncate(slot, n_tokens)
