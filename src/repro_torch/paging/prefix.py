"""Hash-based shared-prefix page reuse — a verbatim copy of
``repro.paging.prefix`` (pure numpy and hashlib), kept in the port so it
imports nothing of ``repro``.

Pages are content-addressed by a *chained* hash (vLLM-style): page ``i``'s
key digests (parent key, the page's token ids, the token count), so a key
identifies both the tokens in the page and every token before it — two
prompts share page ``i`` iff they agree on all of positions ``[0, (i+1)·ps)``.
Because RoPE positions are absolute from 0 and prefill is deterministic,
equal token prefixes produce bitwise-equal K/V pages, so pointing a new
request's block table at a registered page is exact, not approximate.

Both *full* pages and the prompt's *partial tail* page are registered: the
tail key also covers the partial token count, so only a request with the
identical full prompt matches it. A matched tail is where copy-on-write
triggers — the first decode append into a registered (or multiply
referenced) page copies it to a private page first (``PagePool``).

The registry itself holds no reference counts; it pins pages (a page it
holds never returns to the free list directly) and the pool reclaims cold
registered pages coldest-first when it runs dry (``PagePool._reclaim_one``
over the pool's ``_reclaimable`` order). Hit/lookup counters feed the
engine's ``prefix`` metrics.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache", "page_keys"]


def page_keys(prompt: np.ndarray, page_size: int) -> List[bytes]:
    """Chained content keys for every page the prompt touches (the last one
    may be partial). Keys are order-, content- and length-sensitive."""
    toks = np.asarray(prompt, np.int32).reshape(-1)
    keys: List[bytes] = []
    parent = b"root"
    for lo in range(0, toks.size, page_size):
        chunk = toks[lo:lo + page_size]
        h = hashlib.sha1()
        h.update(parent)
        h.update(np.int64(chunk.size).tobytes())
        h.update(chunk.tobytes())
        parent = h.digest()
        keys.append(parent)
    return keys


class PrefixCache:
    """LRU map of chained page keys -> page ids, plus hit accounting."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._entries: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._key_of_page: Dict[int, bytes] = {}
        self.lookups = 0
        self.hits = 0

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------
    def lookup(self, prompt: np.ndarray) -> Tuple[List[bytes], List[int]]:
        """(all page keys for the prompt, page ids for the matched prefix).

        The match is the longest *leading* run of registered keys — prefix
        sharing stops at the first divergence. Counters update here."""
        keys = page_keys(prompt, self.page_size)
        matched: List[int] = []
        for key in keys:
            pid = self._entries.get(key)
            if pid is None:
                break
            self._entries.move_to_end(key)          # LRU touch
            matched.append(pid)
        self.lookups += len(keys)
        self.hits += len(matched)
        return keys, matched

    def probe(self, prompt: np.ndarray) -> int:
        """Number of leading prompt pages this cache holds — the router's
        placement signal (DESIGN.md §13). Unlike ``lookup`` it mutates
        nothing: no LRU touch, no hit/lookup counters — probing every
        replica to *place* a request must not skew the per-replica metrics
        or evict-ordering that the serving engine's real lookup drives."""
        matched = 0
        for key in page_keys(prompt, self.page_size):
            if key not in self._entries:
                break
            matched += 1
        return matched

    def register(self, key: bytes, page_id: int) -> None:
        """Pin ``page_id`` as the canonical holder of ``key``. The caller
        (PagePool) marks the page read-only; re-registering an existing key
        is a no-op (first writer wins — its content is identical anyway)."""
        if key in self._entries:
            return
        self._entries[key] = page_id
        self._key_of_page[page_id] = key

    def holds(self, page_id: int) -> bool:
        return page_id in self._key_of_page

    def unregister_page(self, page_id: int) -> None:
        key = self._key_of_page.pop(page_id, None)
        if key is not None:
            self._entries.pop(key, None)

    @property
    def hit_rate(self) -> Optional[float]:
        return self.hits / self.lookups if self.lookups else None
