"""Page-granular KV cache pool of the port — the counterpart of
``repro.paging.pages``.

``PagePool`` replaces the dense ``serving.SlotPool`` rows with fixed-size
pages owned globally: each attention layer holds one ``(n_pages,
page_size, KV, hd)`` tensor pair (or ``Int8Pages`` containers) shared by
all slots, and each slot reads its own sequence through a host-side block
table that the engine pushes to the device when it changes. SSM layers
keep dense per-slot ``{"state", "conv"}`` rows inside the same layer list
(constant-size state gains nothing from pages): ``insert`` writes them by
slot, the copy on write skips them, ``nbytes`` counts them, and a
preempted request's replay rebuilds them with its prefill.

The host ownership model is ``repro``'s, call for call:

* a LIFO **free list** of page ids; page 0 is the reserved *trash page*:
  free slots' table rows are all zero, so the garbage K/V their decode
  lanes write lands there and is never read;
* **refcounts** count live-slot references; the prefix registry
  (``prefix.PrefixCache``) also *pins* the pages that hold registered
  prompt content. A page returns to the free list only at refcount 0 and
  unpinned; pinned refcount-0 pages are reclaimed coldest-first when the
  pool runs dry;
* **admission** (``admit``) is all-or-nothing: it finds every page the
  prompt needs (prefix hits, fresh pages, reclaimed pages) or returns
  ``None`` with every side effect rolled back, and the engine defers;
* **growth** (``ensure_append``) allocates the next page when a decode
  write crosses a page boundary and **copies on write** a page that
  another live slot shares; ``False`` means the pool is dry and the engine
  preempts.

On the device, ``insert`` (prefilled rows into the prompt's pages) and the
copy-on-write page copy are in-place index writes on the per-layer
tensors, where ``repro`` returns new arrays; the port's layer list has no
``n_groups`` axis.

**Rollback** (``truncate``, speculative decoding): a verify window grows a
slot's pages over all k+1 positions before acceptance is known; after the
commit the slot's table drops the pages past its committed length, which
go back to the free list at once.

Fault injection (``inject_alloc_failures``, armed by the engine's
``FaultInjector``): while ``fault_alloc_failures`` is positive, each page
allocation of at least one page fails as if the pool were dry and uses up
one armed failure, through ``admit`` (the engine defers) and
``ensure_append`` (the engine preempts) alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.paging.prefix import PrefixCache
from repro_torch.paging.quant import Int8Pages, quantize_rows

__all__ = ["PagePool", "Admission", "tree_nbytes"]


def tree_nbytes(tree) -> int:
    """Payload bytes of a cache tree: dicts and lists of tensors and
    ``Int8Pages``."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return int(tree.nbytes)


@dataclasses.dataclass
class Admission:
    """One admitted request's page plan."""

    slot: int
    page_ids: List[int]          # prompt pages, in sequence order
    n_shared: int                # leading pages satisfied by the prefix cache


class PagePool:
    """Global paged KV cache pool with prefix sharing and copy-on-write.
    The device is the model's (``LM(cfg)`` defaults to the card)."""

    def __init__(self, model, max_slots: int, max_len: int, *,
                 page_size: int = 16, n_pages: int = 0,
                 kv_dtype: Optional[str] = None, prefix_cache: bool = True):
        if max_slots < 1 or page_size < 1:
            raise ValueError(f"max_slots ({max_slots}) and page_size "
                             f"({page_size}) must be >= 1")
        cfg = model.cfg
        if cfg.cache_layout == "opt":
            raise ValueError("paged caches need cache_layout='bshd' "
                             "(the 'opt' delta-decode layout is dense-only)")
        if cfg.sliding_window:
            raise ValueError("paged caches do not support rolling "
                             "sliding-window models yet; use cache='dense'")
        self.model = model
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = -(-max_len // page_size)
        # +1: page 0 is the reserved trash page
        self.n_pages = n_pages or max_slots * self.pages_per_slot + 1
        if self.n_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"n_pages={self.n_pages} cannot hold even one max-length "
                f"request ({self.pages_per_slot} pages + trash page)")
        self.kv_dtype = kv_dtype
        self.layers = model.init_paged_cache(
            self.n_pages, page_size, max_slots, kv_dtype=kv_dtype)["layers"]

        # ---- host ownership state ----
        self._free_slots: List[int] = list(range(max_slots))[::-1]
        self._slot_live = np.zeros(max_slots, bool)
        self._free_pages: List[int] = list(range(1, self.n_pages))[::-1]
        self._refcount = np.zeros(self.n_pages, np.int32)
        # registered pages with no live references, in the order they went
        # cold: the O(1) reclaim pool
        self._reclaimable: Dict[int, None] = {}
        self.slot_pages: Dict[int, List[int]] = {s: [] for s in range(max_slots)}
        self.table = np.zeros((max_slots, self.pages_per_slot), np.int32)
        self.table_dirty = True
        self.prefix = PrefixCache(page_size) if prefix_cache else None

        # ---- stats ----
        self.cow_count = 0
        self.pages_used_peak = 0
        # armed injected allocation failures (see the module docstring)
        self.fault_alloc_failures = 0

    # ------------------------------------------------------------------
    # Geometry / accounting
    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:            # slots (SlotPool-compatible name)
        return len(self._free_slots)

    @property
    def n_live(self) -> int:
        return self.max_slots - len(self._free_slots)

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def pages_used(self) -> int:
        """Pages not on the free list (live refs + pinned prefix pages)."""
        return self.usable_pages - len(self._free_pages)

    @property
    def n_free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def all_reclaimed(self) -> bool:
        """Drain invariant: every slot free and every live reference
        dropped (pinned-but-cold prefix pages hold refcount 0 and are
        reclaimable on demand, so they are not leaks)."""
        return (len(self._free_slots) == self.max_slots
                and not self._slot_live.any()
                and int(self._refcount.sum()) == 0)

    @property
    def nbytes(self) -> int:
        """Device bytes of the page tensors, the SSM slot rows and the
        block table."""
        return tree_nbytes(self.layers) + int(self.table.nbytes)

    def pages_needed(self, prompt_len: int) -> int:
        return -(-prompt_len // self.page_size)

    def _note_usage(self) -> None:
        self.pages_used_peak = max(self.pages_used_peak, self.pages_used)

    def _shared(self, pid: int) -> bool:
        """Copy-on-write trigger: more than one live slot references the
        page. A registered page with a single live referent appends in
        place: appends only touch rows at or after the registrant's prompt
        tail, which later prefix matchers mask until their own first
        append (when refcount > 1 forces them to copy)."""
        return self._refcount[pid] > 1

    # ------------------------------------------------------------------
    # Page allocation / reclamation
    # ------------------------------------------------------------------
    def _reclaim_one(self) -> Optional[int]:
        """Unpin and take the coldest registered page with no live
        references. None when nothing is reclaimable."""
        if self.prefix is None or not self._reclaimable:
            return None
        pid = next(iter(self._reclaimable))
        del self._reclaimable[pid]
        if self._refcount[pid] != 0:
            raise AssertionError(f"reclaimable page {pid} is referenced")
        self.prefix.unregister_page(pid)
        return pid

    def inject_alloc_failures(self, n: int) -> None:
        """Arm ``n`` forced allocation failures (chaos testing, from
        ``serving.faults.FaultInjector``)."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        self.fault_alloc_failures += n

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        if n > 0 and self.fault_alloc_failures > 0:     # injected OOM
            self.fault_alloc_failures -= 1
            return None
        out: List[int] = []
        while len(out) < n:
            if self._free_pages:
                out.append(self._free_pages.pop())
            else:
                pid = self._reclaim_one()
                if pid is None:
                    self._free_pages.extend(reversed(out))  # rollback
                    return None
                out.append(pid)
        return out

    def _unref(self, pid: int) -> None:
        if self._refcount[pid] <= 0:
            raise AssertionError(f"page {pid} is not referenced")
        self._refcount[pid] -= 1
        if self._refcount[pid] == 0:
            if self.prefix is not None and self.prefix.holds(pid):
                self._reclaimable[pid] = None      # cold prefix page
            else:
                self._free_pages.append(pid)

    def _check_live(self, slot: int) -> None:
        if not (0 <= slot < self.max_slots and self._slot_live[slot]):
            raise ValueError(f"slot {slot} is not live")

    # ------------------------------------------------------------------
    # Admission / growth / release
    # ------------------------------------------------------------------
    def admit(self, prompt: np.ndarray, *,
              use_prefix: bool = True) -> Optional[Admission]:
        """Reserve a slot and every page the prompt needs, reusing
        registered prefix pages. All-or-nothing: on failure every side
        effect is rolled back and ``None`` is returned (the engine
        defers).

        ``use_prefix=False`` skips prefix matching and registration for
        this admission. Chunked prefill needs it: a registered page must
        already hold its prompt content, but a chunked request writes its
        pages over several steps, so registering them at admission would
        let a whole-prompt admission share a page not yet written. Chunked
        requests take private pages only."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n_p = self.pages_needed(prompt.size)
        if n_p > self.pages_per_slot:
            raise ValueError(f"a {prompt.size}-token prompt needs {n_p} "
                             f"pages; a slot holds {self.pages_per_slot}")
        if not self._free_slots:
            return None
        prefix = self.prefix if use_prefix else None
        matched: List[int] = []
        keys: List[bytes] = []
        if prefix is not None:
            keys, matched = prefix.lookup(prompt)
            for pid in matched:          # pin before reclamation can run
                self._refcount[pid] += 1
                self._reclaimable.pop(pid, None)
        fresh = self._alloc_pages(n_p - len(matched))
        if fresh is None:
            for pid in matched:          # rollback
                self._unref(pid)
            return None
        for pid in fresh:
            self._refcount[pid] = 1
        if prefix is not None:
            for key, pid in zip(keys[len(matched):], fresh):
                prefix.register(key, pid)
        slot = self._free_slots.pop()
        self._slot_live[slot] = True
        pids = matched + fresh
        self.slot_pages[slot] = pids
        self.table[slot] = 0
        self.table[slot, :n_p] = pids
        self.table_dirty = True
        self._note_usage()
        return Admission(slot=slot, page_ids=pids, n_shared=len(matched))

    def ensure_append(self, slot: int, pos: int) -> bool:
        """Make position ``pos`` of ``slot`` writable before a decode step:
        allocate the next page when ``pos`` crosses a page boundary, and
        copy on write when the target page is shared. ``False`` = pool dry
        (the caller preempts and retries)."""
        self._check_live(slot)
        pi = pos // self.page_size
        pages = self.slot_pages[slot]
        if pi < len(pages):
            pid = pages[pi]
            if not self._shared(pid):
                return True
            new = self._alloc_pages(1)
            if new is None:
                return False
            new = new[0]
            self._copy_page(pid, new)
            self._unref(pid)
            self._refcount[new] = 1
            pages[pi] = new
            self.table[slot, pi] = new
            self.table_dirty = True
            self.cow_count += 1
            self._note_usage()
            return True
        if pi != len(pages) or pi >= self.pages_per_slot:
            raise ValueError(f"slot {slot} cannot append at position {pos} "
                             f"with {len(pages)} pages")
        new = self._alloc_pages(1)
        if new is None:
            return False
        new = new[0]
        self._refcount[new] = 1
        pages.append(new)
        self.table[slot, pi] = new
        self.table_dirty = True
        self._note_usage()
        return True

    def release(self, slot: int) -> None:
        """Return a slot and its page references; registered prefix pages
        stay resident (pinned) for later shared-prefix admissions. The
        slot's table row goes back to all-zero (the trash page)."""
        self._check_live(slot)
        for pid in self.slot_pages[slot]:
            self._unref(pid)
        self.slot_pages[slot] = []
        self.table[slot] = 0
        self.table_dirty = True
        self._slot_live[slot] = False
        self._free_slots.append(slot)

    def truncate(self, slot: int, n_tokens: int) -> int:
        """Speculative-decoding rollback: drop the slot's page references
        past what ``n_tokens`` committed tokens need and return how many
        pages went back to the pool, O(dropped).

        Only decode-grown tail pages can drop: ``n_tokens`` is never below
        the prompt length, so registered prompt pages stay in range, and a
        dropped page is fresh or the private side of a copy on write
        (refcount 1, unregistered), so ``_unref`` frees it at once. Shared
        pages' refcounts are untouched."""
        self._check_live(slot)
        keep = max(self.pages_needed(n_tokens), 1)
        pages = self.slot_pages[slot]
        if keep >= len(pages):
            return 0
        dropped = pages[keep:]
        del pages[keep:]
        for pid in dropped:
            self._unref(pid)
        self.table[slot, keep:keep + len(dropped)] = 0
        self.table_dirty = True
        return len(dropped)

    # ------------------------------------------------------------------
    # Device writes: prefilled rows -> pages, copy-on-write
    # ------------------------------------------------------------------
    def _copy_page(self, src: int, dst: int) -> None:
        for entry in self.layers:
            if "k_pages" not in entry:       # an SSM layer's slot rows
                continue
            for pages in (entry["k_pages"], entry["v_pages"]):
                if isinstance(pages, Int8Pages):
                    pages.codes[dst] = pages.codes[src]
                    pages.scales[dst] = pages.scales[src]
                else:
                    pages[dst] = pages[src]

    def insert(self, admissions: List[Admission], req_layers) -> None:
        """Write a freshly prefilled batch (batch dim k, sequence padded to
        a page multiple) into each request's pages. Prefix-matched pages
        already hold this content and live sharers may be reading them, so
        their chunks go to the trash page instead, never over them. int8
        pages quantize the rows here. SSM layers' state and conv rows go
        to the admitted slots' rows whole."""
        flat = [0 if i < adm.n_shared else pid
                for adm in admissions
                for i, pid in enumerate(adm.page_ids)]
        slots = [adm.slot for adm in admissions]
        ps = self.page_size
        for entry, src in zip(self.layers, req_layers):
            if "k_pages" not in entry:       # SSM state/conv: slot rows
                self.model.insert_cache([entry], [src], slots)
                continue
            idx = torch.tensor(flat, dtype=torch.long,
                               device=src["k"].device)
            for pk, sk in (("k_pages", "k"), ("v_pages", "v")):
                pages, seq = entry[pk], src[sk]
                kv, hd = seq.shape[-2:]
                chunks = seq.reshape(-1, ps, kv, hd)
                if isinstance(pages, Int8Pages):
                    codes, scales = quantize_rows(chunks)
                    pages.codes[idx] = codes
                    pages.scales[idx] = scales
                else:
                    pages[idx] = chunks.to(pages.dtype)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        prefix = None
        if self.prefix is not None:
            hr = self.prefix.hit_rate
            prefix = {"lookups": self.prefix.lookups,
                      "hits": self.prefix.hits,
                      "hit_rate": round(hr, 4) if hr is not None else None,
                      "registered_pages": len(self.prefix)}
        return {
            "page_size": self.page_size,
            "pages_total": self.usable_pages,
            "pages_used": self.pages_used,
            "pages_used_peak": self.pages_used_peak,
            "occupancy_peak": round(
                self.pages_used_peak / max(self.usable_pages, 1), 4),
            "kv_dtype": self.kv_dtype or "cache_dtype",
            "cow_copies": self.cow_count,
            "prefix": prefix,
        }
