"""Chunked-prefill window forward of the port (``repro.serving.sched.
chunker``'s counterpart).

One engine step advances every mid-prefill slot by its planned chunk in
one batched (rows, S) decode window (``LM.decode_step`` with S > 1): the
window stores each row's S tokens' K/V at its own offset before any query
attends, and causality keeps a query off the positions after its own, so
a prompt prefilled S tokens at a time commits the K/V and logits that S
one-token steps would.

Window packing: row i of the window is slot i (``rows``: the engine's
slot count). Jobs are rectangularized to ``S = max(chunk)``; a shorter
row repeats its last real token. Padded positions write garbage into the
row's own slot or pages, at positions its next chunk (or its first decode
steps) overwrites before a real query reads them. ``plan_chunks`` caps S
so no job row writes past ``max_len``. A row without a job is a garbage
row, as a free slot is a garbage lane of the decode step: dense, it
starts at the slot's own write frontier (its next decode or chunk
position; 0 when free), so its S writes land at positions the slot
writes again before any query reads them, the ones past the cache's end
clamped to its last position; paged, it starts at 0 on an all-zero
block-table row, so it writes only the trash page 0. Either way the
window runs on the pool's caches in place.

Shapes: ``plan_chunks`` rounds S down to a power of two, so the only
shapes are (rows, 2^i) for 2^i <= min(step budget, max_len). On the card
``warmup`` captures one CUDA graph per shape at the engine's ``load()``,
over static buffers (start positions, tokens, the padded table) that
``advance`` ``copy_``s the host's window into before a replay; the graphs
share one memory pool. ``cuda_graph=False`` (and the
CPU) run the same windows eagerly. The forward runs under
``ops.serving_phase("chunk")``.

Each row's finite-logits guard, ``ok = isfinite(logits).all over (S, V)``
as in ``repro``, is computed inside the window (so a captured graph holds
it) and packed beside the greedy tokens into one (rows, S + 1) int32
output, read back with one copy; the engine quarantines a job row whose
``ok`` is false.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import graphs, ops

__all__ = ["ChunkRunner"]


class ChunkRunner:
    """The window forward over a dense ``SlotPool`` or a ``PagePool``, one
    row per slot (``rows``: the engine's slots)."""

    def __init__(self, model, max_len: int, paged: bool, rows: int):
        self.model = model
        self.max_len = max_len
        self.paged = paged
        self.rows = rows
        # static buffers: a captured window reads them, host pushes copy
        # into them
        self._pos = torch.zeros(rows, dtype=torch.int32, device=model.device)
        self._toks: Dict[int, torch.Tensor] = {}
        self._table: Optional[torch.Tensor] = None   # paged: (rows, T)
        self._graphs: Dict[int, graphs.CapturedStep] = {}
        # width -> ((rows, S + 1) int32: greedy tokens then the guard,
        # (rows, S, V) logits), the window's outputs
        self._out: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # the (rows, S, V) logits of the latest window: under the graphs,
        # a graph's own output, valid only until the next replay of any
        # graph of the pool (clone it to keep it)
        self.last_logits: Optional[torch.Tensor] = None
        # a tensor-parallel leader's hook: sender(pos=, toks=, table=)
        # hands each window's inputs to the follower ranks first
        self.sender = None

    # ------------------------------------------------------------------
    def _tokens(self, s: int) -> torch.Tensor:
        if s not in self._toks:
            self._toks[s] = torch.zeros((self.rows, s), dtype=torch.int32,
                                        device=self.model.device)
        return self._toks[s]

    @torch.no_grad()
    def _forward(self, params, pool, s: int) -> None:
        """The window of width ``s`` on the static buffers, writing the
        pool's caches in place; its greedy tokens with each row's guard,
        and its logits, land in ``_out[s]`` (under a graph, the graph's own
        output tensors)."""
        cache = {"layers": pool.layers, "pos": self._pos}
        if self.paged:
            cache["block_table"] = self._table
        logits, _ = self.model.decode_step(params, cache, self._tokens(s))
        ok = torch.isfinite(logits).flatten(1).all(dim=1)
        self._out[s] = (torch.cat([logits.argmax(dim=-1).to(torch.int32),
                                   ok[:, None].to(torch.int32)], dim=1),
                        logits)

    # ------------------------------------------------------------------
    def pack_window(self, jobs, frontier) -> Tuple[np.ndarray, np.ndarray]:
        """Rectangularize ``[(slot, req, c)]`` into the window, row = slot:
        (rows,) start positions and (rows, S) tokens with repeat-last
        padding. A row without a job gets token 0 at ``frontier[slot]``
        (dense: the slot's write frontier) or at 0 (paged: its table row
        is all zero)."""
        pos = (np.zeros(self.rows, np.int32) if self.paged
               else np.array(frontier, np.int32))
        s_max = max(c for _, _, c in jobs)
        toks = np.zeros((self.rows, s_max), np.int32)
        for slot, req, c in jobs:
            a = req.prefill_pos
            pos[slot] = a
            toks[slot, :c] = req.prompt[a:a + c]
            toks[slot, c:] = req.prompt[a + c - 1]
        return pos, toks

    def _pad_table(self, pool, slots) -> np.ndarray:
        """(rows, T) block table: the job slots' rows from the pool, every
        other row all zero (the trash page)."""
        table = np.zeros((self.rows, pool.table.shape[1]), np.int32)
        table[slots] = pool.table[slots]
        return table

    def _push(self, pos: np.ndarray, toks: np.ndarray,
              table: Optional[np.ndarray]) -> None:
        """Copy the window (and, paged, its (rows, T) block table) into the
        static buffers (blocking copies, so a host array is never read
        mid-copy)."""
        self._pos.copy_(torch.from_numpy(pos))
        self._tokens(toks.shape[1]).copy_(torch.from_numpy(toks))
        if self.paged:
            if self._table is None:
                self._table = torch.zeros(table.shape, dtype=torch.int32,
                                          device=self.model.device)
            self._table.copy_(torch.from_numpy(table))

    def _run(self, params, pool, s: int) -> None:
        with ops.serving_phase("chunk"):
            if self._graphs:
                if s not in self._graphs:
                    raise KeyError(f"no captured window of width {s}; "
                                   f"captured: {sorted(self._graphs)}")
                self._graphs[s].replay()
            else:
                self._forward(params, pool, s)

    def run_window(self, params, pool, pos: np.ndarray, toks: np.ndarray,
                   table: Optional[np.ndarray]) -> None:
        """A tensor-parallel follower's window: the leader's packed inputs
        pushed and run as ``advance`` runs them."""
        self._push(pos, toks, table)
        self._run(params, pool, toks.shape[1])

    def advance(self, params, pool, jobs, frontier,
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Run one window over ``pool`` (writing its caches in place) and
        return ``(greedy, ok)`` as host arrays aligned with ``jobs``:
        ``greedy[i, j]`` is the argmax after job i's token j (a completing
        row reads its first output token at its last real position);
        ``ok[i]`` is False when job i's row holds a non-finite logit.
        ``frontier``: every slot's next write position (``pack_window``)."""
        pos, toks = self.pack_window(jobs, frontier)
        slots = [slot for slot, _, _ in jobs]
        s = toks.shape[1]
        table = self._pad_table(pool, slots) if self.paged else None
        if self.sender is not None:
            self.sender(pos=pos, toks=toks, table=table)
        self._push(pos, toks, table)
        self._run(params, pool, s)
        out, self.last_logits = self._out[s]
        out = out.cpu().numpy()[slots]
        return out[:, :s], out[:, s].astype(bool)

    def warmup(self, params, pool, windows: Sequence[int], *,
               cuda_graph: bool = False, graph_pool=None) -> None:
        """Run every (rows, S) window of ``windows`` once ahead of traffic
        with garbage rows only, from position 0 (the pool holds no request:
        dense, the writes land in free slots, which a request's chunks
        write again before reading; paged, in the trash page); with
        ``cuda_graph`` capture each into a CUDA graph (widest first)
        sharing ``graph_pool``."""
        self._graphs = {}
        self._push(np.zeros(self.rows, np.int32),
                   np.zeros((self.rows, 1), np.int32),
                   self._pad_table(pool, []) if self.paged else None)
        for s in sorted(windows, reverse=True):
            self._tokens(s).zero_()
            step = functools.partial(self._forward, params, pool, s)
            with ops.serving_phase("chunk"):
                if cuda_graph:
                    self._graphs[s] = graphs.CapturedStep(
                        step, capture=functools.partial(
                            graphs.cuda_graph_capture, pool=graph_pool))
                else:
                    step()

    @property
    def captured(self) -> Tuple[int, ...]:
        """Widths with a captured graph."""
        return tuple(sorted(self._graphs))

    @property
    def launches_per_replay(self) -> Dict[int, Dict[str, int]]:
        return {s: g.launches_per_replay for s, g in self._graphs.items()}
