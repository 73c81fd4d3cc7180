"""Continuous-batching scheduler of the port over the dense slot pool or the
paged KV pool — the counterpart of ``repro.serving.engine.
ContinuousScheduler``, on one device or tensor-parallel over a mesh.

Each step: **admit** FIFO runs of equal-length prompts into free slots as
one prefill (the last-position argmax is each request's first token);
**grow** (paged mode) every live row's pages for this step's write,
preempting the youngest request when the pool is dry; **decode** one token
for all ``max_slots`` rows with a per-slot position vector (free slots
decode garbage at a position clamped to ``max_len - 1``, into rows the
next insert overwrites, or into the paged pool's trash page); **evict**
requests at their budget or EOS. Prefill runs under
``ops.serving_phase("prefill")``, decode under ``"decode"``, which picks
the kernels' tile shapes.

The decode step is device-resident, as ``repro``'s jitted decode with the
cache donated is: positions, tokens and (paged) the block table are static
device buffers that the step reads and updates in place, the greedy argmax
runs inside it, and the host reads only the (max_slots,) next tokens each
step. Host mirrors are copied into the buffers only after admit, evict or
a page change. On the card ``load()`` captures the step into a CUDA graph
(one per engine: its shape is fixed by ``max_slots``, as ``repro``'s decode
compiles once) and each step replays it; on the CPU the same step runs
eagerly. Prefill stays eager: its shape changes with every admission
group.

Chunked prefill and SLO admission (``sched=SchedConfig(...)``, as
``repro``'s): ``admission="slo"`` orders the queue by (priority, TTFT
deadline, submit order) through ``sched.SLOQueue``. With
``chunk_tokens > 0`` a request is admitted the moment a slot (and, paged,
its prompt's private pages) is free; its prompt then streams into the
cache ``chunk_tokens`` at a time, each step's chunks packed into one
(slots, S) window (``sched.ChunkRunner``) under the step's token budget
(``sched.plan_chunks``: the decode batch is charged first). A request
whose prompt completes takes its first token from the window and joins
the decode batch in the same step. Mid-prefill slots ride the decode step
as garbage lanes at ``pos = prefill_pos``: what they write there the next
chunk overwrites before any query reads it. Likewise a slot without a
chunk rides the window as a garbage row at its own write frontier (dense)
or on the trash page (paged). On the card every window shape (slots,
2^i) is captured as a CUDA graph at ``load()``, beside the decode step,
all in one memory pool. With ``chunk_tokens=0`` the engine
prefills whole prompts in SLO order.

Speculative decoding (``spec=SpecConfig(...)``, ``repro_torch.spec``, as
``repro``'s): each step's one-token decode becomes a round. The draft
(a prefix of the layers, the weights re-packed sparser, or an external
model) proposes k tokens a slot from its own dense cache (one re-sync
feed, then k greedy feeds, under the ``"decode"`` phase) straight into
the verify window's static buffer; the target runs the (slots, k+1)
window in one forward under ``"verify"`` and computes greedy tokens,
accepted counts and the guard on the device, read with one copy. The
host commits each slot's accepted drafts and the bonus token (stopping at
the budget or EOS), rolls the rejected tail back (dense: the position
alone; paged: ``PagePool.truncate``) and quarantines a slot whose window
is not finite. Paged growth covers the whole window (``_grow_paged(1 +
k)``); ``submit`` reserves k positions of headroom. On the card
``load()`` captures the draft round and the verify window as one CUDA
graph each, in the decode step's memory pool, and a round replays both
back to back. The draft's own cache is dense in both cache modes; whole-
prompt admission and a completed chunked prefill prefill it (eagerly).

Fault tolerance (``repro``'s model; ``serving.faults``): the decode step,
every chunk window and the verify window compute a per-row guard, ``ok =
all(isfinite(logits))``, inside the step (and so inside the captured
graphs). A live slot whose row is not finite is *quarantined*: its
uncommitted tokens are dropped, its slot and pages are released, and the
request replays from its prompt (greedy decode makes the retry
token-exact), up to its retry budget, after which it ends ``failed`` with
reason ``"nan_logits"``. Requests past their deadline are cancelled
wherever they are. A ``FaultConfig`` arms the seeded injector: NaN logits
in one live slot (through a static mask the decode step and the verify
window read, all false but in the step a fault fires), armed
page-allocation failures, slow steps, failed draft rounds (that step runs
one plain graphed decode step instead and counts a ``draft_fallback``).
The degradation ladder disables speculation for good once the mean
acceptance over the last ``spec_floor_window`` rounds falls below
``ResilienceConfig.spec_accept_floor``, and pauses admission while the
paged pool's free fraction is below ``admission_pause_frac``. The
``faults`` block of the metrics reports all of it, the ``spec`` block the
rounds, proposals, acceptances and rollbacks.

Caches and plans (``repro``'s): the dense cache takes every layout
``init_kv_cache`` makes (``bshd``, ``flat``, ``opt``) and rolling
sliding-window caches, all inside the captured decode step (the rolling
slot ``pos % cache_len`` and the ``opt`` commit are device ops);
speculative decoding, chunked prefill and the paged pool refuse the
``opt`` layout and sliding windows with ``repro``'s messages.
``paged_attn`` names the paged cache's decode-attention row (None:
``cfg.paged_attn_impl``). ``load()`` fills ``gemm_plans`` and, on the card
with the fused MLP on, ``fused_plans`` for every M the engine dispatches
(``ops.precompute_plans`` / ``precompute_fused_plans``), each tile resolved
through the block-shape tuner there, so no step tunes.

Model families (``repro``'s): every decoder family ``LM`` builds, dense
and MoE attention stacks, SSM and hybrid ones. SSM layers keep per-slot
state and conv rows in both cache modes: the prefill's insert writes a
slot's rows whole, the decode step updates them in place (so the captured
graph reads them as static buffers), and a free slot's garbage lane
advances only its own rows, which the next insert overwrites.
Speculative decoding and chunked prefill refuse stacks with SSM layers,
and the engine refuses encoder-decoder and VLM configs, with ``repro``'s
messages. Plans cover packed linears only: MoE banks are decoded into
the compute dtype every call, as ``repro``'s are.

Tensor parallelism (``mesh=``, a ``distributed.tp.Mesh`` with a
``"model"`` axis of tp ranks; every decoder family). This engine is the
leader, rank 0: at ``load()`` it spawns ranks 1..tp-1 as follower
processes (``tp.start_followers``), each an engine of the same
configuration on its own device that keeps its own shards of the params
(``tp.shard_params``: q/k/v, up, gate and the lm head column split, o and
down row split with an f32 all-reduce; an SSM mixer by its heads, a MoE
layer by its experts or their d_ff; the rest whole) and a cache pool of
its local KV heads and SSM rows (``tp.local_config`` of its rank: where tp
does not divide the query heads, ranks hold unequal head counts, and
their steps, caches and decode graphs differ in shape while the leader's
schedule and page accounting count tokens alone). ``rank_routes``
returns every rank's MoE capacity picks of one forward (they must be
equal: routing runs on the replicated activations). The leader alone schedules, pages, handles faults,
runs the speculative draft (whole, on its own card) and reads tokens.
Before each device step it broadcasts the step's op (prefill, insert,
decode, chunk window, verify) with what it copied into its static
buffers since the last one (``_push_host_state``'s positions, tokens and
block table, the page copies of copy-on-write, the NaN victim, the draft's
verify window); a follower copies them into its own buffers and runs the
same step function on its shards, meeting the leader in the step's
collectives. The logits are all-gathered, so every rank computes the same
greedy tokens and finite guard. A step that holds a collective is
captured as a CUDA graph only over NCCL (each rank on its own card);
over gloo (ranks sharing one card) ``cuda_graph=True`` raises. The
metrics' ``mesh`` block is ``repro``'s. ``close()`` stops the followers.

Counters (``_ENGINE_COUNTERS``: steps, preemptions, deferrals, chunk,
spec and fault counts) live in a ``MetricsRegistry`` (``engine.metrics``)
behind attributes of those names, beside the step-time EWMA
(``step_time_s``) and ``straggler_steps``. With a ``tracer``
(``obs.trace.Tracer``) the engine records each request's life on its own
track and its prefill, chunk-window, decode-step, draft and verify spans
(and ``draft_fallback`` / ``spec_disabled`` instants) and per-step
counters on the scheduler track, as ``repro``'s does; the prefill,
chunk-window, decode-step and verify spans carry the warmed plans'
modelled roofline aggregate (``gemms``, ``modeled_flops``,
``modeled_bytes``, ``model_time_s``, ``m_bucket``), which
``scripts/trace_report.py`` sets beside the measured time. ``tracer=None``
costs one attribute test per site.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import tp as tp_lib
from repro_torch.kernels import graphs, ops
from repro_torch.models import LM, moe
from repro_torch.models.transformer import param_specs
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.metrics import MetricsRegistry, RunningStat, percentiles
from repro_torch.paging import PagePool
from repro_torch.serving.faults import (FAIL_DEADLINE, FAIL_NUMERIC,
                                        FaultConfig, FaultInjector,
                                        ResilienceConfig)
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.sched import ChunkRunner, SchedConfig, SLOQueue
from repro_torch.serving.sched.slo import plan_chunks
from repro_torch.serving.slots import SlotPool
from repro_torch.spec import (build_draft, make_draft_round,
                              make_verify_step, rollback_dense,
                              rollback_paged)

log = logging.getLogger("repro_torch.serving")

# a step this many times slower than the step-time EWMA is a straggler
# (repro's factor: serving steps vary legitimately, prefill against decode)
_STRAGGLER_FACTOR = 8.0


class ContinuousScheduler:
    """The scheduler of the module docstring. ``sched``: a
    ``SchedConfig``, or None for FIFO whole-prompt admission. ``spec``: a
    ``spec.SpecConfig``, or None for one-token decode. ``faults``:
    a ``FaultConfig`` arming the injector, or None. ``resilience``: the
    ``ResilienceConfig`` (default: no deadline, 2 retries). ``tracer``:
    an ``obs.trace.Tracer``, or None for none. ``paged_attn``: the paged
    decode-attention row for this engine (None inherits
    ``cfg.paged_attn_impl``; dense engines ignore it).
    ``cuda_graph=False`` runs the decode step, the chunk windows, the
    draft round and the verify window eagerly on the card: it exists
    for the same-process A/B against the graphs and for tensor-parallel
    ranks that share one card over gloo; no CLI flag sets it. On the CPU
    both always run eagerly. ``mesh``: a ``distributed.tp.Mesh`` (module
    docstring), None for one device; with one, ``device`` defaults to the
    mesh's first. ``tp_rank``: this engine's rank in the mesh (0, the
    leader, unless a follower builds it: its model holds its own query
    heads, which differ from the leader's where tp does not divide
    them)."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int,
                 eos_id: Optional[int] = None, *, cache: str = "dense",
                 page_size: int = 16, n_pages: int = 0,
                 kv_dtype: Optional[str] = None, prefix_cache: bool = True,
                 paged_attn: Optional[str] = None,
                 sched: Optional[SchedConfig] = None, spec=None,
                 faults: Optional[FaultConfig] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 device=None, tracer=None, cuda_graph: bool = True,
                 mesh=None, tp_rank: int = 0):
        # what a follower rank needs to build the same engine
        self._init_kwargs = dict(
            cfg=cfg, max_slots=max_slots, max_len=max_len, eos_id=eos_id,
            cache=cache, page_size=page_size, n_pages=n_pages,
            kv_dtype=kv_dtype, prefix_cache=prefix_cache,
            paged_attn=paged_attn, sched=sched, spec=spec,
            cuda_graph=cuda_graph)
        if device is None:
            device = mesh.devices[0] if mesh is not None else "cuda"
        tp = 1 if mesh is None else tp_lib.mesh_axis_sizes(mesh).get(
            "model", 1)
        if tp > 1 and mesh.backend == "gloo" and cuda_graph \
                and resolve_device(device).type == "cuda":
            raise ValueError(
                "a tensor-parallel step over gloo (ranks sharing a card) "
                "cannot be captured as a CUDA graph: pass cuda_graph=False "
                "(graph capture of a collective needs NCCL, one card a rank)")
        if cfg.is_encdec or cfg.family == "vlm":
            raise ValueError(
                f"family {cfg.family!r} needs per-request encoder/frontend "
                "state; use the static BatchedServer for it")
        if cache not in ("dense", "paged"):
            raise ValueError(f"cache must be 'dense' or 'paged', got "
                             f"{cache!r}")
        # paged_attn=None inherits cfg.paged_attn_impl; an explicit value
        # overrides it for this engine only (read when the step is traced
        # or captured, so it is fixed before load())
        if cache == "paged" and paged_attn is not None \
                and paged_attn != cfg.paged_attn_impl:
            cfg = dataclasses.replace(cfg, paged_attn_impl=paged_attn)
        if spec is not None:
            _check_spec(cfg, spec, max_len)
        if sched is not None and sched.chunked:
            _check_chunked(cfg)
        self.spec = spec
        self.cfg = cfg
        self.cache_mode = cache
        self.device = resolve_device(device)
        self.metrics = MetricsRegistry()
        self._step_time = self.metrics.ewma("step_time_s", alpha=0.3)
        self.tracer = tracer
        self._trace_pid = tracer.new_pid("engine") if tracer is not None else 0
        if tracer is not None:
            tracer.thread_name(self._trace_pid, 0, "scheduler")
        # tensor parallelism: this rank's model has its local heads; the
        # group, the followers and the outbox of buffer pushes and page
        # copies come up at load()
        self.mesh = mesh
        self.tp = tp
        self._group: Optional[tp_lib.Group] = None
        self._tp_rank = tp_rank
        self._followers: List[Any] = []
        self._tp_dir: Optional[str] = None
        self._outbox: List[tuple] = []
        self._full_params = None
        self.model = LM(tp_lib.local_config(cfg, tp, tp_rank), self.device)
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.params = None
        self.sched = sched
        chunked = sched is not None and sched.chunked
        self.queue = (SLOQueue() if sched is not None
                      and sched.admission == "slo" else RequestQueue())
        if cache == "paged":
            self.pool = PagePool(self.model, max_slots, max_len,
                                 page_size=page_size, n_pages=n_pages,
                                 kv_dtype=kv_dtype,
                                 prefix_cache=prefix_cache)
            if tp > 1:
                # copy-on-write copies reach the followers' pools too
                copy_page = self.pool._copy_page

                def _copy_page(src: int, dst: int) -> None:
                    self._outbox.append(("copy", (src, dst)))
                    copy_page(src, dst)

                self.pool._copy_page = _copy_page
            self._dev_table = torch.zeros(self.pool.table.shape,
                                          dtype=torch.int32,
                                          device=self.device)
        else:
            self.pool = SlotPool(self.model, max_slots, max_len)
        self._chunker = (ChunkRunner(self.model, max_len,
                                     paged=cache == "paged", rows=max_slots)
                         if chunked else None)
        if self._chunker is not None and tp > 1:
            self._chunker.sender = functools.partial(self._tp_send, "chunk")
        self._prefills: Dict[int, Request] = {}      # slot -> mid-prefill
        self._chunk_meta = None       # the last plan_chunks meta, traced
        self._live: Dict[int, Request] = {}          # slot -> request
        self._pos = np.zeros(max_slots, np.int32)    # host mirrors
        self._tok = np.zeros(max_slots, np.int32)
        # static device buffers: the decode step updates them in place and
        # host pushes copy into them, so a captured graph's pointers hold.
        # _dev_out holds the step's outputs, read with one copy: row 0 the
        # next tokens (_dev_tok, also the step's input), row 1 the guard
        # (_dev_ok). _dev_nan is the injected-NaN mask, all false but in a
        # step where a NaN fault fires.
        self._dev_pos = torch.zeros(max_slots, dtype=torch.int32,
                                    device=self.device)
        self._dev_out = torch.zeros((2, max_slots), dtype=torch.int32,
                                    device=self.device)
        self._dev_tok = self._dev_out[0]
        self._dev_ok = self._dev_out[1]
        self._dev_nan = torch.zeros(max_slots, dtype=torch.bool,
                                    device=self.device)
        # speculative decoding: the second-newest committed token a slot
        # (the draft round's re-sync feed) and the (slots, k+1) verify
        # window the draft round writes
        self._prev_tok = np.zeros(max_slots, np.int32)
        self._dev_prev = torch.zeros(max_slots, dtype=torch.int32,
                                     device=self.device)
        self._dev_win = (torch.zeros((max_slots, spec.k + 1),
                                     dtype=torch.int32, device=self.device)
                         if spec is not None else None)
        self._spec_out: Optional[torch.Tensor] = None
        self._draft_graph: Optional[graphs.CapturedStep] = None
        self._verify_graph: Optional[graphs.CapturedStep] = None
        self.draft = None
        self._draft_layers = None
        self._dirty = True
        self.cuda_graph = cuda_graph
        self._graph: Optional[graphs.CapturedStep] = None
        # the logits of the latest decode step (max_slots, V) or verify
        # window (max_slots, k+1, V); under a graph, the graph's own output
        # tensor, valid only until the next replay of any graph of the
        # engine (clone it to keep it). _step_logits / _verify_logits: the
        # output of the last call (or capture) of each step
        self.last_logits: Optional[torch.Tensor] = None
        self._step_logits: Optional[torch.Tensor] = None
        self._verify_logits: Optional[torch.Tensor] = None
        self._finished: List[Request] = []
        # the plans load() warms, keyed as repro's: (leaf, m, phase) and,
        # for the draft's, ("draft", leaf, m, phase)
        self.gemm_plans: Dict[tuple, ops.GemmPlan] = {}
        self._phase_model: Dict[tuple, Dict[str, float]] = {}
        self._modeled_memo: Dict[tuple, Optional[Dict[str, float]]] = {}
        self.fused_plans: Dict[tuple, ops.FusedMlpPlan] = {}
        self._depth_stat = RunningStat("queue_depth")
        self._live_stat = RunningStat("live_slots")
        # fault tolerance
        self.resilience = resilience or ResilienceConfig()
        self.injector = FaultInjector(faults) if faults is not None else None
        self._step_no = 0            # 1-based, every step() call counted
        # requests submitted to this engine: the drain check's count.
        # (SLOQueue.requeue raises queue.submitted to keep its seq stamps
        # fresh, as repro's does, so that count is not the submissions.)
        self.submitted = 0
        self._any_deadline = self.resilience.deadline_s is not None
        # the degradation ladder's rolling acceptance, one entry a round
        self.spec_disabled = False
        self._accept_ring = collections.deque(
            maxlen=max(self.resilience.spec_floor_window, 1))

    # ------------------------------------------------------------------
    def load(self, params) -> None:
        """Install params (already on this engine's device; they must
        outlive the engine, whose graphs read them in place). On the card,
        capture the decode step into a CUDA graph, after eager warm-up
        steps on the free slots: their writes land where free slots'
        garbage always lands (rows the next insert overwrites, or the paged
        pool's trash page). With ``spec``, build the draft and its dense
        cache and capture the draft round and the verify window the same
        way (their warm-ups write free slots' draft rows, free slots' rows
        of the pool or the trash page). Chunked, then run every window
        shape (slots, 2^i), 2^i <= min(step budget, max_len), once with
        garbage rows only, capturing each on the card. All graphs share
        one memory pool (``ChunkRunner.warmup``). A failed capture
        raises."""
        if self._live or self._prefills:
            raise RuntimeError("load() while requests are live")
        if self.tp > 1:
            params = self._load_shards(params)
        self.params = params
        self._graph = self._draft_graph = self._verify_graph = None
        self._plan(params)
        if self.spec is not None and self._tp_rank > 0:
            # a follower verifies; the leader alone drafts
            self._verify = make_verify_step(self.model, self.max_len,
                                            self.spec.k)
        elif self.spec is not None:
            # under tensor parallelism the draft is whole, on the leader
            # (repro replicates it): built from the unsharded params
            full = self._full_params if self.tp > 1 else params
            self.draft = build_draft(self.spec, LM(self.cfg, self.device)
                                     if self.tp > 1 else self.model, full)
            self._draft_layers = self.draft.model.init_cache(
                self.max_slots, self.max_len)["layers"]
            self._draft_round = make_draft_round(self.draft, self.max_len,
                                                 self.spec.k)
            self._verify = make_verify_step(self.model, self.max_len,
                                            self.spec.k)
            # the draft's own packed decodes plan under "decode" too
            self.gemm_plans.update(
                (("draft",) + key, plan) for key, plan in
                ops.precompute_plans(self.draft.params,
                                     decode_ms=(self.max_slots,),
                                     select=_is_packed_linear).items())
        graphed = self.device.type == "cuda" and self.cuda_graph
        mempool = torch.cuda.graph_pool_handle() if graphed else None
        if graphed:
            self._dirty = True
            self._push_host_state()
            capture = functools.partial(graphs.cuda_graph_capture,
                                        pool=mempool)
            with ops.serving_phase("decode"):
                self._graph = graphs.CapturedStep(self._decode_step,
                                                  capture=capture)
                if self.draft is not None:
                    self._draft_graph = graphs.CapturedStep(
                        self._draft_step, capture=capture)
            if self.spec is not None:
                with ops.serving_phase("verify"):
                    self._verify_graph = graphs.CapturedStep(
                        self._verify_step, capture=capture)
            self._dirty = True        # the warm-up moved pos and tok
        if self._chunker is not None:
            smax = min(self.sched.budget_for(
                self.max_slots, self.spec.k if self.spec else 0),
                self.max_len)
            self._chunker.warmup(
                params, self.pool, [1 << i for i in range(smax.bit_length())],
                cuda_graph=graphed, graph_pool=mempool)

    def _load_shards(self, params):
        """Tensor parallelism at ``load()``: the leader starts the
        followers (each loads the same whole ``params`` and keeps its own
        shards) and keeps the whole tree for the draft; every rank returns
        its shards on its device."""
        if self._tp_rank == 0 and self._group is None:
            group, self._followers, self._tp_dir = tp_lib.start_followers(
                self.mesh, params, self._init_kwargs)
            self._attach_group(group, 0)
        if self._tp_rank == 0 and self.spec is not None:
            self._full_params = params
        shards = tp_lib.shard_params(params, param_specs(self.cfg, params),
                                     self.mesh, rank=self._tp_rank,
                                     cfg=self.cfg)
        return tp_lib._tree_to(shards, self.device)

    def _attach_group(self, group: "tp_lib.Group", rank: int) -> None:
        """Join this engine to its tensor-parallel group as ``rank``."""
        self._group, self._tp_rank = group, rank
        self.model.comm = group

    def _tp_send(self, op: str, **payload) -> None:
        """Leader: broadcast one step's op to the followers, with the
        buffer pushes and page copies queued since the last one."""
        if self._group is None or self._tp_rank != 0:
            return
        pre, self._outbox = self._outbox, []
        self._group.send({"op": op, "pre": pre, **payload})

    def follow(self) -> None:
        """A follower's loop: take the leader's ops in order and run each
        on this rank's shards, until the leader stops. The pushes and page
        copies that came with an op land first."""
        dev = self.device
        pending = None
        while True:
            msg = self._group.recv()
            for kind, arg in msg["pre"]:
                if kind == "copy":
                    self.pool._copy_page(*arg)
                else:
                    self._push_arrays(**arg)
            op = msg["op"]
            if op == "stop":
                return
            if op == "prefill":
                with ops.serving_phase("prefill"):
                    pending, _ = self._prefill(
                        torch.as_tensor(msg["tokens"], device=dev))
            elif op == "insert":
                self.pool.insert(msg["where"], pending)
                pending = None
            elif op == "routes":
                self._group.gather_objects(self._routes(
                    torch.as_tensor(msg["tokens"], device=dev)))
            elif op == "chunk":
                self._chunker.run_window(self.params, self.pool, msg["pos"],
                                         msg["toks"], msg["table"])
            elif op in ("decode", "verify"):
                if msg["nan"] is not None:
                    self._dev_nan[msg["nan"]] = True
                if op == "decode":
                    with ops.serving_phase("decode"):
                        if self._graph is not None:
                            self._graph.replay()
                        else:
                            self._decode_step()
                else:
                    self._dev_win.copy_(torch.from_numpy(msg["win"]))
                    with ops.serving_phase("verify"):
                        if self._verify_graph is not None:
                            self._verify_graph.replay()
                        else:
                            self._verify_step()
                if msg["nan"] is not None:
                    self._dev_nan.zero_()
            else:
                raise RuntimeError(f"unknown tensor-parallel op {op!r}")

    def close(self) -> None:
        """Stop this engine's follower ranks (tensor parallelism; a no-op
        otherwise). The engine serves no more steps after it."""
        if self._followers or self._tp_dir is not None:
            tp_lib.stop_followers(self._group, self._followers, self._tp_dir)
            self._followers, self._tp_dir = [], None

    def _plan(self, params) -> None:
        """``repro``'s plan warm-up at load: every packed linear at every
        power-of-two prefill M up to ``slots * max_len``, the decode M
        (slots), the verify M (slots * (k + 1)) and the chunk windows' Ms;
        the fused blocks at the same Ms when the fused path is on (the
        card, ``cfg.fused_mlp`` not ``"off"``). Every plan resolves its
        tile through the block-shape tuner here, so no serving step pays a
        first-call tune: a step's dispatches hit the ops' memo. Then
        ``repro``'s modelled roofline aggregate per (phase, M), which the
        kernel-phase spans carry (``_modeled``)."""
        top = max(self.max_slots * self.max_len, 1)
        prefill_ms = [1 << i for i in range((top - 1).bit_length() + 1)]
        chunk_ms = ()
        if self._chunker is not None:
            ctop = min(max(self.max_slots * self.sched.budget_for(
                self.max_slots, self.spec.k if self.spec else 0), 1), top)
            chunk_ms = [1 << i for i in range((ctop - 1).bit_length() + 1)]
        ms = dict(prefill_ms=prefill_ms, decode_ms=(self.max_slots,),
                  verify_ms=((self.max_slots * (self.spec.k + 1),)
                             if self.spec else ()),
                  chunk_ms=chunk_ms)
        shard = (tp_lib.gemm_shard_fn(self.mesh, params) if self.tp > 1
                 else None)
        self.gemm_plans = ops.precompute_plans(params,
                                               select=_is_packed_linear,
                                               shard=shard, **ms)
        fused_on = self.device.type == "cuda" and self.cfg.fused_mlp != "off"
        self.fused_plans = (ops.precompute_fused_plans(params, tp=self.tp,
                                                       **ms)
                            if fused_on else {})
        self._phase_model, self._modeled_memo = {}, {}
        for (_, m, phase), plan in self.gemm_plans.items():
            agg = self._phase_model.setdefault(
                (phase, m), {"gemms": 0, "modeled_flops": 0.0,
                             "modeled_bytes": 0.0, "model_time_s": 0.0})
            rl = plan.roofline()
            agg["gemms"] += 1
            agg["modeled_flops"] += rl["flops"]
            agg["modeled_bytes"] += rl["bytes"]
            agg["model_time_s"] += rl["model_time_s"]

    def _modeled(self, phase: str, m: int) -> Optional[Dict[str, float]]:
        """``repro``'s modelled roofline aggregate for one kernel-phase
        span: the warmed bucket a dispatch of ``m`` rows hits (the smallest
        planned M >= m, else the largest), with ``m_bucket``; memoized.
        The draft's plans (``("draft", ...)`` keys) are not in it."""
        if (phase, m) in self._modeled_memo:
            return self._modeled_memo[(phase, m)]
        buckets = sorted(mb for ph, mb in self._phase_model if ph == phase)
        out = None
        if buckets:
            mb = next((b for b in buckets if b >= m), buckets[-1])
            out = dict(self._phase_model[(phase, mb)], m_bucket=mb)
        self._modeled_memo[(phase, m)] = out
        return out

    @property
    def chunker(self) -> Optional[ChunkRunner]:
        """The chunk-window runner (None unless chunked)."""
        return self._chunker

    @property
    def spec_graphs(self) -> Dict[str, graphs.CapturedStep]:
        """The captured draft round and verify window (empty unless
        graphed with ``spec``)."""
        return {name: g for name, g in (("draft", self._draft_graph),
                                        ("verify", self._verify_graph))
                if g is not None}

    @torch.no_grad()
    def _prefill(self, toks: torch.Tensor):
        if self._group is not None:
            self._tp_send("prefill", tokens=toks.cpu().numpy())
        cache_len = self.max_len
        if self.cache_mode == "paged":
            # page-aligned cache length: the pool writes whole pages
            ps = self.pool.page_size
            cache_len = -(-toks.shape[1] // ps) * ps
        cache, logits = self.model.prefill(self.params, {"tokens": toks},
                                           cache_len)
        return cache["layers"], logits[:, -1].argmax(dim=-1).to(torch.int32)

    @torch.no_grad()
    def _routes(self, toks: torch.Tensor) -> List[np.ndarray]:
        with moe.recorded_routes() as log:
            self.model.forward(self.params, {"tokens": toks})
        return [t.numpy() for t in log]

    def rank_routes(self, tokens) -> List[List[np.ndarray]]:
        """Every rank's MoE capacity picks (``tok_sel`` of each MoE layer,
        ``moe.recorded_routes``) for a full-sequence forward of ``tokens``
        (B, S) on its shards, in rank order: tensor-parallel ranks must
        route alike (ROADMAP C11). No cache is touched. One device: [its
        picks]."""
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)
        if self._group is None:
            return [self._routes(toks)]
        self._tp_send("routes", tokens=toks.cpu().numpy())
        return self._group.gather_objects(self._routes(toks))

    @torch.no_grad()
    def _decode_step(self) -> None:
        """One token for every slot on the static buffers: reads pos, tok,
        the NaN mask (and the block table), writes the caches in place,
        then pos + 1, the next tokens and each row's finite guard into pos,
        tok and ok. The CUDA graph captures this. Rows the mask marks
        become NaN ahead of the guard; an all-false mask leaves the logits
        bitwise unchanged."""
        cache = {"layers": self.pool.layers,
                 "pos": torch.clamp(self._dev_pos, max=self.max_len - 1)}
        if self.cache_mode == "paged":
            # free slots' table rows are all zero: their clamped garbage
            # writes land in the trash page 0
            cache["block_table"] = self._dev_table
        logits, new_cache = self.model.decode_step(self.params, cache,
                                                   self._dev_tok[:, None])
        row = torch.where(self._dev_nan[:, None], float("nan"), logits[:, 0])
        self._step_logits = row
        self._dev_ok.copy_(torch.isfinite(row).all(dim=-1))
        self._dev_tok.copy_(row.argmax(dim=-1))
        self._dev_pos.copy_(new_cache["pos"])

    def _draft_step(self) -> None:
        """The draft round on the static buffers: reads pos, the newest and
        second-newest tokens, writes the draft's cache and the verify
        window in place. The CUDA graph captures this."""
        self._draft_round(self._draft_layers, self._dev_pos, self._dev_prev,
                          self._dev_tok, self._dev_win)

    def _verify_step(self) -> None:
        """The verify window on the static buffers (pos, the window, the
        NaN mask and, paged, the block table), writing the pool's caches
        in place; its greedy tokens, accepted counts and guard land in
        ``_spec_out``, its logits in ``_verify_logits`` (under the graph,
        the graph's own outputs). The CUDA graph captures this."""
        self._spec_out, self._verify_logits = self._verify(
            self.params, self.pool.layers, self._dev_pos, self._dev_win,
            self._dev_table if self.cache_mode == "paged" else None,
            self._dev_nan)

    def _push_host_state(self) -> None:
        """Copy the host mirrors (after admit / evict / a spec round) and
        the block table (after a page change) into the static buffers. The
        copies block, so a mirror the next step mutates is never read
        mid-copy."""
        push = {}
        if self._dirty:
            push.update(pos=self._pos, tok=self._tok)
            if self.spec is not None:
                push["prev"] = self._prev_tok
            self._dirty = False
        if self.cache_mode == "paged" and self.pool.table_dirty:
            push["table"] = self.pool.table
            self.pool.table_dirty = False
        if push:
            self._push_arrays(**push)
            if self._group is not None:
                self._outbox.append(("push", {k: v.copy()
                                              for k, v in push.items()}))

    def _push_arrays(self, pos=None, tok=None, prev=None,
                     table=None) -> None:
        """Copy host arrays into the static buffers (blocking copies)."""
        for buf, arr in ((self._dev_pos, pos), (self._dev_tok, tok),
                         (self._dev_prev, prev),
                         (getattr(self, "_dev_table", None), table)):
            if arr is not None:
                buf.copy_(torch.from_numpy(arr))

    def submit(self, prompt: np.ndarray, max_new: int, *,
               deadline_s: Optional[float] = None,
               max_retries: Optional[int] = None, slo=None,
               submit_t: Optional[float] = None) -> Request:
        """Queue a request. ``deadline_s``: its wall-clock budget from
        submit (default ``resilience.deadline_s``); ``max_retries``: its
        quarantine budget (default ``resilience.max_retries``); ``slo``:
        its ``SLOClass`` (None: best effort); ``submit_t``: the arrival to
        stamp (default now)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        # spec mode reserves k positions of headroom: the last emitted
        # token's verify window writes up to position prompt + gen - 1 + k
        headroom = self.spec.k if self.spec is not None else 0
        if prompt.size + max_new + headroom > self.max_len:
            raise ValueError(f"prompt {prompt.size} + gen {max_new} + spec "
                             f"headroom {headroom} exceeds max_len "
                             f"{self.max_len}")
        if deadline_s is None:
            deadline_s = self.resilience.deadline_s
        if deadline_s is not None:
            self._any_deadline = True
        req = self.queue.submit(prompt, max_new, eos_id=self.eos_id,
                                deadline_s=deadline_s,
                                max_retries=max_retries, slo=slo,
                                submit_t=submit_t)
        self.submitted += 1
        tr = self.tracer
        if tr is not None:
            tr.thread_name(self._trace_pid, req.rid + 1, f"req {req.rid}")
            tr.instant("submit", t=req.submit_t, cat="request",
                       pid=self._trace_pid, tid=req.rid + 1,
                       args={"rid": req.rid, "prompt_len": req.prompt_len,
                             "max_new": max_new,
                             "slo": slo.name if slo is not None else None})
        return req

    # ------------------------------------------------------------------
    # tracing helpers; hot paths guard with `if self.tracer is not None`
    def _trace_first_token(self, req: Request) -> None:
        """The request's TTFT parts, from the stamps ``Request.metrics()``
        reads: queue_wait (submit -> admit) and prefill (admit -> first
        token)."""
        tr, pid, tid = self.tracer, self._trace_pid, req.rid + 1
        tr.complete("queue_wait", req.submit_t, req.admit_t,
                    cat="request", pid=pid, tid=tid,
                    args={"rid": req.rid, "attempts": req.attempts})
        tr.complete("prefill", req.admit_t, req.first_token_t,
                    cat="request", pid=pid, tid=tid,
                    args={"rid": req.rid, "chunks": req.chunks})
        tr.instant("first_token", t=req.first_token_t, cat="request",
                   pid=pid, tid=tid, args={"rid": req.rid})

    def _trace_req(self, req: Request, name: str,
                   t: Optional[float] = None, **extra) -> None:
        tr = self.tracer
        if tr is not None:
            tr.instant(name, t=t, cat="request", pid=self._trace_pid,
                       tid=req.rid + 1, args={"rid": req.rid, **extra})

    # ------------------------------------------------------------------
    def _prefill_group(self, group) -> None:
        """Prefill one admitted group ``[(request, slot, Admission|None)]``
        (the admission carries the paged pool's page plan, ``None`` in
        dense mode) and wire up per-request state."""
        t_admit = obs_clock.now()
        for req, _, _ in group:
            req.admit_t = t_admit
        prompts = np.stack([r.prompt for r, _, _ in group])
        with ops.serving_phase("prefill"):
            req_layers, toks_dev = self._prefill(
                torch.as_tensor(prompts, device=self.device))
        self.prefill_steps += 1
        tr = self.tracer
        if tr is not None:
            # the token read is the sync point, so the span ends there
            toks_dev = toks_dev.cpu()
            tr.complete("prefill", t_admit, obs_clock.now(), cat="kernel",
                        pid=self._trace_pid,
                        args={"batch": len(group),
                              "prompt_len": int(prompts.shape[1]),
                              "m": int(prompts.size),
                              **(self._modeled("prefill", int(prompts.size))
                                 or {})})
        where = ([a for _, _, a in group] if self.cache_mode == "paged"
                 else [s for _, s, _ in group])
        self._tp_send("insert", where=where)
        self.pool.insert(where, req_layers)
        if self.spec is not None:
            self._draft_prefill(prompts, [s for _, s, _ in group])
        toks = toks_dev.cpu().numpy()
        now = obs_clock.now()
        for (req, slot, _), tok in zip(group, toks):
            req.slot = slot
            req.state = "live"
            req.tokens.append(int(tok))
            req.first_token_t = now
            self._pos[slot] = req.prompt_len
            self._tok[slot] = tok
            self._prev_tok[slot] = req.prompt[-1]
            self._live[slot] = req
            self._dirty = True
            if tr is not None:
                self._trace_first_token(req)
            if req.done:
                self._evict(slot)

    @torch.no_grad()
    def _draft_prefill(self, prompts: np.ndarray, slots) -> None:
        """The draft keeps its own dense cache of the same stream: prefill
        the prompts (B, L) with the draft and write them into its rows
        ``slots`` (whole rows, so a slot's old garbage goes)."""
        dlm = self.draft.model
        with ops.serving_phase("prefill"):
            cache, _ = dlm.prefill(
                self.draft.params,
                {"tokens": torch.as_tensor(prompts, device=self.device)},
                self.max_len)
        dlm.insert_cache(self._draft_layers, cache["layers"], slots)

    def _head_ready(self, now: float) -> bool:
        """Admission gate: the queue holds a request past its
        ``not_before``. A gated head stalls admission for this step rather
        than being skipped."""
        if self.queue.empty():
            return False
        return self.queue.peek().not_before <= now

    def _admission_paused(self) -> bool:
        """Under page-pool pressure (free fraction below
        ``admission_pause_frac``) pause admission while live requests
        drain: shed load before a preempt-and-replay storm."""
        frac = self.resilience.admission_pause_frac
        if (not frac or self.cache_mode != "paged"
                or not (self._live or self._prefills)
                or self.queue.empty()):
            return False
        free = self.pool.n_free_pages / self.pool.usable_pages
        if free < frac:
            self.admission_pauses += 1
            if self.tracer is not None:
                self.tracer.instant("admission_pause", pid=self._trace_pid,
                                    args={"free_page_frac": round(free, 4)})
            return True
        return False

    def _admit_paged(self, now: float) -> None:
        """Admit a request only when the page pool covers its whole prompt
        (shared prefix pages, fresh pages, reclaimed cold prefix pages). A
        request the pool cannot place now *defers*: admission stops for
        this step and retries after evictions free pages."""
        while self._head_ready(now) and self.pool.n_free:
            adm = self.pool.admit(self.queue.peek().prompt)
            if adm is None:
                self.deferrals += 1
                self._trace_req(self.queue.peek(), "defer")
                return
            group = [(self.queue.pop(), adm.slot, adm)]
            plen = group[0][0].prompt_len
            deferred = False
            while (self._head_ready(now) and self.pool.n_free
                   and self.queue.peek().prompt_len == plen):
                nxt = self.pool.admit(self.queue.peek().prompt)
                if nxt is None:
                    self.deferrals += 1
                    deferred = True
                    break
                group.append((self.queue.pop(), nxt.slot, nxt))
            self._prefill_group(group)
            if deferred:     # already counted: no second attempt this step
                return

    def _admit_chunked(self, now: float) -> None:
        """Chunked admission: grant a slot (and, paged, the prompt's pages,
        private ones only: ``PagePool.admit(use_prefix=False)``) the moment
        one is free; no forward runs here. The request enters
        ``_prefills`` at ``prefill_pos`` 0 and streams its prompt in
        through ``_run_chunks`` over the next steps."""
        while self._head_ready(now) and self.pool.n_free:
            req = self.queue.peek()
            if self.cache_mode == "paged":
                adm = self.pool.admit(req.prompt, use_prefix=False)
                if adm is None:
                    self.deferrals += 1
                    self._trace_req(req, "defer")
                    return
                slot = adm.slot
            else:
                slot = self.pool.alloc()
            self.queue.pop()
            req.slot = slot
            req.state = "live"
            req.prefill_pos = 0
            req.admit_t = obs_clock.now()
            self._prefills[slot] = req
            self._trace_req(req, "admit", t=req.admit_t, slot=slot)

    def _admit(self) -> None:
        now = obs_clock.now()
        if self._admission_paused():
            return
        if self._chunker is not None:
            self._admit_chunked(now)
            return
        if self.cache_mode == "paged":
            self._admit_paged(now)
            return
        while self._head_ready(now) and self.pool.n_free:
            # grouped admission: a run of equal-length prompts in queue
            # order (up to the free-slot count) prefills as one batch
            group = [self.queue.pop()]
            plen = group[0].prompt_len
            while (len(group) < self.pool.n_free and self._head_ready(now)
                   and self.queue.peek().prompt_len == plen):
                group.append(self.queue.pop())
            self._prefill_group(
                [(req, self.pool.alloc(), None) for req in group])

    def _release_slot(self, slot: int) -> Request:
        """Common tail of every live-slot exit: pop the request (from the
        decode batch or the mid-prefill set), return the slot's cache
        (pages or dense row) to its pool, zero the host mirrors."""
        req = self._live.pop(slot, None)
        if req is None:
            req = self._prefills.pop(slot)
        req.slot = None
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._prev_tok[slot] = 0
        self._dirty = True
        if self.cache_mode == "paged":
            self.pool.release(slot)
        else:
            self.pool.free(slot)
        return req

    def _evict(self, slot: int) -> None:
        req = self._release_slot(slot)
        req.state = "done"
        req.done_t = obs_clock.now()
        self._finished.append(req)
        self.total_drained += 1
        if self.tracer is not None and req.first_token_t is not None:
            # the decode phase as one span: its length over (gen_len - 1)
            # tokens is Request.tpot_s
            self.tracer.complete(
                "decode", req.first_token_t, req.done_t, cat="request",
                pid=self._trace_pid, tid=req.rid + 1,
                args={"rid": req.rid, "tokens": len(req.tokens)})
            self._trace_req(req, "done", t=req.done_t,
                            tokens=len(req.tokens))

    def _replay(self, slot: int) -> Request:
        """Reset a live request for a replay from its prompt (preemption or
        quarantine retry). Greedy decode is deterministic, so the replay
        regenerates the same tokens (a chunked replay restarts its prefill
        at position 0)."""
        req = self._release_slot(slot)
        req.tokens.clear()
        req.first_token_t = None
        req.admit_t = None            # re-stamped at the retry admission
        req.prefill_pos = 0           # chunked prefill restarts from 0
        req.spec_proposed = 0         # a replay counts its drafts again
        req.spec_accepted = 0
        return req

    def _preempt(self, slot: int) -> None:
        """Paged OOM recovery: release the slot's pages and replay the
        request later, re-queued at the head."""
        req = self._replay(slot)
        self.queue.push_front(req)
        self.preemptions += 1
        self._trace_req(req, "preempt", slot=slot)

    def _fail_live(self, slot: int, reason: str) -> None:
        """Terminal failure of a request in a slot: the slot and its pages
        are reclaimed as on eviction, and the request drains failed."""
        self._fail(self._release_slot(slot), reason)

    def _fail(self, req: Request, reason: str) -> None:
        req.state = "failed"
        req.fail_reason = reason
        req.done_t = obs_clock.now()
        self._finished.append(req)
        self.total_drained += 1
        self.failed_requests += 1
        self._trace_req(req, "failed", t=req.done_t, reason=reason,
                        attempts=req.attempts)
        log.warning("request %d failed: %s (attempts=%d, %d tokens in)",
                    req.rid, reason, req.attempts, len(req.tokens))

    def _quarantine(self, slot: int) -> None:
        """The slot's logits were not finite this step: drop its
        uncommitted token and retry the request from its prompt, re-queued
        at the tail after an exponential backoff, within its retry budget;
        past the budget it fails. Other slots are untouched."""
        req = self._live.get(slot) or self._prefills[slot]
        self.quarantines += 1
        req.attempts += 1
        retries = (req.max_retries if req.max_retries is not None
                   else self.resilience.max_retries)
        if req.attempts > retries:
            self._fail_live(slot, FAIL_NUMERIC)
            return
        self.fault_retries += 1
        backoff = self.resilience.retry_backoff_s
        req.not_before = (obs_clock.now()
                          + backoff * (2 ** (req.attempts - 1))
                          if backoff else 0.0)
        self._trace_req(req, "quarantine", slot=slot,
                        attempts=req.attempts)
        self.queue.requeue(self._replay(slot))
        log.warning("quarantined slot %d (request %d): non-finite logits; "
                    "retry %d/%d", slot, req.rid, req.attempts, retries)

    def _expire_deadlines(self) -> None:
        """Cancel every request past its deadline: queued ones before they
        cost a prefill, live and mid-prefill ones with their slot and
        pages reclaimed."""
        if not self._any_deadline:
            return
        now = obs_clock.now()
        for req in self.queue.take_expired(now):
            self._fail(req, FAIL_DEADLINE)
            self.deadline_cancels += 1
        for held in (self._live, self._prefills):
            for slot in list(held):
                if held[slot].expired(now):
                    self._fail_live(slot, FAIL_DEADLINE)
                    self.deadline_cancels += 1

    def _grow_paged(self, horizon: int = 1) -> None:
        """Before each paged decode step, make every live row's next
        ``horizon`` write positions appendable: allocate pages crossed into
        and copy shared pages about to be written. When the pool is dry,
        preempt the *youngest* live request and retry; the oldest is never
        preempted while others live, which guarantees drain progress."""
        for slot in list(self._live):
            if slot not in self._live:       # preempted by an earlier turn
                continue
            p = 0
            while p < horizon:
                if self.pool.ensure_append(slot, int(self._pos[slot]) + p):
                    p += 1
                    continue
                # mid-prefill slots go first: they have produced no token,
                # so their replay wastes the least work, and a decoding
                # slot still outranks every prefill
                victim = (next(reversed(self._prefills)) if self._prefills
                          else next(reversed(self._live)))
                self._preempt(victim)
                if victim == slot:
                    break

    def _run_chunks(self) -> None:
        """Advance every mid-prefill slot by its planned chunk: budget the
        step's residual tokens across ``_prefills`` (``plan_chunks``), run
        one window, then commit. A request whose prompt completes reads its
        first token at its last real window position and joins the decode
        batch (spec: after a whole-prompt prefill of the draft's cache)."""
        if not self._prefills:
            self._chunk_meta = None
            return
        k = self.spec.k if self._spec_active else 0
        tpots = [r.slo.tpot_target_s for r in self._live.values()
                 if r.slo is not None
                 and getattr(r.slo, "tpot_target_s", None) is not None]
        jobs, meta = plan_chunks(
            list(self._prefills.items()), cfg=self.sched,
            budget=self.sched.budget_for(self.max_slots, k),
            n_decode_tokens=len(self._live) * (1 + k), max_len=self.max_len,
            now=obs_clock.now(), step_s=self._step_time.value or 0.0,
            tpot_floor=min(tpots) if tpots else None)
        self._chunk_meta = meta
        if not jobs:
            return
        t_window = obs_clock.now()
        greedy, ok = self._chunker.advance(self.params, self.pool, jobs,
                                           self._pos)
        self.chunk_steps += 1
        now = obs_clock.now()
        tr = self.tracer
        if tr is not None:
            # the greedy read in advance() is the sync point
            tr.complete("chunk_window", t_window, now, cat="kernel",
                        pid=self._trace_pid,
                        args={"rows": len(jobs),
                              "tokens": sum(c for _, _, c in jobs),
                              "m": self.max_slots * meta["window"], **meta,
                              **(self._modeled("chunk", self.max_slots
                                               * meta["window"]) or {})})
        for i, (slot, req, c) in enumerate(jobs):
            if not ok[i]:
                self._quarantine(slot)
                continue
            if tr is not None:
                tr.complete("chunk", t_window, now, cat="request",
                            pid=self._trace_pid, tid=req.rid + 1,
                            args={"rid": req.rid, "tokens": c,
                                  "pos": req.prefill_pos})
            req.prefill_pos += c
            req.chunks += 1
            self.chunk_tokens_committed += c
            # the slot's garbage decode lane follows the prefill frontier
            self._pos[slot] = req.prefill_pos
            self._dirty = True
            if req.prefill_pos >= req.prompt_len:
                tok = int(greedy[i, c - 1])
                del self._prefills[slot]
                self._live[slot] = req
                req.tokens.append(tok)
                req.first_token_t = now
                self._tok[slot] = tok
                self._prev_tok[slot] = req.prompt[-1]
                self.prefill_completions += 1
                if tr is not None:
                    self._trace_first_token(req)
                if req.done:             # max_new == 1 (or instant EOS)
                    self._evict(slot)
                elif self.spec is not None:
                    # the draft's cache takes the whole prompt at once:
                    # draft-sized, and not what the step's latency is
                    self._draft_prefill(req.prompt[None], [slot])

    @property
    def _spec_active(self) -> bool:
        return self.spec is not None and not self.spec_disabled

    def _plan_faults(self):
        """Draw this step's faults and apply the ones outside the decode
        step at once (the sleep, the armed page failures); the NaN and
        draft faults are returned for the decode step or spec round."""
        if self.injector is None:
            return None
        f = self.injector.plan(self._step_no)
        if f.slow:
            self.injector.count("slow_step")
            time.sleep(self.injector.cfg.slow_s)
        if f.oom and self.cache_mode == "paged":
            self.injector.count("page_oom")
            self.pool.inject_alloc_failures(self.injector.cfg.oom_burst)
        return f

    def _nan_mask(self, faults) -> Optional[int]:
        """Mark this step's NaN victim (a live slot, drawn by the
        injector) in the static mask; returns it, or None when no NaN
        fault fires (the mask stays all false)."""
        if faults is None or not faults.nan or not self._live:
            return None
        victim = self.injector.choose_slot(list(self._live))
        self._dev_nan[victim] = True
        return victim

    def step(self) -> None:
        """One iteration: draw the faults, expire deadlines, admit (+
        prefill, or advance the chunked prefills), grow pages, decode every
        slot (or run the spec round: draft, verify, rollback) under the
        finite guard, then commit or quarantine each live slot and
        evict."""
        self._step_no += 1
        t_step = obs_clock.now()
        faults = self._plan_faults()
        self._expire_deadlines()
        self._depth_stat.push(self.queue.depth())
        self._admit()
        if self._chunker is not None:
            self._run_chunks()
        # a draft fault (or the acceptance floor) turns this step into one
        # plain decode step, whose growth horizon is 1
        spec_active = self._spec_active
        draft_down = (spec_active and faults is not None
                      and faults.draft_fail)
        if draft_down:
            self.injector.count("draft_fail")
            self.draft_fallbacks += 1
            if self.tracer is not None:
                self.tracer.instant("draft_fallback", pid=self._trace_pid,
                                    args={"step": self._step_no})
        if self.cache_mode == "paged":
            self._grow_paged(1 + (self.spec.k
                                  if spec_active and not draft_down else 0))
        if not self._live:
            if self._prefills:       # a chunk-only step did real work
                self._note_step_time(t_step)
            return
        self._live_stat.push(len(self._live) + len(self._prefills))
        self._push_host_state()
        if spec_active and not draft_down:
            self._step_spec(faults)
            self._note_step_time(t_step)
            return
        victim = self._nan_mask(faults)
        t_decode = obs_clock.now()
        self._tp_send("decode", nan=victim)
        with ops.serving_phase("decode"):
            if self._graph is not None:
                self._graph.replay()
            else:
                self._decode_step()
        self.last_logits = self._step_logits
        self.decode_steps += 1
        toks, ok = self._read_step()
        if victim is not None:
            self._dev_nan.zero_()
        tr = self.tracer
        if tr is not None:
            # the token read is the sync point: the span covers the step's
            # dispatch (or replay) and its run on the device
            tr.complete("decode_step", t_decode, obs_clock.now(),
                        cat="kernel", pid=self._trace_pid,
                        args={"live": len(self._live), "m": self.max_slots,
                              **(self._modeled("decode", self.max_slots)
                                 or {})})
        for slot in list(self._live):
            req = self._live[slot]
            if not ok[slot]:
                self._quarantine(slot)
                continue
            if self.spec is not None:
                # keep the draft round's re-sync feed right across plain
                # decode steps (spec.draft.make_draft_round)
                self._prev_tok[slot] = self._tok[slot]
                self._dirty = True
            req.tokens.append(int(toks[slot]))
            self._pos[slot] += 1
            self._tok[slot] = toks[slot]
            if req.done:
                self._evict(slot)
        self._note_step_time(t_step)

    def _step_spec(self, faults) -> None:
        """One speculative round: draft k tokens a slot, verify the (slots,
        k+1) window in one target forward, commit each slot's accepted
        prefix and bonus token (up to its budget or EOS), roll the target
        cache back past the rejected tail, and quarantine a slot whose
        window is not finite. The draft round and the verify window run
        back to back (two graph replays on the card); the host reads one
        (slots, k+3) int32 tensor."""
        k = self.spec.k
        tr = self.tracer
        t_draft = obs_clock.now()
        with ops.serving_phase("decode"):        # draft GEMMs are M = slots
            if self._draft_graph is not None:
                self._draft_graph.replay()
            else:
                self._draft_step()
        if tr is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            tr.complete("draft", t_draft, obs_clock.now(), cat="kernel",
                        pid=self._trace_pid,
                        args={"live": len(self._live), "k": k,
                              "m": self.max_slots})
        victim = self._nan_mask(faults)
        t_verify = obs_clock.now()
        if self._group is not None:
            # the followers verify the window the leader's draft wrote
            self._tp_send("verify", win=self._dev_win.cpu().numpy(),
                          nan=victim)
        with ops.serving_phase("verify"):
            if self._verify_graph is not None:
                self._verify_graph.replay()
            else:
                self._verify_step()
        self.last_logits = self._verify_logits
        self.decode_steps += 1
        self.spec_rounds += 1
        out = self._spec_out.cpu().numpy()
        greedy, n_acc, ok = out[:, :k + 1], out[:, k + 1], out[:, k + 2]
        if victim is not None:
            self._dev_nan.zero_()
        if tr is not None:
            # the output read above is the sync point
            tr.complete("verify", t_verify, obs_clock.now(), cat="kernel",
                        pid=self._trace_pid,
                        args={"live": len(self._live), "k": k,
                              "m": self.max_slots * (k + 1),
                              **(self._modeled("verify", self.max_slots
                                               * (k + 1)) or {})})
        round_slots = round_accepted = 0
        for slot in list(self._live):
            req = self._live[slot]
            if not ok[slot]:
                # a corrupted window commits nothing; the replay from the
                # prompt is token-exact, so the NaN never reaches the output
                self._quarantine(slot)
                continue
            na = int(n_acc[slot])
            round_slots += 1
            round_accepted += na
            self.spec_slot_rounds += 1
            self.spec_proposed += k
            self.spec_accepted += na
            req.spec_proposed += k
            req.spec_accepted += na
            old_tok = int(self._tok[slot])
            emitted = 0
            for j in range(na + 1):               # accepted drafts + bonus
                req.tokens.append(int(greedy[slot, j]))
                emitted += 1
                if req.done:                      # budget / EOS mid-window
                    break
            self.spec_emitted += emitted
            self._pos[slot] += emitted
            self._tok[slot] = greedy[slot, emitted - 1]
            self._prev_tok[slot] = (greedy[slot, emitted - 2]
                                    if emitted >= 2 else old_tok)
            self._dirty = True
            if req.done:
                self._evict(slot)                 # release drops the pages
            elif self.cache_mode == "paged":
                self.spec_page_reclaims += rollback_paged(
                    self.pool, slot, int(self._pos[slot]))
            else:
                rollback_dense(self.pool, slot, int(self._pos[slot]))
        self._check_accept_floor(round_slots, round_accepted)

    def _check_accept_floor(self, round_slots: int,
                            round_accepted: int) -> None:
        """Degradation rung 1: once the mean acceptance of the last
        ``spec_floor_window`` rounds is below ``spec_accept_floor``, every
        round costs a k+1 window for about one token, worse than plain
        decode, so speculation is shed for the rest of the engine's
        life."""
        floor = self.resilience.spec_accept_floor
        if floor <= 0.0 or not round_slots:
            return
        self._accept_ring.append(round_accepted
                                 / (self.spec.k * round_slots))
        if (len(self._accept_ring) < self._accept_ring.maxlen
                or self.spec_disabled):
            return
        mean = sum(self._accept_ring) / len(self._accept_ring)
        if mean < floor:
            self.spec_disabled = True
            self.spec_disables += 1
            if self.tracer is not None:
                self.tracer.instant("spec_disabled", pid=self._trace_pid,
                                    args={"acceptance": round(mean, 4),
                                          "floor": floor})
            log.warning("spec decoding disabled: rolling acceptance %.3f "
                        "< floor %.3f over %d rounds", mean, floor,
                        self._accept_ring.maxlen)

    def _read_step(self):
        """The decode step's next tokens and guard, one device read."""
        out = self._dev_out.cpu().numpy()
        return out[0], out[1].astype(bool)

    def _note_step_time(self, t0: float) -> None:
        """Feed the step-time EWMA, count stragglers, and emit the per-step
        counters on the scheduler track."""
        dt = obs_clock.now() - t0
        prev = self._step_time.value
        self._step_time.update(dt)
        straggler = prev is not None and dt > _STRAGGLER_FACTOR * prev
        if straggler:
            self.metrics.counter("straggler_steps").inc()
        tr = self.tracer
        if tr is None:
            return
        if straggler:
            tr.instant("straggler_step", pid=self._trace_pid,
                       args={"dt_s": round(dt, 6), "ewma_s": round(prev, 6)})
        tr.counter("sched", {"queue_depth": self.queue.depth(),
                             "live_slots": len(self._live),
                             "prefilling": len(self._prefills)},
                   pid=self._trace_pid)
        util = {"step_ms": round(dt * 1e3, 3)}
        if self.cache_mode == "paged":
            util["free_page_frac"] = round(
                self.pool.n_free_pages / self.pool.usable_pages, 4)
        meta = self._chunk_meta
        if meta is not None:
            util["token_budget_util"] = round(min(1.0, (
                meta["assigned"] + meta["decode_tokens"])
                / max(meta["budget"], 1)), 4)
        tr.counter("util", util, pid=self._trace_pid)

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        """Anything queued, mid-prefill or decoding: the loop condition of
        an external loop (``serving.traffic.run_open_loop``)."""
        return bool(self.queue) or bool(self._live) or bool(self._prefills)

    def begin_metrics(self) -> Dict[str, Any]:
        """Snapshot the cumulative counters and reset the windowed stats.
        ``run()`` calls this first; a caller that steps the engine itself
        calls it before its loop and ``collect_metrics`` after, for the
        same JSON ``run()`` gives."""
        if self.params is None:
            raise RuntimeError("load(params) first")
        self._depth_stat = RunningStat("queue_depth")
        self._live_stat = RunningStat("live_slots")
        return {"t0": obs_clock.now(), "n0": self.total_drained,
                "p0": self.prefill_steps, "d0": self.decode_steps,
                "c0": (self.chunk_steps, self.chunk_tokens_committed,
                       self.prefill_completions),
                "s0": (self.spec_rounds, self.spec_proposed,
                       self.spec_accepted, self.spec_emitted,
                       self.spec_page_reclaims, self.spec_slot_rounds),
                "f0": {"quarantines": self.quarantines,
                       "retries": self.fault_retries,
                       "failed": self.failed_requests,
                       "pauses": self.admission_pauses,
                       "deadline_cancels": self.deadline_cancels,
                       "spec_disables": self.spec_disables,
                       "draft_fallbacks": self.draft_fallbacks,
                       "injected": (dict(self.injector.injected)
                                    if self.injector else {})}}

    def run(self) -> Dict[str, Any]:
        """Drain the queue completely; return the metrics dict."""
        snap = self.begin_metrics()
        budget = (self.queue.depth() + len(self._live)
                  + len(self._prefills)) * self.max_len + 1
        if self._chunker is not None:
            # chunked prefill spends up to prompt_len extra steps a request
            # (the worst case: the one-token liveness trickle)
            budget *= 2
        if self.cache_mode == "paged":
            # preempt-and-replay re-runs requests; each replay costs at most
            # max_len extra steps and the oldest-never-preempted rule bounds
            # the churn, so this is headroom, not an expected count
            budget *= 8
        if self.injector is not None or self.resilience.max_retries > 0:
            # a quarantine replays its request from the prompt, so each of
            # the retries can cost another whole generation
            budget *= 2 + self.resilience.max_retries
        idle = 0
        while self.has_work():
            if budget <= 0:
                raise RuntimeError("scheduler failed to make progress")
            progress = (self.prefill_steps, self.decode_steps,
                        self.chunk_steps, self.total_drained)
            self.step()
            if (self.prefill_steps, self.decode_steps, self.chunk_steps,
                    self.total_drained) == progress:
                # an idle tick: nothing live and the queue head inside its
                # retry backoff (or deferred). Waiting costs no work, so it
                # takes no budget; yield briefly instead.
                idle += 1
                if idle >= 1_000_000:
                    raise RuntimeError("scheduler stuck on idle ticks")
                time.sleep(5e-4)
            else:
                idle = 0
                budget -= 1
        if self.total_drained != self.submitted:
            raise RuntimeError(f"drained {self.total_drained} requests but "
                               f"{self.submitted} were submitted")
        return self.collect_metrics(snap)

    def _slo_report(self, done) -> Optional[Dict[str, Any]]:
        """Per-class SLO violation counts over a span's finished requests
        (objectives, not guarantees: this is the scoreboard)."""
        classes: Dict[str, Dict[str, Any]] = {}
        for r in done:
            if r.slo is None:
                continue
            ttft_t = getattr(r.slo, "ttft_target_s", None)
            tpot_t = getattr(r.slo, "tpot_target_s", None)
            c = classes.setdefault(r.slo.name, {
                "n": 0, "ttft_target_s": ttft_t, "tpot_target_s": tpot_t,
                "ttft_violations": 0, "tpot_violations": 0})
            c["n"] += 1
            if ttft_t is not None and r.ttft_s is not None \
                    and r.ttft_s > ttft_t:
                c["ttft_violations"] += 1
            if tpot_t is not None and r.tpot_s is not None \
                    and r.tpot_s > tpot_t:
                c["tpot_violations"] += 1
        return classes or None

    def collect_metrics(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """The metrics JSON of the span since ``begin_metrics``: ``repro``'s
        keys and shapes (``mesh`` None on one device), without
        ``planned_gemms``."""
        wall = obs_clock.now() - snap["t0"]
        c0, f0 = snap["c0"], snap["f0"]
        done = self._finished[snap["n0"]:]
        gen = sum(len(r.tokens) for r in done)
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        cache = {"mode": self.cache_mode, "nbytes": int(self.pool.nbytes)}
        if self.cache_mode == "paged":
            cache.update(self.pool.stats())
            cache["preemptions"] = self.preemptions
            cache["deferrals"] = self.deferrals
        return {
            "engine": "continuous",
            "max_slots": self.max_slots,
            "max_len": self.max_len,
            "mesh": (None if self.mesh is None else
                     {"tp": int(np.prod(list(tp_lib.mesh_axis_sizes(
                          self.mesh).values()))),
                      "axes": tp_lib.mesh_axis_sizes(self.mesh),
                      "collective_plans": sum(
                          1 for p in self.gemm_plans.values()
                          if p.collective)}),
            "cache": cache,
            "spec": self._spec_metrics(snap, done),
            "concurrency": {"peak": self._live_stat.peak,
                            "mean": round(self._live_stat.mean, 3)},
            "per_request": [r.metrics() for r in done],
            "submitted": len(done),
            "drained": len(done),
            "generated_tokens": gen,
            "wall_s": round(wall, 4),
            "tok_per_s": round(gen / wall, 2) if wall > 0 else None,
            "prefill_steps": self.prefill_steps - snap["p0"],
            "decode_steps": self.decode_steps - snap["d0"],
            "ttft_s": {"mean": float(np.mean(ttfts)) if ttfts else None,
                       "max": float(np.max(ttfts)) if ttfts else None},
            "latency": {
                "ttft_s": percentiles(r.ttft_s for r in done),
                "queue_wait_s": percentiles(r.queue_wait_s for r in done),
                "prefill_s": percentiles(r.prefill_s for r in done),
                "tpot_s": percentiles(r.tpot_s for r in done),
                "e2e_s": percentiles(r.latency_s for r in done),
            },
            "sched": (None if self.sched is None else {
                "chunked_prefill": self._chunker is not None,
                "chunk_tokens": self.sched.chunk_tokens,
                "step_token_budget": self.sched.budget_for(
                    self.max_slots,
                    self.spec.k if self.spec is not None else 0),
                "admission": self.sched.admission,
                "chunk_steps": self.chunk_steps - c0[0],
                "chunk_tokens_committed":
                    self.chunk_tokens_committed - c0[1],
                "prefill_completions": self.prefill_completions - c0[2],
                "slo": self._slo_report(done),
            }),
            "queue_depth": {"max": self._depth_stat.peak,
                            "mean": self._depth_stat.mean},
            "faults": {
                "injected": {k: v - f0["injected"].get(k, 0)
                             for k, v in (self.injector.injected.items()
                                          if self.injector else ())},
                "quarantines": self.quarantines - f0["quarantines"],
                "retries": self.fault_retries - f0["retries"],
                "failed_requests": self.failed_requests - f0["failed"],
                "degradations": {
                    "spec_disabled": self.spec_disabled,
                    "spec_disables": (self.spec_disables
                                      - f0["spec_disables"]),
                    "admission_pauses": (self.admission_pauses
                                         - f0["pauses"]),
                    "deadline_cancellations": (self.deadline_cancels
                                               - f0["deadline_cancels"]),
                },
            },
        }


    def _spec_metrics(self, snap, done) -> Optional[Dict[str, Any]]:
        """The ``spec`` block (None without ``spec``): rounds, draft tokens
        proposed and accepted, emitted tokens per (slot, round), pages
        reclaimed by rollback, fallbacks, and the per-request rates."""
        if self.spec is None:
            return None
        s0 = snap["s0"]
        proposed = self.spec_proposed - s0[1]
        accepted = self.spec_accepted - s0[2]
        emitted = self.spec_emitted - s0[3]
        slot_rounds = self.spec_slot_rounds - s0[5]
        return {
            "draft": self.draft.name,
            "k": self.spec.k,
            "rounds": self.spec_rounds - s0[0],
            "draft_tokens_proposed": proposed,
            "draft_tokens_accepted": accepted,
            "acceptance_rate": (round(accepted / proposed, 4)
                                if proposed else None),
            # tokens emitted per (slot, round): 1 (no draft accepted) to
            # k+1 (the whole window and the bonus)
            "mean_accepted_len": (round(emitted / slot_rounds, 3)
                                  if slot_rounds else None),
            "rollback_page_reclaims": self.spec_page_reclaims - s0[4],
            "disabled": self.spec_disabled,
            "draft_fallbacks": (self.draft_fallbacks
                                - snap["f0"]["draft_fallbacks"]),
            "per_request": [
                {"rid": r.rid, "proposed": r.spec_proposed,
                 "accepted": r.spec_accepted,
                 "rate": (round(r.spec_accepted / r.spec_proposed, 4)
                          if r.spec_proposed else None)}
                for r in done],
        }


def _is_packed_linear(path, w) -> bool:
    """Only packed linears dispatch through ``ternary_gemm``."""
    return bool(path) and path[-1] == "w_packed"


def _check_chunked(cfg: ModelConfig) -> None:
    """``repro``'s checks of a chunked-prefill engine, in its order."""
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.num_layers)):
        raise ValueError("chunked prefill needs an attention-only stack: "
                         "mid-prefill slots ride the decode batch as garbage "
                         "lanes, and SSM recurrent state advanced on garbage "
                         "tokens cannot be overwritten later")
    if cfg.cache_layout == "opt":
        raise ValueError("chunked prefill needs cache_layout='bshd' (the "
                         "'opt' delta-commit layout is one-token-only)")
    if cfg.sliding_window:
        raise ValueError("chunked prefill does not support rolling "
                         "sliding-window caches: padded chunk-window writes "
                         "would overwrite live rolled entries")


def _check_spec(cfg: ModelConfig, spec, max_len: int) -> None:
    """``repro``'s checks of a speculative engine, in its order."""
    if spec.k < 1:
        raise ValueError(f"spec.k must be >= 1, got {spec.k}")
    if max_len < spec.k + 2:
        raise ValueError(f"max_len={max_len} leaves no room for a "
                         f"k={spec.k} verify window")
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.num_layers)):
        raise ValueError("speculative decoding needs an attention-only "
                         "stack: SSM recurrent state advanced past a "
                         "rejected token cannot be rolled back by position "
                         "bookkeeping")
    if cfg.cache_layout == "opt":
        raise ValueError("speculative decoding needs cache_layout='bshd' "
                         "(the 'opt' delta-commit layout is one-token-only)")
    if cfg.sliding_window:
        raise ValueError("speculative decoding does not support rolling "
                         "sliding-window caches: a rejected window write "
                         "overwrites the oldest live entry, which rollback "
                         "cannot restore")


# The scheduler's counters live in its MetricsRegistry behind these
# attribute names (repro's idiom: `eng.total_drained += 1` reads and
# writes the registry), so `engine.metrics.snapshot()` holds them all.
_ENGINE_COUNTERS = ("total_drained", "prefill_steps", "decode_steps",
                    "preemptions", "deferrals", "spec_rounds",
                    "spec_slot_rounds", "spec_proposed", "spec_accepted",
                    "spec_emitted", "spec_page_reclaims", "chunk_steps",
                    "chunk_tokens_committed", "prefill_completions",
                    "quarantines", "fault_retries", "failed_requests",
                    "admission_pauses", "deadline_cancels",
                    "spec_disables", "draft_fallbacks")


def _counter_property(name: str) -> property:
    def _get(self):
        return self.metrics.counter(name).value

    def _set(self, v):
        self.metrics.counter(name).value = int(v)

    return property(_get, _set, doc=f"registry-backed counter {name!r}")


for _cname in _ENGINE_COUNTERS:
    setattr(ContinuousScheduler, _cname, _counter_property(_cname))
del _cname
