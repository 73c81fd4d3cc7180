"""Serving CLI of the port: the continuous-batching engine over the dense
slot pool or the paged KV pool, on the card by default, or the static-batch
server (``--static``) on the same workload for an A/B.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch ternary-paper \\
      --packed --requests 16 --slots 8 --prompt-len 128 --gen-lens 32,64
  ... --arch mamba2-130m | mixtral-8x22b | jamba-v0.1-52b | ...  # every
      registered config; only ternary-paper's config quantizes, so
      --packed on another one converts nothing and warns, as repro's does
  ... --static --batch 8                 # whole batches, the A/B reference
  ... --arch seamless-m4t-large-v2 | internvl2-76b --static   # the
      encoder-decoder and VLM families, static only (the continuous
      engine refuses them, as repro's does): each request carries its
      frontend rows, and the default --max-len holds a VLM's vision rows
  ... --max-len N --eos-id T             # cache capacity; stop on a token
  ... --cache paged --page-size 16 [--kv-dtype int8 --pages N]
  ... --cache paged --paged-attn jax     # the gather lowering, not B5
  ... --device cpu --reduced --ternary-min-dim 64   # plain PyTorch path
  ... --trace run.json [--trace-buffer N]   # Chrome trace-event JSON
  ... --chunked-prefill [--chunk-tokens 32 --step-token-budget N]
  ... --slo-ttft-ms 500 --slo-tpot-ms 100  # the interactive class's targets
  ... --traffic poisson|bursty --arrival-rate 8   # open-loop arrivals
  ... --chaos [--deadline-s 2 --max-retries 2]    # seeded fault injection
  ... --spec layer_skip|resparsify [--spec-k 4 --draft-layers N
      --draft-sparsity 0.125]                     # speculative decoding
  ... --mesh 2,2 [--mesh-devices cuda:0,cuda:1,cuda:2,cuda:3]   # dp x tp:
      dp engine replicas, each tensor-parallel over tp ranks (one process
      a rank), behind the prefix-affinity Router; every decoder family
      (dense, moe, ssm, hybrid) and continuous mode only. Needs dp*tp devices (default: every card; a
      device may repeat, e.g. --device cpu --mesh-devices cpu,cpu, and
      ranks sharing a card run over gloo without CUDA graphs)

Read a trace with ``python scripts/trace_report.py run.json`` or load it at
https://ui.perfetto.dev.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.weights import Dense2Bit
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import tp as tp_lib
from repro_torch.distributed.router import Router
from repro_torch.kernels import ops
from repro_torch.models import LM
from repro_torch.obs import clock as obs_clock
from repro_torch.models.layers import pack_params
from repro_torch.obs import Tracer
from repro_torch.serving import (ContinuousScheduler, FaultConfig,
                                 ResilienceConfig, SchedConfig, SLOClass,
                                 TrafficConfig, make_schedule, run_open_loop)
from repro_torch.spec import SpecConfig


def build_workload(cfg, requests: int, prompt_len: int,
                   gen_lens: Sequence[int], seed: int = 0,
                   ) -> Tuple[np.ndarray, List[int], Dict[str, np.ndarray]]:
    """(prompts (R, L) int32, per-request gen budgets, extras): prompts from
    the deterministic SyntheticLM stream, budgets drawn uniformly from
    ``gen_lens`` — the same draws as ``repro.launch.serve.build_workload``.
    ``extras`` holds each request's frontend rows (``vision_embeds`` or
    ``enc_embeds``, (R, frontend_seq, d) float32) for the VLM and
    encoder-decoder families, else nothing; their text prompts then take
    what ``prompt_len`` leaves after the frontend (``SyntheticLM``'s
    ``text_len``, at least 16)."""
    data = SyntheticLM(cfg, requests, max(prompt_len, 16), seed=seed)
    b = data.global_batch(0)
    prompts = b["tokens"][:, :prompt_len]
    extras = {k: v for k, v in b.items()
              if k in ("vision_embeds", "enc_embeds")}
    rng = np.random.default_rng(seed + 1)
    gens = [int(g) for g in rng.choice(list(gen_lens), size=requests)]
    return prompts.astype(np.int32), gens, extras


def run_continuous(engine, prompts: np.ndarray, gens: Sequence[int],
                   ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    """Submit the whole workload, drain it, return per-request token arrays
    (in submit order) and the engine metrics dict."""
    reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    metrics = engine.run()
    return [np.asarray(r.tokens, np.int32) for r in reqs], metrics


class BatchedServer:
    """Static-batch server (``repro``'s): one prefill and ``gen_len``
    decode steps a batch through ``LM``, eagerly, the prefill under the
    ``"prefill"`` phase and each decode step under ``"decode"`` (M =
    batch, scalar positions)."""

    def __init__(self, cfg, max_len: int, device="cuda"):
        self.cfg = cfg
        self.model = LM(cfg, device)
        self.max_len = max_len
        self.params = None

    def load(self, params) -> None:
        self.params = params

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, gen_len: int,
                 extras: Optional[Dict[str, np.ndarray]] = None
                 ) -> np.ndarray:
        """(B, L) prompts -> (B, gen_len) greedy tokens: the prefill's
        last-position argmax, then one token a decode step. ``extras``:
        the batch's frontend rows (``vision_embeds`` / ``enc_embeds``,
        (B, S_front, d)), part of the prefill's batch."""
        dev = self.model.device
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=dev)}
        for k, v in (extras or {}).items():
            batch[k] = torch.as_tensor(np.asarray(v), device=dev)
        with ops.serving_phase("prefill"):
            cache, logits = self.model.prefill(self.params, batch,
                                               self.max_len)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        out = []
        with ops.serving_phase("decode"):
            for _ in range(gen_len):
                out.append(tok)
                logits, cache = self.model.decode_step(self.params, cache,
                                                       tok)
                tok = logits.argmax(dim=-1).to(torch.int32)
        return torch.cat(out, dim=1).cpu().numpy()


def run_static(server: BatchedServer, prompts: np.ndarray,
               gens: Sequence[int], batch: int,
               extras: Optional[Dict[str, np.ndarray]] = None,
               ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    """Static-batch A/B reference on the same workload (``repro``'s):
    requests grouped in submit order, each batch decoding max(its budgets)
    steps and each request keeping its own budget's prefix. A ragged final
    batch is padded with copies of its last row (prompt and ``extras``
    rows alike) and the padding dropped."""
    n = len(prompts)
    if n == 0 or n != len(gens):
        raise ValueError(f"{n} prompts for {len(gens)} budgets")
    outs: List[np.ndarray] = []
    t0 = obs_clock.now()
    n_decode = 0

    def pad(rows):
        if len(rows) == batch:
            return rows
        return np.concatenate(
            [rows, np.repeat(rows[-1:], batch - len(rows), axis=0)])

    for lo in range(0, n, batch):
        chunk = pad(prompts[lo:lo + batch])
        ext = {k: pad(v[lo:lo + batch]) for k, v in (extras or {}).items()}
        budgets = list(gens[lo:lo + batch])
        gen = max(budgets)
        toks = server.generate(chunk, gen, ext or None)
        n_decode += gen
        outs.extend(toks[i, :g].astype(np.int32)
                    for i, g in enumerate(budgets))
    wall = obs_clock.now() - t0
    useful = sum(len(o) for o in outs)
    return outs, {
        "engine": "static",
        "batch": batch,
        "submitted": n,
        "drained": len(outs),
        "generated_tokens": useful,
        "wall_s": round(wall, 4),
        "tok_per_s": round(useful / wall, 2) if wall > 0 else None,
        "decode_steps": n_decode,
    }


def count_packed(params) -> int:
    if isinstance(params, Dense2Bit):
        return 1
    if isinstance(params, dict):
        return sum(count_packed(v) for v in params.values())
    if isinstance(params, list):
        return sum(count_packed(v) for v in params)
    return 0


def build_params(cfg, seed: int, device, packed: bool):
    """Random-init parameters from a seeded generator on ``device``, packed
    into the ternary serving format when asked: each layer as it is drawn
    (a full-width MoE layer's latent f32 banks are ~11 GB), then the rest.
    Returns (cfg, params): a packed model's config reads
    ``quantization="ternary_packed"``. A config that packs nothing (its
    ``quantization`` is ``"none"``, or no projection meets
    ``ternary_min_dim``) is served latent, with ``repro``'s warning."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if not packed:
        return cfg, LM(cfg, dev).init(gen)
    params = pack_params(LM(cfg, dev).init(
        gen, layer_fn=lambda bp: pack_params(bp, cfg)), cfg)
    if count_packed(params):
        cfg = dataclasses.replace(cfg, quantization="ternary_packed")
    else:
        print(f"warning: --packed converted nothing (quantization="
              f"{cfg.quantization!r}, no projection meets "
              f"ternary_min_dim={cfg.ternary_min_dim}); serving the "
              f"dense model", file=sys.stderr)
    return cfg, params


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="ternary-paper")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous mode: the cache pool's slots")
    ap.add_argument("--batch", type=int, default=4,
                    help="--static: the static batch size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-lens", default="32",
                    help="comma list; per-request budgets drawn uniformly")
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache capacity (0: prompt + max(gen-lens) + 1, "
                         "+ spec-k with --spec, + the vision rows of a "
                         "VLM); a prompt that overflows it raises")
    ap.add_argument("--static", action="store_true",
                    help="the static-batch server (whole batches, each "
                         "finishing its budget before the next) on the same "
                         "workload, the A/B reference")
    ap.add_argument("--cache", default="dense", choices=("dense", "paged"),
                    help="KV cache: dense slot rows, or the paged "
                         "block-table pool")
    ap.add_argument("--page-size", type=int, default=16,
                    help="--cache paged: tokens per KV page")
    ap.add_argument("--pages", type=int, default=0,
                    help="--cache paged: page-pool capacity incl. the "
                         "trash page (0: slots*ceil(max_len/page_size)+1)")
    ap.add_argument("--kv-dtype", default="", choices=("", "int8"),
                    help="--cache paged: int8 pages with per-row scales "
                         "(default: the config's cache dtype)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="--cache paged: no shared-prefix page reuse")
    ap.add_argument("--paged-attn", default=None,
                    choices=("auto", "jax", "pallas"),
                    help="--cache paged: the decode-attention row (default: "
                         "the config's paged_attn_impl; auto = B5 on the "
                         "card, the gather on the CPU; jax = the gather and "
                         "the dense decode's attention lines)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help=">=0: stop a request early on this token "
                         "(continuous mode)")
    ap.add_argument("--spec", default="off",
                    choices=("off", "resparsify", "layer_skip"),
                    help="speculative decoding draft: resparsify = the "
                         "packed weights re-ternarized at --draft-sparsity "
                         "(needs --packed), layer_skip = a prefix of the "
                         "layers + the shared lm head. The tokens stay "
                         "those of --spec off")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="--spec: draft tokens proposed (and verified) a "
                         "round; a slot emits 1..k+1 tokens a round")
    ap.add_argument("--draft-sparsity", type=float, default=0.125,
                    help="--spec resparsify: the draft's nnz fraction")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="--spec layer_skip: the draft's depth (0: half "
                         "the layers)")
    ap.add_argument("--packed", action="store_true",
                    help="quantize+pack ternarizable projections into the "
                         "Dense2Bit serving format before load")
    ap.add_argument("--ternary-min-dim", type=int, default=0,
                    help=">0: override cfg.ternary_min_dim (reduced configs "
                         "need ~64 for --packed to convert anything)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="chunked prefill + SLO-aware admission: prompts "
                         "stream in --chunk-tokens a step beside decode, "
                         "so a long prompt never holds a whole step")
    ap.add_argument("--chunk-tokens", type=int, default=32,
                    help="--chunked-prefill: most prompt tokens one request "
                         "prefills a step (windows round down to powers of "
                         "two, one captured graph a width)")
    ap.add_argument("--step-token-budget", type=int, default=0,
                    help="--chunked-prefill: model-forward tokens a step, "
                         "decode charged first (0: slots + chunk-tokens)")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help=">0: the interactive class's TTFT objective; "
                         "admission orders by (priority, deadline) and "
                         "deadline-pressed prefills take more of a step")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0,
                    help=">0: the interactive class's TPOT objective; the "
                         "prefill share halves when steps run over it")
    ap.add_argument("--traffic", default="off",
                    choices=("poisson", "bursty", "off"),
                    help="drive the engine open-loop from a seeded arrival "
                         "schedule instead of submit-all-then-drain; "
                         "requests split 3:1 between the interactive and "
                         "batch classes")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="--traffic: mean offered load, requests a second")
    ap.add_argument("--chaos", action="store_true",
                    help="arm the seeded fault injector (NaN logits, "
                         "forced page OOM, slow steps, draft failures at "
                         "modest rates; seeded from --seed): quarantined "
                         "requests replay to the tokens of a fault-free "
                         "run")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help=">0: per-request wall-clock deadline; expired "
                         "requests are cancelled (queued or live) and "
                         "drain failed with reason 'deadline'")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="quarantine replays a request may take before it "
                         "ends failed (reason 'nan_logits')")
    ap.add_argument("--trace", default="",
                    help="write a Perfetto-loadable Chrome trace-event JSON "
                         "of the run: per-request lifecycle tracks, prefill "
                         "and decode-step spans, per-step scheduler "
                         "counters; analyse with scripts/trace_report.py")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="--trace: ring capacity in events; the oldest "
                         "events drop first and the file records how many")
    ap.add_argument("--mesh", default="",
                    help="continuous mode: 'dp,tp' (or bare 'tp') — dp "
                         "engine replicas, each tensor-parallel over tp "
                         "ranks, behind the prefix-affinity Router. Needs "
                         "dp*tp devices")
    ap.add_argument("--mesh-devices", default="",
                    help="--mesh: comma-separated devices, one per rank "
                         "(default: every card, or the one CPU with "
                         "--device cpu); a device may repeat")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    overrides = ({"ternary_min_dim": args.ternary_min_dim}
                 if args.ternary_min_dim > 0 else {})
    cfg = get_config(args.arch, reduced=args.reduced, **overrides)
    gen_lens = [int(g) for g in args.gen_lens.split(",")]
    spec_headroom = args.spec_k if args.spec != "off" else 0
    # a VLM's vision rows share the cache with the text (repro's default
    # leaves them out and its prefill then rolls the cache; ROADMAP C14)
    front = cfg.frontend_seq if cfg.family == "vlm" else 0
    max_len = args.max_len or (args.prompt_len + max(gen_lens) + 1
                               + spec_headroom + front)
    prompts, gens, extras = build_workload(cfg, args.requests,
                                           args.prompt_len, gen_lens,
                                           seed=args.seed)
    cfg, params = build_params(cfg, args.seed, device, args.packed)
    if args.static:
        if args.mesh:
            raise SystemExit("--mesh is a continuous-engine feature; "
                             "drop --static")
        if args.chunked_prefill or args.traffic != "off":
            raise SystemExit("--chunked-prefill/--traffic drive the "
                             "continuous engine; drop --static")
        if args.trace:
            raise SystemExit("--trace instruments the continuous engine; "
                             "drop --static")
        server = BatchedServer(cfg, max_len, device)
        server.load(params)
        _, metrics = run_static(server, prompts, gens, args.batch,
                                extras=extras)
        print(json.dumps(metrics))
        return metrics
    tracer = Tracer(capacity=args.trace_buffer) if args.trace else None
    # SLO classes: the interactive class carries the CLI's objectives,
    # batch requests ride priority 1
    slo_on = (args.chunked_prefill or args.slo_ttft_ms > 0
              or args.slo_tpot_ms > 0 or args.traffic != "off")
    interactive = SLOClass(
        "interactive",
        ttft_target_s=(args.slo_ttft_ms / 1e3 if args.slo_ttft_ms > 0
                       else 0.5),
        tpot_target_s=(args.slo_tpot_ms / 1e3 if args.slo_tpot_ms > 0
                       else 0.1),
        priority=0)
    batch_cls = SLOClass("batch", priority=1)
    spec = None
    if args.spec != "off":
        spec = SpecConfig(draft=args.spec, k=args.spec_k,
                          draft_sparsity=args.draft_sparsity,
                          draft_layers=args.draft_layers)
    faults = None
    if args.chaos:
        # repro's rates (draft failures act on --spec runs only)
        faults = FaultConfig(seed=args.seed, nan_rate=0.05, oom_rate=0.05,
                             slow_rate=0.02, slow_s=0.01,
                             draft_fail_rate=0.05)
    resilience = ResilienceConfig(
        deadline_s=args.deadline_s if args.deadline_s > 0 else None,
        max_retries=args.max_retries)
    sched = None
    if slo_on:
        sched = SchedConfig(
            chunk_tokens=args.chunk_tokens if args.chunked_prefill else 0,
            step_token_budget=args.step_token_budget)
    def build_engine(mesh=None):
        # ranks sharing a card talk over gloo, whose steps are not
        # captured (the engine raises on cuda_graph there)
        eng = ContinuousScheduler(
            cfg, max_slots=args.slots, max_len=max_len,
            eos_id=args.eos_id if args.eos_id >= 0 else None,
            cache=args.cache, page_size=args.page_size, n_pages=args.pages,
            kv_dtype=args.kv_dtype or None,
            prefix_cache=not args.no_prefix_cache,
            paged_attn=args.paged_attn, sched=sched, spec=spec,
            faults=faults, resilience=resilience,
            device=device if mesh is None else None, tracer=tracer,
            cuda_graph=mesh is None or mesh.tp == 1
            or mesh.backend == "nccl", mesh=mesh)
        eng.load(params)
        return eng

    if args.mesh:
        if args.traffic != "off":
            raise SystemExit("--traffic drives a single engine open-loop; "
                             "drop --mesh")
        dp, tp = tp_lib.parse_mesh(args.mesh)
        devices = ([d.strip() for d in args.mesh_devices.split(",")
                    if d.strip()] if args.mesh_devices
                   else None if device.type == "cuda" else [str(device)])
        meshes = tp_lib.replica_meshes(dp, tp, devices)
        engines = [build_engine(m) for m in meshes]
        engine = Router(engines)
    else:
        engines = [build_engine()]
        engine = engines[0]
    try:
        metrics = _drive(engine, args, cfg, prompts, gens, interactive,
                         batch_cls, slo_on)
    finally:
        for eng in engines:
            eng.close()
    if tracer is not None:
        n_ev = tracer.export(args.trace)
        print(f"# trace: {args.trace} ({n_ev} events, {tracer.dropped} "
              f"dropped)", file=sys.stderr)
    print(json.dumps(metrics))
    return metrics


def _drive(engine, args, cfg, prompts, gens, interactive, batch_cls,
           slo_on) -> Dict[str, Any]:
    """Run the workload through an engine (or a router): open loop from
    the seeded schedule, or submit everything and drain."""
    if args.traffic != "off":
        tc = TrafficConfig(kind=args.traffic, rate=args.arrival_rate,
                           n_requests=args.requests,
                           prompt_lens=(args.prompt_len,),
                           gen_lens=tuple(int(g) for g in
                                          args.gen_lens.split(",")),
                           seed=args.seed)
        schedule = make_schedule(tc, cfg.vocab_size,
                                 classes=(interactive, batch_cls),
                                 class_weights=(0.75, 0.25))
        return run_open_loop(engine, schedule)[1]
    slo = interactive if slo_on else None
    for p, g in zip(prompts, gens):
        engine.submit(p, g, slo=slo)
    return engine.run()


if __name__ == "__main__":
    main()
