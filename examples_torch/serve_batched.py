"""Continuous-batching serving example on the port: submit a stream of
mixed-length requests to ``repro_torch.serving.ContinuousScheduler``
(queue -> slot pool -> interleaved prefill/decode; on the card the decode
step replays as a CUDA graph) and print per-request TTFT/latency plus
engine throughput. Pass ``--static`` to run the same workload through the
static-batch server for an A/B comparison.

Pass ``--spec`` to run the same engine with self-speculative decoding: a
layer-skip draft proposes ``--spec-k`` tokens per slot per round and the
target verifies them in one multi-token forward — outputs are token-exact
vs the plain engine, and the printed spec block shows the acceptance rate
the draft achieved.

Pass ``--traffic poisson`` (or ``bursty``) to drive the engine open-loop
from a seeded arrival schedule with chunked prefill + SLO-aware admission:
requests split between an interactive class (tight TTFT target, priority
0) and a batch class, prompts stream in ``--chunk-tokens`` per step
alongside decode, and the printed report shows per-class p50/p99 TTFT.

Every mode serves ``get_config(arch, reduced=True)`` with random latent
weights from a seeded generator; the projections of a reduced config lie
below its ``ternary_min_dim``, so they run as plain matmuls, not through
the packed kernels.

Run:  PYTHONPATH=src python examples_torch/serve_batched.py \\
          --arch mixtral-8x22b
      PYTHONPATH=src python examples_torch/serve_batched.py \\
          --arch ternary-paper --spec --spec-k 4
      PYTHONPATH=src python examples_torch/serve_batched.py \\
          --arch ternary-paper --traffic poisson --rate 12
      (add --device cpu to run the plain PyTorch path without a card)
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import (BatchedServer, build_workload,
                                      run_continuous, run_static)
from repro_torch.obs import percentiles
from repro_torch.serving import (ContinuousScheduler, SchedConfig, SLOClass,
                                 TrafficConfig, make_schedule, run_open_loop)


def init_params(model):
    """The served weights: a random latent draw from seed 0 on the model's
    device."""
    return model.init(torch.Generator(device=model.device).manual_seed(0))


def _summary(metrics, outs):
    """The printed metrics (``per_request`` left out) and, returned only,
    each request's tokens in submit order."""
    brief = {k: v for k, v in metrics.items() if k != "per_request"}
    print(json.dumps(brief))
    return dict(brief, outputs=[np.asarray(o).tolist() for o in outs])


def serve_traffic(args, dev):
    """Open-loop demo: chunked prefill + SLO admission under a seeded
    Poisson/bursty arrival schedule, with a per-class latency-percentile
    report."""
    cfg = get_config(args.arch, reduced=True)
    gen_lens = [int(g) for g in args.gen_lens.split(",")]
    interactive = SLOClass("interactive", ttft_target_s=0.5,
                           tpot_target_s=0.1, priority=0)
    batch = SLOClass("batch", ttft_target_s=None, priority=1)
    engine = ContinuousScheduler(
        cfg, max_slots=args.slots,
        max_len=args.prompt_len + max(gen_lens) + 1,
        sched=SchedConfig(chunk_tokens=args.chunk_tokens), device=dev)
    engine.load(init_params(engine.model))
    tc = TrafficConfig(kind=args.traffic, rate=args.rate,
                       n_requests=args.requests,
                       prompt_lens=(args.prompt_len,),
                       gen_lens=tuple(gen_lens), seed=0)
    schedule = make_schedule(tc, cfg.vocab_size,
                             classes=(interactive, batch),
                             class_weights=(0.75, 0.25))
    reqs, metrics = run_open_loop(engine, schedule)
    for name in ("interactive", "batch"):
        p = percentiles([r.ttft_s for r in reqs
                         if r.slo is not None and r.slo.name == name])
        if p:
            print(f"# {name}: n={p['n']} "
                  f"p50_ttft={p['p50'] * 1e3:.1f}ms "
                  f"p99_ttft={p['p99'] * 1e3:.1f}ms")
    t = metrics["traffic"]
    print(f"# {args.traffic} rate={args.rate}/s offered={t['offered_rate']} "
          f"makespan={t['makespan_s']}s "
          f"chunk_steps={metrics['sched']['chunk_steps']}")
    return _summary(metrics, [r.tokens for r in reqs])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-lens", default="4,16")
    ap.add_argument("--static", action="store_true")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding (layer-skip draft; "
                         "token-exact vs the plain engine)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--traffic", default="off",
                    choices=("poisson", "bursty", "off"),
                    help="open-loop arrival schedule + chunked prefill "
                         "with SLO classes")
    ap.add_argument("--rate", type=float, default=12.0,
                    help="--traffic: offered load, requests/second")
    ap.add_argument("--chunk-tokens", type=int, default=16,
                    help="--traffic: prefill chunk size per step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.traffic != "off":
        return serve_traffic(args, dev)

    cfg = get_config(args.arch, reduced=True)
    gen_lens = [int(g) for g in args.gen_lens.split(",")]
    max_len = args.prompt_len + max(gen_lens) + 1 \
        + (args.spec_k if args.spec else 0)
    prompts, gens, extras = build_workload(cfg, args.requests,
                                           args.prompt_len, gen_lens)

    if not args.static and (cfg.is_encdec or cfg.family == "vlm"):
        print(f"# {args.arch} needs per-request encoder/frontend state; "
              "falling back to the static server")
        args.static = True
    if args.static:
        server = BatchedServer(cfg, max_len, dev)
        server.load(init_params(server.model))
        outs, metrics = run_static(server, prompts, gens, args.batch,
                                   extras=extras)
        for i, out in enumerate(outs):
            print(f"req {i}: {len(out)} tokens; sample: {out[:8].tolist()}")
    else:
        spec = None
        if args.spec:
            from repro_torch.spec import SpecConfig
            spec = SpecConfig(draft="layer_skip", k=args.spec_k)
        try:
            engine = ContinuousScheduler(cfg, max_slots=args.slots,
                                         max_len=max_len, spec=spec,
                                         device=dev)
        except ValueError as e:
            # the engine owns the spec-support predicate (rolling-SWA /
            # SSM / opt-layout caches cannot roll back) — fall back rather
            # than duplicating its rules here
            if spec is None:
                raise
            print(f"# --spec unsupported for {args.arch}: {e}")
            spec = None
            engine = ContinuousScheduler(cfg, max_slots=args.slots,
                                         max_len=max_len, device=dev)
        engine.load(init_params(engine.model))
        outs, metrics = run_continuous(engine, prompts, gens)
        for r in sorted(metrics["per_request"], key=lambda r: r["rid"]):
            out = outs[r["rid"]]        # outs is in submit (rid) order
            print(f"req {r['rid']}: {r['gen_len']} tokens, "
                  f"ttft {r['ttft_s']:.3f}s, latency {r['latency_s']:.3f}s; "
                  f"sample: {out[:8].tolist()}")
        if metrics["spec"] is not None:
            s = metrics["spec"]
            print(f"# spec: draft={s['draft']} k={s['k']} "
                  f"acceptance={s['acceptance_rate']} "
                  f"mean_accepted_len={s['mean_accepted_len']}")
    return _summary(metrics, outs)


if __name__ == "__main__":
    main()
