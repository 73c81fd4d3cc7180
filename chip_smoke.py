#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``): builds both
hand-written kernels, holds each against its plain PyTorch version at the
serving path's shapes, serves the full-width packed ``ternary-paper`` model
through the continuous-batching engine, and compares the card's logits with
the CPU's plain path on the same weights.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Needs one CUDA device and nvcc (PATH or /usr/local/cuda/bin). Exits
nonzero, and prints no result line, when no CUDA device is present or when
the repository's sources are not beside this file. Every failed phase
raises; nothing is caught and skipped.

Tolerances (bf16 outputs of f32 sums taken in another order than the
plain version's, so a value can round one bf16 ulp, 2^-8, the other way):
each kernel agrees with its plain version within |d| <= 1e-2*|ref| +
1e-2*max|ref|; the last-position logits of a full-width prefill on the
card (kernels) agree with the CPU's (plain versions) within
5e-2*max|ref| — twelve bf16 layers compound those ulps — and the greedy
token agrees unless the CPU's top-2 logits lie closer than that bound (a
near tie, reported).

Output: progress lines, the serving metrics JSON, one ``{"kernels": ...}``
JSON line (each kernel's launches on the serving run, and its error and
times summed over the shapes the serving path gives it, with the per-shape
detail under ``shapes``), the card's name and power limit as nvidia-smi
prints them, and the final ``{"ok": true, "device": ...}`` line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core peak
KERNEL_RTOL = 1e-2
LOGIT_TOL = 5e-2
SEED = 0

SERVE = dict(requests=16, slots=8, prompt_len=128, gen_lens=(32, 64))
GEMM_SHAPES = [(m, k, n) for m in (8, 1024)
               for k, n in ((1024, 1024), (1024, 32768))]
MLP_SHAPES = [(m, 1024, 4096, 1024) for m in (8, 1024)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, flush) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches, each after a
    write of ``flush`` (larger than the 50 MB L2), so weights come from
    device memory as they do when a model's layers take turns."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got, ref) -> float:
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    limit = KERNEL_RTOL * ref.abs() + KERNEL_RTOL * ref.abs().max()
    if not bool(torch.isfinite(got).all()) or bool((err > limit).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max |d| = {float(err.max()):.4g}, "
                             f"max |ref| = {float(ref.abs().max()):.4g}")
    return float(err.max())


def kernel_phase(flush):
    """Each kernel against its plain version at the serving shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import weights
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def packed(k, n):
        # latent weights as LM.init draws them: N(0, 1/k)
        return weights.pack(torch.randn(k, n, generator=gen, device="cuda")
                            / k ** 0.5)

    def phase(m):
        return "decode" if m <= 16 else "prefill"

    results = {"ternary_gemm": [], "fused_mlp": []}
    for m, k, n in GEMM_SHAPES:
        w = packed(k, n)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        with ops.serving_phase(phase(m)):
            got = ops.ternary_gemm(x, w)
            ref = gemm_lib.ternary_gemm_ref(x, w.packed, w.scale)
            err = check_close(f"ternary_gemm M={m} K={k} N={n}", got, ref)
            w_eff = w.materialize(torch.float32, with_scale=True).to(
                torch.bfloat16)
            iters = 20
            row = {
                "m": m, "k": k, "n": n, "max_abs_err": err,
                "ms": cuda_ms(lambda: ops.ternary_gemm(x, w), iters, flush),
                "plain_ms": cuda_ms(lambda: gemm_lib.ternary_gemm_ref(
                    x, w.packed, w.scale), iters, flush),
                "library_ms": cuda_ms(lambda: torch.matmul(x, w_eff), iters,
                                      flush),
            }
        nbytes = m * k * 2 + w.packed.numel() * 4 + n * 4 + m * n * 2
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * m * w.nnz)
        results["ternary_gemm"].append(row)
        print(f"ternary_gemm M={m} K={k} N={n}: " + json.dumps(row),
              flush=True)

    for m, k, ff, n in MLP_SHAPES:
        wi, wg, wo = packed(k, ff), packed(k, ff), packed(ff, n)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        plain_args = (x, wi.packed, wo.packed, wg.packed, wi.scale, None,
                      wg.scale, None, wo.scale, None)
        with ops.serving_phase(phase(m)):
            got = ops.fused_mlp(x, wi, wo, wg)
            ref = fused_lib.fused_mlp_ref(*plain_args)
            err = check_close(f"fused_mlp M={m} K={k} ff={ff} N={n}", got,
                              ref)
            ei, eg, eo = (c.materialize(torch.float32, with_scale=True).to(
                torch.bfloat16) for c in (wi, wg, wo))
            iters = 20
            row = {
                "m": m, "k": k, "ff": ff, "n": n, "max_abs_err": err,
                "ms": cuda_ms(lambda: ops.fused_mlp(x, wi, wo, wg), iters,
                              flush),
                "plain_ms": cuda_ms(lambda: fused_lib.fused_mlp_ref(
                    *plain_args), iters, flush),
                # cuBLAS chain over pre-decoded, pre-scaled bf16 weights
                "library_ms": cuda_ms(
                    lambda: (F.silu(x @ eg) * (x @ ei)) @ eo, iters, flush),
            }
        nbytes = (m * k * 2 + (wi.packed.numel() + wg.packed.numel()
                               + wo.packed.numel()) * 4
                  + (2 * ff + n) * 4 + m * n * 2)
        ops_needed = 2.0 * m * (wi.nnz + wg.nnz + wo.nnz)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops_needed)
        results["fused_mlp"].append(row)
        print(f"fused_mlp M={m} K={k} ff={ff} N={n}: " + json.dumps(row),
              flush=True)
    return results


def serve_phase():
    """Full-width packed ternary-paper through the continuous engine; the
    launch counters are zeroed just before the run and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ternary_gemm as gemm_lib
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler

    cfg = get_config("ternary-paper")
    prompts, gens = serve.build_workload(
        cfg, SERVE["requests"], SERVE["prompt_len"], SERVE["gen_lens"],
        seed=SEED)
    t0 = time.perf_counter()
    cfg, params = serve.build_params(cfg, SEED, "cuda", packed=True)
    print(f"init+pack full-width {cfg.name} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, ff {cfg.d_ff}, vocab {cfg.vocab_size}): "
          f"{serve.count_packed(params)} packed linears in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    max_len = SERVE["prompt_len"] + max(SERVE["gen_lens"]) + 1
    engine = ContinuousScheduler(cfg, max_slots=SERVE["slots"],
                                 max_len=max_len, device="cuda")
    engine.load(params)

    gemm_lib.ternary_gemm_cuda.launches = 0
    fused_lib.fused_mlp_cuda.launches = 0
    outs, metrics = serve.run_continuous(engine, prompts, gens)
    launches = {"ternary_gemm": gemm_lib.ternary_gemm_cuda.launches,
                "fused_mlp": fused_lib.fused_mlp_cuda.launches}

    brief = {k: v for k, v in metrics.items() if k != "per_request"}
    print("serving metrics: " + json.dumps(brief), flush=True)
    print(f"serving launches: {json.dumps(launches)}", flush=True)
    if metrics["drained"] != SERVE["requests"]:
        raise AssertionError(f"drained {metrics['drained']} of "
                             f"{SERVE['requests']} requests")
    for i, (toks, g) in enumerate(zip(outs, gens)):
        if len(toks) != g or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"request {i}: {len(toks)} tokens for a "
                                 f"budget of {g}, or ids out of range")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} kernel never launched while "
                                 f"serving")
    return cfg, params, prompts, max_len, launches


def _tree_to(tree, device):
    import torch
    from repro_torch.core.weights import Dense2Bit
    if isinstance(tree, Dense2Bit):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def model_phase(cfg, params, prompts, max_len):
    """Prefill one prompt with the same weights on the card (kernels) and
    on the CPU (plain versions); compare last-position logits and the
    greedy token."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    toks = torch.as_tensor(prompts[:1])
    with torch.no_grad(), ops.serving_phase("prefill"):
        _, card = LM(cfg, "cuda").prefill(params, {"tokens": toks.cuda()},
                                          max_len)
    t0 = time.perf_counter()
    with torch.no_grad():
        _, cpu = LM(cfg, "cpu").prefill(_tree_to(params, "cpu"),
                                        {"tokens": toks}, max_len)
    card, cpu = card[0, -1].float().cpu(), cpu[0, -1].float()
    diff = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    tok_card, tok_cpu = int(card.argmax()), int(cpu.argmax())
    top2 = cpu.topk(2).values
    margin = float(top2[0] - top2[1])
    print(f"model check (CPU plain path {time.perf_counter() - t0:.1f}s): "
          f"max|d logit| = {diff:.4g}, max|logit| = {scale:.4g}, "
          f"greedy card {tok_card} / cpu {tok_cpu}, cpu top-2 margin "
          f"{margin:.4g}", flush=True)
    if not bool(torch.isfinite(card).all()) or diff > LOGIT_TOL * scale:
        raise AssertionError(f"card logits differ from the CPU's by {diff} "
                             f"> {LOGIT_TOL} * {scale}")
    if tok_card != tok_cpu:
        if margin > LOGIT_TOL * scale:
            raise AssertionError(f"greedy token differs: card {tok_card}, "
                                 f"cpu {tok_cpu}, margin {margin}")
        print("greedy tokens differ on a near tie (within the logit "
              "tolerance)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch sources under {SRC}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    per_source = build.build()
    print(f"built {sorted(per_source)} in {time.perf_counter() - t0:.2f}s "
          f"(parallel nvcc; per source "
          f"{ {k: round(v, 2) for k, v in per_source.items()} })", flush=True)
    for name in build.SOURCES:
        log = (build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    shapes = kernel_phase(flush)
    del flush
    cfg, params, prompts, max_len, launches = serve_phase()
    model_phase(cfg, params, prompts, max_len)

    meta = {
        "ternary_gemm": ("src/repro_torch/kernels/csrc/ternary_gemm.cu",
                         "src/repro/kernels/ternary_gemm.py:148"),
        "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                      "src/repro/kernels/fused_mlp.py:187"),
    }
    kernels = []
    for name, rows in shapes.items():
        total = {key: sum(r[key] for r in rows)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            # the kind of bound of the shape that dominates the summed bound
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": total["library_ms"],
            "shapes": rows,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
