#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``): builds the
six hand-written kernels, holds each serving kernel against its plain
PyTorch version at the serving path's shapes, serves the full-width packed
``ternary-paper`` model through the continuous-batching engine over the
dense slot cache, then over the paged cache with bf16 pages and with int8
pages under page pressure (prefix sharing, copy-on-write, deferrals and
preemptions), and compares the card's logits with the CPU's plain path and
the paged decode step's logits with the dense one's on the same weights.
Then the ``gemm_formats`` phase drives the paper's sparse-GEMM surface
(``weights.pack`` + ``ops.ternary_gemm``) at the paper's sizes: ``tiled``
packs of 4096 x 4096 with 256 x 128 tiles over the paper's sparsities
through the tile-skipping kernels (B2, B3) and the dense one (B1), a K
sweep over the paper's K range, ``bitplane`` packs through B7 in both
modes, and one ``base3`` pack through its plain ``ref`` row (it has no
kernel, in ``repro`` neither).

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
near tie, reported). One decode step after prefilling the same prompts
into a paged pool and into the dense cache gives logits within
5e-2*max|logit| of each other with bf16 pages (the two paths differ only
in sum order on the card; the CPU tests find them bitwise equal) and
within 7e-2*max|logit| with int8 pages: the CPU measures int8 pages at
1.2-1.5% of max|logit| from dense after one step at reduced and at full
width, tests/test_torch_paging.py holds that under 2e-2, and the card's
own rounding gets the 5e-2 above on top. Greedy tokens follow the same
near-tie rule.

In ``gemm_formats`` B2, B3 and B1 on the same tiled pack are held equal
with ``torch.equal`` (the skipping kernels run B1's MMA chunks in B1's
order, minus chunks of empty tiles), each kernel against its plain version
within the kernel bound above, and B7's factorized mode against its
plain mode within the same bound.

Output: progress lines, each serving run's metrics JSON, one
``{"kernels": ...}`` JSON line (each kernel's launches summed over the
runs that use it — the serving runs for B1, B4 and B5, the gemm_formats
run for B2, B3 and B7 — with the per-run counts under ``runs``, and its
error and times summed over the shapes its path gives it, with the
per-shape detail under ``shapes``), the card's name and power limit as
nvidia-smi prints them, and the final ``{"ok": true, "device": ...}`` line.
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
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores
KERNEL_RTOL = 1e-2
LOGIT_TOL = 5e-2
INT8_LOGIT_TOL = 7e-2
SEED = 0

SERVE = dict(requests=16, slots=8, prompt_len=128, gen_lens=(32, 64))
PAGE_SIZE = 16
# 16 requests of 120-token prompts sharing a 64-token prefix, identical in
# pairs. Full occupancy without sharing needs 8 x 12 = 96 pages, but the
# sharing keeps this workload's peak at 56 (the page counts depend only on
# prompts and budgets), so a 64-page pool never defers or preempts: 40
# pages (39 usable) make it do both.
PRESSURE = dict(requests=16, slots=8, prompt_len=120, prefix_len=64,
                gen_lens=(32, 64), n_pages=40)
# paged attention at the serving shape: 8 rows of up to 193 tokens in
# 13 pages of 16 each, 16 heads (no GQA in ternary-paper), hd 64
PAGED = dict(b=8, h=16, kv=16, hd=64, t=13, max_len=193)
GEMM_SHAPES = [(m, k, n) for m in (8, 1024)
               for k, n in ((1024, 1024), (1024, 32768))]
MLP_SHAPES = [(m, 1024, 4096, 1024) for m in (8, 1024)]
# the paper-size sparse-GEMM surface (benchmarks/kernel_bench.py's
# sparsity_skip acceptance shape and tile)
FORMATS = dict(k=4096, n=4096, tile_k=256, tile_n=128, ms=(8, 1024),
               bitplane_sparsities=(0.5, 0.0625), sweep_m=1024,
               sweep_sparsity=0.125, base3=(8, 1024, 1024))


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


def bound_ms(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def paged_kernel_phase(flush):
    """B5 against its plain version at the serving shape, bf16 and int8
    pages: ragged lengths from the seeded generator, each row's pages
    distinct, table entries past each length garbage."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.paging import Int8Pages
    from repro_torch.paging import kernels as paged_lib

    b, h, kv, hd, t = (PAGED[k] for k in ("b", "h", "kv", "hd", "t"))
    ps, n_pages = PAGE_SIZE, PAGED["b"] * PAGED["t"] + 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q = torch.randn(b, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(n_pages, ps, kv, hd, generator=gen, device="cuda")
    v = torch.randn(n_pages, ps, kv, hd, generator=gen, device="cuda")
    lengths = torch.randint(1, PAGED["max_len"] + 1, (b,), generator=gen,
                            device="cuda", dtype=torch.int32)
    table = torch.randint(0, n_pages, (b, t), generator=gen, device="cuda",
                          dtype=torch.int32)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
            ).to(torch.int32)
    for row, n in enumerate(lengths.tolist()):
        used = -(-n // ps)
        table[row, :used] = perm[row * t:row * t + used]
    valid = int(lengths.sum())
    pos = torch.arange(t * ps, device="cuda")
    mask = (pos < lengths[:, None])[:, None, None, :]       # (B, 1, 1, S)
    rows = []
    for label in ("bf16", "int8"):
        if label == "int8":
            kp, vp = Int8Pages.quantize(k), Int8Pages.quantize(v)
        else:
            kp, vp = k.to(torch.bfloat16), v.to(torch.bfloat16)
        args = (q, kp, vp, table, lengths)
        got = ops.paged_decode_attention(*args)
        ref = paged_lib.paged_decode_attention_ref(*args)
        err = check_close(f"paged_decode_attention {label} pages", got, ref)
        # yardstick: SDPA over K/V gathered (and dequantized) beforehand
        ks, vs = (paged_lib.gather_pages(pg, table, torch.bfloat16)
                  .transpose(1, 2).contiguous() for pg in (kp, vp))
        qs = q[:, :, None]
        iters = 50
        row = {
            "pages": label, "b": b, "h": h, "kv": kv, "hd": hd, "ps": ps,
            "t": t, "valid_tokens": valid, "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.paged_decode_attention(*args), iters,
                          flush),
            "plain_ms": cuda_ms(
                lambda: paged_lib.paged_decode_attention_ref(*args), iters,
                flush),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), iters, flush),
        }
        # K and V of the valid tokens read once (+ their scales), q and o,
        # the table and the lengths
        per_token = 2 * kv * (hd + 4 if label == "int8" else 2 * hd)
        nbytes = valid * per_token + 2 * b * h * hd * 2 + b * t * 4 + b * 4
        ops_needed = 4.0 * valid * h * hd             # q.k and p.v, f32
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops_needed,
                                                    F32_OPS_PER_S)
        rows.append(row)
        print(f"paged_decode_attention {label} pages: " + json.dumps(row),
              flush=True)
    return rows


def _counters():
    """Kernel name -> (wrapper, attribute holding its launch count)."""
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ternary_gemm as gemm_lib
    from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib
    from repro_torch.paging import kernels as paged_lib
    return {"ternary_gemm": (gemm_lib.ternary_gemm_cuda, "launches"),
            "fused_mlp": (fused_lib.fused_mlp_cuda, "launches"),
            "paged_decode_attention": (
                paged_lib.paged_decode_attention_cuda, "launches"),
            "ternary_gemm_skip": (gemm_lib.ternary_gemm_skip_cuda,
                                  "launches"),
            "ternary_gemm_skip_db": (gemm_lib.ternary_gemm_skip_cuda,
                                     "launches_db"),
            "ternary_gemm_bitplane": (
                bitplane_lib.ternary_gemm_bitplane_cuda, "launches")}


def _zero_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def serve_run(label, cfg, params, prompts, gens, max_len, **engine_kw):
    """Drain one workload through the continuous engine on the card; the
    launch counters are set to 0 just before the run and read just
    after. Checks every request drained with its full budget of in-range
    token ids."""
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler

    engine = ContinuousScheduler(cfg, max_slots=SERVE["slots"],
                                 max_len=max_len, device="cuda", **engine_kw)
    engine.load(params)
    _zero_counts()
    outs, metrics = serve.run_continuous(engine, prompts, gens)
    launches = _read_counts()

    brief = {k: v for k, v in metrics.items() if k != "per_request"}
    print(f"{label} serving metrics: " + json.dumps(brief), flush=True)
    print(f"{label} serving launches: {json.dumps(launches)}", flush=True)
    if metrics["drained"] != len(gens):
        raise AssertionError(f"{label}: drained {metrics['drained']} of "
                             f"{len(gens)} requests")
    for i, (toks, g) in enumerate(zip(outs, gens)):
        if len(toks) != g or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label}: request {i}: {len(toks)} tokens "
                                 f"for a budget of {g}, or ids out of range")
    for name in ("ternary_gemm", "fused_mlp"):
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} kernel never launched")
    paged = engine_kw.get("cache") == "paged"
    want = cfg.num_layers * metrics["decode_steps"] if paged else 0
    if launches["paged_decode_attention"] != want:
        raise AssertionError(
            f"{label}: paged_decode_attention launched "
            f"{launches['paged_decode_attention']} times, expected {want} "
            f"({cfg.num_layers} layers x {metrics['decode_steps']} decode "
            f"steps)")
    return outs, metrics, launches


def serve_phase():
    """Full-width packed ternary-paper through the continuous engine; the
    launch counters are zeroed just before the run and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

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
    outs, _, launches = serve_run("dense", cfg, params, prompts, gens,
                                  max_len)
    return cfg, params, prompts, gens, max_len, outs, launches


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
    _compare_logits(f"model check, card vs CPU plain path "
                    f"({time.perf_counter() - t0:.1f}s on the CPU)",
                    cpu[:, -1], card[:, -1], LOGIT_TOL)


def _compare_logits(what, ref, got, tol):
    """max |got - ref| <= tol * max|ref| for (B, V) logits, finite, and
    each row's greedy token equal unless ref's top-2 lie within that bound
    (a near tie, reported). Returns the rows whose tokens agree."""
    import torch
    ref, got = ref.float().cpu(), got.float().cpu()
    diff = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = ref.argmax(-1) == got.argmax(-1)
    print(f"{what}: max|d logit| = {diff:.4g} ({diff / scale:.4g} of "
          f"max|logit| {scale:.4g}, bound {tol}); greedy tokens agree on "
          f"{int(agree.sum())}/{len(agree)} rows", flush=True)
    if not bool(torch.isfinite(got).all()) or diff > tol * scale:
        raise AssertionError(f"{what}: logits differ by {diff} > {tol} * "
                             f"{scale}")
    for row in torch.nonzero(~agree).flatten().tolist():
        if float(margin[row]) > tol * scale:
            raise AssertionError(f"{what}: row {row} greedy token differs "
                                 f"with a top-2 margin of "
                                 f"{float(margin[row])}")
        print(f"{what}: row {row} differs on a near tie (margin "
              f"{float(margin[row]):.4g})", flush=True)
    return int(agree.sum())


def paged_step_check(what, cfg, params, prompts, max_len, kv_dtype, tol):
    """Prefill the same prompts into the dense cache and into a paged pool
    on the card, run one decode step in each from the same next tokens,
    and compare the logits."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.paging import PagePool

    model = LM(cfg, "cuda")
    b, s = prompts.shape
    toks = torch.as_tensor(prompts, device="cuda")
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        with ops.serving_phase("prefill"):
            cache, logits = model.prefill(params, {"tokens": toks}, max_len)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        with ops.serving_phase("decode"):
            dense, _ = model.decode_step(
                params, {"layers": cache["layers"], "pos": pos}, nxt)
        del cache
        pool = PagePool(model, b, max_len, page_size=PAGE_SIZE,
                        kv_dtype=kv_dtype)
        adms = [pool.admit(p) for p in prompts]
        if [a.slot for a in adms] != list(range(b)):
            raise AssertionError("the pool's slots do not follow the rows")
        with ops.serving_phase("prefill"):
            pcache, _ = model.prefill(params, {"tokens": toks},
                                      -(-s // PAGE_SIZE) * PAGE_SIZE)
        pool.insert(adms, pcache["layers"])
        del pcache
        for a in adms:
            if not pool.ensure_append(a.slot, s):
                raise AssertionError("a default-size pool ran dry")
        table = torch.tensor(pool.table, device="cuda")
        with ops.serving_phase("decode"):
            paged, _ = model.decode_step(
                params, {"layers": pool.layers, "pos": pos,
                         "block_table": table}, nxt)
    return _compare_logits(what, dense[:, 0], paged[:, 0], tol)


def pressure_workload(cfg):
    """The int8 pressure run's prompts: a 64-token prefix common to all,
    a 56-token tail shared by each adjacent pair (so twins share their
    partial tail page and copy it on their first write); budgets drawn
    from {32, 64}."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    n, plen = PRESSURE["requests"], PRESSURE["prompt_len"]
    common = rng.integers(0, cfg.vocab_size, size=PRESSURE["prefix_len"])
    tails = rng.integers(0, cfg.vocab_size,
                         size=(n // 2, plen - PRESSURE["prefix_len"]))
    prompts = np.stack([np.concatenate([common, tails[i // 2]])
                        for i in range(n)]).astype(np.int32)
    gens = [int(g) for g in rng.choice(PRESSURE["gen_lens"], size=n)]
    return prompts, gens


def paged_phases(cfg, params, prompts, gens, max_len, dense_outs):
    """Paged serving with bf16 pages on the dense run's workload, then with
    int8 pages under pressure; each followed by the one-step logit check
    against the dense cache. Returns the per-run launch counts."""
    import numpy as np
    outs, _, bf16_launches = serve_run(
        "paged bf16", cfg, params, prompts, gens, max_len, cache="paged",
        page_size=PAGE_SIZE)
    same = sum(np.array_equal(a, b) for a, b in zip(outs, dense_outs))
    print(f"paged bf16: {same}/{len(outs)} token streams equal the dense "
          f"run's (information, not a gate)", flush=True)
    runs = {"paged_bf16": bf16_launches}
    paged_step_check("paged bf16 vs dense, one decode step", cfg, params,
                     prompts[:SERVE["slots"]], max_len, None, LOGIT_TOL)

    p_prompts, p_gens = pressure_workload(cfg)
    p_max_len = PRESSURE["prompt_len"] + max(PRESSURE["gen_lens"]) + 1
    _, pm, runs["paged_int8"] = serve_run(
        "paged int8 under pressure", cfg, params, p_prompts, p_gens,
        p_max_len, cache="paged", page_size=PAGE_SIZE,
        n_pages=PRESSURE["n_pages"], kv_dtype="int8")
    cache = pm["cache"]
    if not (cache["prefix"]["hits"] > 0 and cache["cow_copies"] > 0
            and cache["deferrals"] + cache["preemptions"] > 0):
        raise AssertionError(f"the pressure run did not share prefixes, "
                             f"copy on write and defer or preempt: {cache}")
    paged_step_check("paged int8 vs dense, one decode step", cfg, params,
                     p_prompts[:SERVE["slots"]], p_max_len, "int8",
                     INT8_LOGIT_TOL)
    return runs


def _tiled_pack(rng_seed, k, n, sparsity, scale):
    """A tile-structured ``tiled`` pack drawn as kernel_bench draws it,
    packed on the card."""
    import numpy as np
    import torch
    from repro_torch.core import formats, weights
    t = formats.random_tile_ternary(np.random.default_rng(rng_seed), k, n,
                                    FORMATS["tile_k"], FORMATS["tile_n"],
                                    sparsity)
    return weights.pack(torch.from_numpy(t).cuda(), "tiled", scale=scale,
                        tile_k=FORMATS["tile_k"], tile_n=FORMATS["tile_n"])


def _effective(w):
    """Pre-decoded, pre-scaled bf16 weights for the library yardstick."""
    import torch
    return w.materialize(torch.float32, with_scale=True).to(torch.bfloat16)


def gemm_formats_phase(flush):
    """The paper's sparse-GEMM surface at the paper's sizes. First the
    path run: with every launch count set to 0, ``ops.ternary_gemm`` (auto
    and each kernel row) over every pack and M; the counts are read just
    after. Then each output is checked and each kernel timed (launches
    that compare or time do not count). Returns (per-kernel rows,
    launches of the path run)."""
    import numpy as np
    import torch
    from repro_torch.configs.ternary_paper import (PAPER_K_RANGE,
                                                   PAPER_SPARSITIES)
    from repro_torch.core import formats, weights
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_gemm as gemm_lib
    from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib

    rng = np.random.default_rng(SEED + 4)
    k, n, tk, tn = (FORMATS[key] for key in ("k", "n", "tile_k", "tile_n"))

    def scale_of(cols):
        return torch.from_numpy(rng.random(cols).astype(np.float32)
                                + 0.5).cuda()

    def act(m, kk):
        return torch.from_numpy(rng.standard_normal((m, kk)).astype(
            np.float32)).cuda().to(torch.bfloat16)

    t0 = time.perf_counter()
    tiled = {s: _tiled_pack(0, k, n, s, scale_of(n))
             for s in PAPER_SPARSITIES}
    sweep = {kk: _tiled_pack(kk, kk, n, FORMATS["sweep_sparsity"],
                             scale_of(n)) for kk in PAPER_K_RANGE}
    planes = {s: weights.pack(torch.from_numpy(formats.random_ternary(
        np.random.default_rng(SEED + 5), k, n, s)).cuda(), "bitplane",
        scale=scale_of(n)) for s in FORMATS["bitplane_sparsities"]}
    bm, bk, bn = FORMATS["base3"]
    base3 = weights.pack(torch.from_numpy(formats.random_ternary(
        rng, bk, bn, 0.25)).cuda(), "base3", scale=scale_of(bn))
    xs = {(m, kk): act(m, kk) for m in FORMATS["ms"] + (FORMATS["sweep_m"],)
          for kk in sorted({k, *PAPER_K_RANGE})}
    x_b3 = act(bm, bk)
    alpha_bias = torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).cuda()
    torch.cuda.synchronize()
    print(f"gemm_formats: packed {len(tiled)} tiled, {len(sweep)} sweep, "
          f"{len(planes)} bitplane and 1 base3 weights on the card in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # ---- the path run ----
    out = {}
    _zero_counts()
    for s, w in tiled.items():
        for m in FORMATS["ms"]:
            x = xs[(m, k)]
            out[("tiled", s, m, "auto")] = ops.ternary_gemm(x, w)
            for impl in ("skip", "skip_db", "dense"):
                out[("tiled", s, m, impl)] = ops.ternary_gemm(x, w,
                                                              impl=impl)
    # one PReLU case with a bias, through the three 2-bit kernels
    w_pr, x_pr = tiled[0.125], xs[(FORMATS["ms"][0], k)]
    for impl in ("skip", "skip_db", "dense"):
        out[("prelu", impl)] = ops.ternary_gemm(
            x_pr, w_pr, bias=alpha_bias, fuse_prelu=True, impl=impl)
    for kk, w in sweep.items():
        x = xs[(FORMATS["sweep_m"], kk)]
        out[("sweep", kk, "auto")] = ops.ternary_gemm(x, w)
        out[("sweep", kk, "dense")] = ops.ternary_gemm(x, w, impl="dense")
    for s, w in planes.items():
        for m in FORMATS["ms"]:
            x = xs[(m, k)]
            out[("bitplane", s, m, "auto")] = ops.ternary_gemm(x, w)
            out[("bitplane", s, m, "factorized")] = ops.ternary_gemm(
                x, w, impl="bitplane_factorized")
    out["base3"] = ops.ternary_gemm(x_b3, base3)
    torch.cuda.synchronize()
    launches = _read_counts()
    print(f"gemm_formats launches: {json.dumps(launches)}", flush=True)
    for name in ("ternary_gemm_skip", "ternary_gemm_skip_db",
                 "ternary_gemm_bitplane", "ternary_gemm"):
        if launches[name] <= 0:
            raise AssertionError(f"gemm_formats: {name} never launched")

    # ---- checks and times ----
    rows = {"ternary_gemm_skip": [], "ternary_gemm_skip_db": [],
            "ternary_gemm_bitplane": [], "k_sweep": []}

    def skip_plain(x, w, **kw):
        return gemm_lib.ternary_gemm_skip_ref(
            x, w.packed, w.kt_indices, w.kt_counts, w.scale, kw.get("bias"),
            n=w.n, tile_k=w.tile_k, tile_n=w.tile_n,
            fuse_prelu=kw.get("fuse_prelu", False))

    def tiled_bound(x, w, m):
        words = w.occupied_tiles * (w.tile_k // 16) * w.tile_n * 4
        meta = (w.kt_indices.numel() + w.kt_counts.numel()) * 4
        nbytes = (m * w.k * 2 + words + meta + w.n * 4 + m * w.n * 2)
        return bound_ms(nbytes, 2.0 * m * w.nnz)

    def equal3(label, ys):
        for impl in ("skip", "skip_db"):
            if not torch.equal(ys[impl], ys["dense"]):
                d = float((ys[impl].float() - ys["dense"].float()).abs()
                          .max())
                raise AssertionError(f"{label}: {impl} != dense bitwise "
                                     f"(max |d| = {d})")

    for s, w in tiled.items():
        for m in FORMATS["ms"]:
            x = xs[(m, k)]
            label = f"tiled s={s} M={m} K={k} N={n}"
            plan = ops.ternary_gemm_plan(w, m).impl
            want = "dense" if w.occupancy() > ops.SKIP_OCCUPANCY_CUTOFF \
                else "skip_db"
            if plan != want or (s == 0.5) != (plan == "dense"):
                raise AssertionError(f"{label}: auto planned {plan!r}, "
                                     f"occupancy {w.occupancy()}")
            ys = {impl: out[("tiled", s, m, impl)]
                  for impl in ("skip", "skip_db", "dense")}
            equal3(label, ys)
            if not torch.equal(out[("tiled", s, m, "auto")], ys[plan]):
                raise AssertionError(f"{label}: auto != {plan}")
            ref = skip_plain(x, w)
            errs = {impl: check_close(f"{label} {impl}", ys[impl], ref)
                    for impl in ys}
            w_eff = _effective(w)
            iters = 20
            times = {impl: cuda_ms(lambda i=impl: ops.ternary_gemm(
                x, w, impl=i), iters, flush)
                for impl in ("skip", "skip_db", "dense")}
            plain_ms = cuda_ms(lambda: skip_plain(x, w), 5, flush)
            library_ms = cuda_ms(lambda: torch.matmul(x, w_eff), iters,
                                 flush)
            b_ms, b_by = tiled_bound(x, w, m)
            common = {"sparsity": s, "m": m, "k": k, "n": n,
                      "tile": [w.tile_k, w.tile_n], "auto": plan,
                      "occupancy": w.occupancy(),
                      "tiles": {"occupied": w.occupied_tiles,
                                "visited": w.visited_tiles(),
                                "total": w.total_tiles()},
                      "dense_ms": times["dense"], "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "dense_equal": True}
            for name, impl in (("ternary_gemm_skip", "skip"),
                               ("ternary_gemm_skip_db", "skip_db")):
                rows[name].append({**common, "ms": times[impl],
                                   "max_abs_err": errs[impl]})
            print(f"{label}: auto={plan} skip==skip_db==dense; "
                  + json.dumps({**common, "skip_ms": times["skip"],
                                "skip_db_ms": times["skip_db"],
                                "max_abs_err": errs}), flush=True)

    ys = {impl: out[("prelu", impl)] for impl in ("skip", "skip_db", "dense")}
    equal3("tiled PReLU+bias", ys)
    err = check_close("tiled PReLU+bias", ys["skip"], skip_plain(
        x_pr, w_pr, bias=alpha_bias, fuse_prelu=True))
    print(f"tiled s=0.125 M={x_pr.shape[0]} with bias and PReLU: "
          f"skip==skip_db==dense, max_abs_err {err}", flush=True)

    for kk, w in sweep.items():
        x = xs[(FORMATS["sweep_m"], kk)]
        label = (f"K sweep K={kk} N={n} M={x.shape[0]} "
                 f"s={FORMATS['sweep_sparsity']}")
        got, dense = out[("sweep", kk, "auto")], out[("sweep", kk, "dense")]
        if ops.ternary_gemm_plan(w, x.shape[0]).impl != "skip_db":
            raise AssertionError(f"{label}: auto did not plan skip_db")
        if not torch.equal(got, dense):
            raise AssertionError(f"{label}: skip_db != dense bitwise")
        err = check_close(label, got, skip_plain(x, w))
        w_eff = _effective(w)
        iters = 10
        row = {"k": kk, "n": n, "m": x.shape[0],
               "sparsity": FORMATS["sweep_sparsity"],
               "occupancy": w.occupancy(), "max_abs_err": err,
               "skip_db_ms": cuda_ms(lambda: ops.ternary_gemm(x, w), iters,
                                     flush),
               "dense_ms": cuda_ms(lambda: ops.ternary_gemm(
                   x, w, impl="dense"), iters, flush),
               "library_ms": cuda_ms(lambda: torch.matmul(x, w_eff), iters,
                                     flush)}
        row["bound_ms"], row["bound_by"] = tiled_bound(x, w, x.shape[0])
        rows["k_sweep"].append(row)
        print(f"{label}: skip_db==dense; " + json.dumps(row), flush=True)

    for s, w in planes.items():
        for m in FORMATS["ms"]:
            x = xs[(m, k)]
            label = f"bitplane s={s} M={m} K={k} N={n}"
            if ops.ternary_gemm_plan(w, m).impl != "bitplane":
                raise AssertionError(f"{label}: auto did not plan bitplane")
            got = out[("bitplane", s, m, "auto")]
            fact = out[("bitplane", s, m, "factorized")]
            args = (x, w.plus, w.minus, w.scale)
            err = check_close(label, got,
                              bitplane_lib.ternary_gemm_bitplane_ref(*args))
            err_f = check_close(f"{label} factorized", fact,
                                bitplane_lib.ternary_gemm_bitplane_ref(
                                    *args, factorized=True))
            check_close(f"{label} factorized vs plain mode", fact, got)
            w_eff = _effective(w)
            iters = 20
            row = {"sparsity": s, "m": m, "k": k, "n": n,
                   "max_abs_err": max(err, err_f),
                   "ms": cuda_ms(lambda: ops.ternary_gemm(x, w), iters,
                                 flush),
                   "factorized_ms": cuda_ms(lambda: ops.ternary_gemm(
                       x, w, impl="bitplane_factorized"), iters, flush),
                   "plain_ms": cuda_ms(
                       lambda: bitplane_lib.ternary_gemm_bitplane_ref(*args),
                       5, flush),
                   "library_ms": cuda_ms(lambda: torch.matmul(x, w_eff),
                                         iters, flush)}
            nbytes = (m * k * 2 + 2 * w.plus.numel() + n * 4 + m * n * 2)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes,
                                                        2.0 * m * w.nnz)
            rows["ternary_gemm_bitplane"].append(row)
            print(f"{label}: " + json.dumps(row), flush=True)

    ref = (x_b3.float() @ base3.materialize(torch.float32, with_scale=True)
           ).to(torch.bfloat16)
    err = check_close("base3", out["base3"], ref)
    print(f"base3 M={bm} K={bk} N={bn}: no kernel (ref in repro too); its "
          f"plain ref row ran on the card, max_abs_err {err}", flush=True)
    print(f"gemm_formats took {time.perf_counter() - t0:.1f}s", flush=True)
    return rows, launches


def main() -> int:
    start = time.perf_counter()
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
    shapes["paged_decode_attention"] = paged_kernel_phase(flush)
    del flush
    cfg, params, prompts, gens, max_len, dense_outs, launches = serve_phase()
    model_phase(cfg, params, prompts, max_len)
    runs = {"dense": launches}
    runs.update(paged_phases(cfg, params, prompts, gens, max_len,
                             dense_outs))
    del params
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    format_rows, format_launches = gemm_formats_phase(flush)
    del flush
    k_sweep = format_rows.pop("k_sweep")
    shapes.update(format_rows)

    meta = {
        "ternary_gemm": ("src/repro_torch/kernels/csrc/ternary_gemm.cu",
                         "src/repro/kernels/ternary_gemm.py:148"),
        "fused_mlp": ("src/repro_torch/kernels/csrc/fused_mlp.cu",
                      "src/repro/kernels/fused_mlp.py:187"),
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/paging/kernels.py:189"),
        "ternary_gemm_skip": (
            "src/repro_torch/kernels/csrc/ternary_gemm_skip.cu",
            "src/repro/kernels/ternary_gemm.py:251"),
        "ternary_gemm_skip_db": (
            "src/repro_torch/kernels/csrc/ternary_gemm_skip.cu",
            "src/repro/kernels/ternary_gemm.py:413"),
        "ternary_gemm_bitplane": (
            "src/repro_torch/kernels/csrc/ternary_gemm_bitplane.cu",
            "src/repro/kernels/ternary_gemm_bitplane.py:85"),
    }
    kernels = []
    for name, rows in shapes.items():
        total = {key: sum(r[key] for r in rows)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        own_runs = ({"gemm_formats": format_launches} if name in format_rows
                    else runs)
        entry = {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(run[name] for run in own_runs.values()),
            "runs": {label: run[name] for label, run in own_runs.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            # the kind of bound of the shape that dominates the summed bound
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": total["library_ms"],
            "shapes": rows,
        }
        if name == "ternary_gemm_skip_db":
            entry["k_sweep"] = k_sweep
        kernels.append(entry)
    print(f"chip_smoke took {time.perf_counter() - start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
