#!/usr/bin/env python3
"""A/B of the port's kernels between checkouts, on one CUDA card, in turns:
B1 (ternary GEMM) and B4 (fused MLP) at the main path's shapes, B2, B3 and
B7 (tile-skipping and bitplane GEMMs) with B1 and cuBLAS on the same packs
at the paper's sizes, B5 (paged decode attention) at the serving shape
and at long rows, and B6 (flash attention) at chip_smoke.py's B6 shapes.

    python3 scripts/torch_kernel_ab.py --tree OLD --tree . --tree . \\
        --tree OLD [--split .] [--out chiprun_out/kernel_ab.json]

Each ``--tree`` is the root of a checkout (its ``chip_smoke.py`` and
``src/``). For each, in the order given, a fresh process builds that
tree's kernels and runs its ``chip_smoke.kernel_phase`` (every B1 and B4
shape of the main path) and its ``chip_smoke.gemm_formats_phase`` (tiled
packs through B2, B3 and B1, the K sweep, bitplane packs through B7 in
both modes), each shape checked against its plain version and timed
with this checkout's ``chip_smoke.cuda_ms`` (CUDA events, L2 flushed
before each launch), whichever tree runs. Then B5 through that
tree's ``ops.paged_decode_attention`` on the same inputs in every tree
(made by this checkout's ``chip_smoke._paged_inputs`` at its ``PAGED`` and
``PAGED_LONG`` shapes, bf16 and int8 pages), beside SDPA on the gathered
K/V, and B6 through that tree's ``flash_attention_cuda`` at this
checkout's ``FLASH_CHECKS`` (causal and full) and ``FLASH_EVAL`` beside
SDPA. The tile-skipping packs (B2, B3, the K sweep), B5 and B6 are timed
twice: as a caller meets them, the host's enqueue time included where the
flush does not cover it, and with the card kept busy while the host
enqueues each call (``cuda_ms(spin=True)``, keys ending in ``_spin``),
the card's time alone; and B3, B2 (s 1/8, M 8 and 1024), B1 through
``ops`` at decode (M 8, K = N 1024), B5 and B6 give the host's time to
issue one call (``host_ms``, calls back to back with no
synchronization). Each tree also counts every opcode of its
B2/B3 library (``cuobjdump -sass``); the counts are compared across
trees. Naming the
parent and the change in turns (parent, change, change, parent) shows the card's
drift beside the change's effect. Prints one line per shape with each
run's kernel ms (B1, B4 and B6: the wrapper called directly, and B1 and
B4 through ``ops`` too; B2, B3, B5, B7: through ``ops``) beside B1's on the same pack and the library call's, and
writes all rows as JSON, with the card's name and power limit.
With ``--split TREE`` it also profiles B4 in TREE at the main path's
shapes (``torch.profiler``, L2 flushed before each call) and prints the
device time of each of its two launches, the fused kernel and the
fixed-order reduce pass over the chunks' f32 partials. Needs one CUDA
device and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import functools, json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import importlib.util
import torch
import torch.nn.functional as F
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch.kernels import build, ops
from repro_torch.paging import Int8Pages
from repro_torch.paging import kernels as paged_lib
build.build(["ternary_gemm", "ternary_gemm_skip", "ternary_gemm_bitplane",
             "fused_mlp", "paged_attention", "flash_attention"])
# every tree is timed by the A/B checkout's cuda_ms, and B5 on its inputs
spec = importlib.util.spec_from_file_location("ab_inputs", sys.argv[1])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
chip_smoke.cuda_ms = ab.cuda_ms
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rows = chip_smoke.kernel_phase(flush)
rows.update(chip_smoke.gemm_formats_phase(flush)[0])
# the same packs again, the card kept busy while the host enqueues each
# call: the times become the card's alone, keys suffixed "_spin"
chip_smoke.cuda_ms = functools.partial(ab.cuda_ms, spin=True)
for name, spun in chip_smoke.gemm_formats_phase(flush)[0].items():
    for row, spun_row in zip(rows[name], spun):
        for key in {"ternary_gemm_skip": ("ms",),
                    "ternary_gemm_skip_db": ("ms",),
                    "k_sweep": ("skip_db_ms", "skip_ms")}.get(name, ()):
            if key in spun_row:
                row[key + "_spin"] = spun_row[key]
# the host's time to issue one call of B3 and of B2 through ops
scale = torch.rand(4096, generator=torch.Generator().manual_seed(1)) + 0.5
w = ab._tiled_pack(0, 4096, 4096, 0.125, scale.cuda())
for m in (8, 1024):
    x = torch.randn(m, 4096, device="cuda").to(torch.bfloat16)
    for name, impl in (("ternary_gemm_skip_db_host", "skip_db"),
                       ("ternary_gemm_skip_host", "skip")):
        rows.setdefault(name, []).append({
            "sparsity": 0.125, "m": m, "k": 4096, "n": 4096,
            "host_ms": ab.host_ms(
                lambda: ops.ternary_gemm(x, w, impl=impl), 200)})
# the host's time to issue one B1 call through ops at decode (planning
# included: the plan memo in a tree that has one)
w = ab._packed_weight(torch.Generator(device="cuda").manual_seed(2), 1024,
                      1024)
x = torch.randn(8, 1024, device="cuda").to(torch.bfloat16)
with ops.serving_phase("decode"):
    rows["ternary_gemm_host"] = [{
        "m": 8, "k": 1024, "n": 1024, "phase": "decode",
        "host_ms": ab.host_ms(lambda: ops.ternary_gemm(x, w), 500)}]
rows["paged_decode_attention"] = []
for name, shape, seed in (("serving", ab.PAGED, ab.SEED + 2),
                          ("long", ab.PAGED_LONG, ab.SEED + 12)):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lo, hi = shape.get("min_len", 1), shape["max_len"]
    q, k, v, lengths, table = ab._paged_inputs(
        gen, shape, lambda: torch.randint(lo, hi + 1, (shape["b"],),
                                          generator=gen, device="cuda",
                                          dtype=torch.int32))
    pos = torch.arange(shape["t"] * ab.PAGE_SIZE, device="cuda")
    mask = (pos < lengths[:, None])[:, None, None, :]
    for label in ("bf16", "int8"):
        if label == "int8":
            kp, vp = Int8Pages.quantize(k), Int8Pages.quantize(v)
        else:
            kp, vp = k.to(torch.bfloat16), v.to(torch.bfloat16)
        args = (q, kp, vp, table, lengths)
        err = chip_smoke.check_close(
            f"B5 {name} {label}", ops.paged_decode_attention(*args),
            paged_lib.paged_decode_attention_ref(*args))
        ks, vs = (paged_lib.gather_pages(pg, table, torch.bfloat16)
                  .transpose(1, 2).contiguous() for pg in (kp, vp))
        rows["paged_decode_attention"].append({
            "shape": name, "pages": label, "max_abs_err": err,
            "ms": ab.cuda_ms(lambda: ops.paged_decode_attention(*args), 100,
                             flush),
            "ms_spin": ab.cuda_ms(
                lambda: ops.paged_decode_attention(*args), 100, flush,
                spin=True),
            "host_ms": ab.host_ms(
                lambda: ops.paged_decode_attention(*args), 200),
            "library_ms": ab.cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], ks, vs, attn_mask=mask), 100, flush)})
# B6 at this checkout's chip_smoke.py B6 shapes, through the tree's wrapper
from repro_torch.kernels import flash_attention as flash_lib
rows["flash_attention"] = []
gen = torch.Generator(device="cuda").manual_seed(ab.SEED + 6)
for (bh, s, hd), causal in [(shape, c) for shape in ab.FLASH_CHECKS
                            for c in (True, False)] + [(ab.FLASH_EVAL, True)]:
    q, k, v = (torch.randn(bh, s, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    call = functools.partial(flash_lib.flash_attention_cuda, q, k, v,
                             causal=causal)
    err = chip_smoke.check_close(f"B6 BH={bh} S={s} hd={hd}", call(),
                                 flash_lib.flash_attention_ref(
                                     q, k, v, causal=causal))
    rows["flash_attention"].append({
        "bh": bh, "s": s, "hd": hd, "causal": causal, "max_abs_err": err,
        "ms": ab.cuda_ms(call, 50, flush),
        "ms_spin": ab.cuda_ms(call, 50, flush, spin=True),
        "host_ms": ab.host_ms(call, 200),
        "library_ms": ab.cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal), 50, flush)})
# every opcode of B2/B3's library, counted (cuobjdump -sass)
rows["sass_ternary_gemm_skip"] = ab.sass_counts(
    build, "ternary_gemm_skip",
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)")
print("AB_ROWS " + json.dumps(rows), flush=True)
"""

SPLIT = r"""
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke
from repro_torch.core import weights
from repro_torch.kernels import ops
gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
out = {}
for m, k, ff, n in chip_smoke.MLP_SHAPES:
    wi, wg, wo = (weights.pack(torch.randn(a, b, generator=gen,
                                           device="cuda") / a ** 0.5)
                  for a, b in ((k, ff), (k, ff), (ff, n)))
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    phase = "decode" if m <= 16 else "prefill"
    iters = 20 if m <= 1024 else 5
    with ops.serving_phase(phase):
        for _ in range(3):
            ops.fused_mlp(x, wi, wo, wg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                ops.fused_mlp(x, wi, wo, wg)
            torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        if "fused_mlp" in ev.key:
            name = "reduce" if "reduce" in ev.key else "fused"
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            times[name] = dev_us / iters / 1e3
    out[f"m={m}"] = times
print("SPLIT " + json.dumps(out), flush=True)
"""


# per kernel: the time keys of its rows (the first is the kernel's own;
# a checkout older than a key prints "-" for it)
TIMES = {"ternary_gemm": ("kernel_ms", "ms"), "fused_mlp": ("kernel_ms", "ms"),
         "ternary_gemm_host": ("host_ms",),
         "ternary_gemm_skip": ("ms", "ms_spin", "kernel_ms", "dense_ms"),
         "ternary_gemm_skip_db": ("ms", "ms_spin", "kernel_ms", "dense_ms"),
         "ternary_gemm_bitplane": ("ms", "factorized_ms", "kernel_ms",
                                   "factorized_kernel_ms"),
         "k_sweep": ("skip_db_ms", "skip_db_ms_spin", "skip_ms",
                     "skip_ms_spin", "dense_ms"),
         "ternary_gemm_skip_db_host": ("host_ms",),
         "ternary_gemm_skip_host": ("host_ms",),
         "paged_decode_attention": ("ms", "ms_spin", "host_ms"),
         "flash_attention": ("ms", "ms_spin", "host_ms")}


# this checkout's chip_smoke.py, whose B5 inputs every tree is timed on
INPUTS = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def fmt_ms(v) -> str:
    return "-" if v is None else f"{v:.5g}"


def shape_key(name: str, row: dict) -> str:
    if name == "paged_decode_attention":
        return f"{name} {row['shape']} {row['pages']}"
    if name == "flash_attention":
        return (f"{name} bh={row['bh']} s={row['s']} hd={row['hd']} "
                f"causal={row['causal']}")
    dims = ("m", "k", "ff", "n") if name == "fused_mlp" else ("m", "k", "n")
    if "sparsity" in row:
        dims = ("sparsity",) + dims
    return name + " " + " ".join(f"{d}={row[d]}" for d in dims)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="checkout root; repeat, in the order to run")
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    ap.add_argument("--split", metavar="TREE",
                    help="profile B4's two launches in this checkout")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("ab_inputs", INPUTS)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    card = ab.card_line()
    print(f"card: {card}", flush=True)
    runs = []
    for i, tree in enumerate(args.tree):
        root = Path(tree).resolve()
        proc = subprocess.run([sys.executable, "-c", RUN, str(INPUTS)],
                              cwd=root, capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("AB_ROWS ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} ({tree}) failed: exit "
                             f"{proc.returncode}")
        rows = json.loads(line[len("AB_ROWS "):])
        runs.append({"tree": tree, "rows": rows})
        print(f"run {i}: {tree} done", flush=True)
    table = {}
    for i, run in enumerate(runs):
        for name, keys in TIMES.items():
            for row in run["rows"].get(name, []):
                if row.get("on_path", True):
                    table.setdefault(shape_key(name, row), []).append(
                        {"run": i, **{k: row.get(k) for k in keys + (
                            "library_ms", "plain_ms", "bound_ms",
                            "max_abs_err")}})
    for key, cells in table.items():
        keys = TIMES[key.split(" ")[0]] + ("library_ms",)
        print(key + ": " + "; ".join(
            k + " " + " / ".join(fmt_ms(c[k]) for c in cells)
            for k in keys) + f"; bound_ms {fmt_ms(cells[0].get('bound_ms'))}",
            flush=True)
    sass = [run["rows"].get("sass_ternary_gemm_skip") for run in runs]
    if None in sass:
        print("B2/B3 SASS opcode counts: a tree's library could not be "
              "read", flush=True)
    else:
        print("B2/B3 SASS opcode counts equal in every tree: "
              f"{all(c == sass[0] for c in sass)} "
              f"({sum(sass[0].values())} instructions in run 0)", flush=True)
        for op in sorted(set().union(*sass)):
            counts = [c.get(op, 0) for c in sass]
            if len(set(counts)) > 1:
                print(f"  {op}: {counts}", flush=True)
    split = None
    if args.split:
        proc = subprocess.run([sys.executable, "-c", SPLIT],
                              cwd=Path(args.split).resolve(),
                              capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("SPLIT ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"--split failed: exit {proc.returncode}")
        split = json.loads(line[len("SPLIT "):])
        for shape, times in split.items():
            print(f"fused_mlp {shape}: device ms per call "
                  + json.dumps(times), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "trees": args.tree, "runs": runs,
                               "table": table, "b4_split_ms": split},
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
