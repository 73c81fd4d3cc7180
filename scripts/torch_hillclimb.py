#!/usr/bin/env python
"""Perf hillclimb driver of the port: run one dry-run cell with config
overrides, print the three roofline terms and the per-op byte/flop
breakdown (hypothesis fuel), and write the iteration's record to
``experiments/perf_torch/<arch>_<shape>_<tag>.json`` (the counterpart of
``scripts/hillclimb.py``, with its flags and record keys).

The cell is rank 0 of the port's placement on the production mesh (16 x
16, or 2 x 16 x 16 with ``--multi-pod``), traced on ``meta`` tensors by
``repro_torch.launch.dryrun.trace_cell``; no card is needed. Its times
come from the H100 SXM data-sheet constants of ``launch/dryrun.py``
(``PEAK_FLOPS``, ``HBM_BW``, and each group's NVLink or InfiniBand rate
for the collectives). ``--kernel-model`` reads the walker's kernel
reading (each B1 / B4 dispatch charged by its plan,
``hlo_cost.analyze(..., kernel_dequant=True)``) in place of the plain
one; ``hbm_gb`` is the rank's peak of live storage and ``compile_s`` the
trace's seconds. ``--autotune-gemm`` looks up the block-shape tuner's
picks for the arch's projection shapes (``autotune.get_tuner()``, whose
cache file it warms) and records them.

Usage:
  PYTHONPATH=src python scripts/torch_hillclimb.py --arch granite-3-8b \\
      --shape decode_32k --tag baseline
  ... --set attn_impl=naive --set logits_chunk=1024 --tag iterN
  ... --set quantization=ternary_packed --kernel-model --tag packed
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import dryrun  # noqa: E402

OUT_DIR = os.path.join("experiments", "perf_torch")


def autotune_picks(cfg, shape) -> Dict[str, List[int]]:
    """The tuner's tile for each of the arch's four projection shapes
    (d -> ff, ff -> d, d -> d, d -> the padded vocabulary) at the cell's
    rows (the sequence, or the decode batch and at least 8), occupancy
    1/4."""
    from repro_torch.kernels.autotune import get_tuner
    tuner = get_tuner()
    d, ff = cfg.d_model, cfg.d_ff or cfg.d_ff_expert or cfg.d_model * 4
    m = shape.seq_len if shape.kind != "decode" else max(
        shape.global_batch, 8)
    picks = {}
    for din, dout in {(d, ff), (ff, d), (d, d), (d, cfg.padded_vocab())}:
        picks[f"{din}x{dout}"] = tuner.lookup(m, din, dout,
                                              sparsity=0.25).as_list()
    return picks


def record(cell: dryrun.TracedCell, head: Dict[str, Any], tag: str,
           kernel_model: bool, top: int) -> Dict[str, Any]:
    """``scripts/hillclimb.py``'s record of one traced cell."""
    tr = cell.trace
    walked = tr.kernel if kernel_model else tr.plain
    chips = cell.mesh.size
    mf = dryrun.model_flops(cell.cfg, cell.shape)
    rec = {"arch": head["arch"], "shape": head["shape"], "tag": tag,
           "overrides": head["overrides"]}
    rec.update(cell.bound(walked))
    rec.update(
        flops_per_chip=walked.flops, bytes_per_chip=walked.bytes,
        collective_by_type=walked.collective_bytes,
        useful_ratio=(mf / chips) / walked.flops if walked.flops else None,
        hbm_gb=tr.peak_bytes / 2 ** 30,
        compile_s=round(cell.trace_s, 1),
        top_bytes_by_op=[list(r) for r in walked.top_bytes(top)],
        kernel_model=kernel_model)
    return rec


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--kernel-model", action="store_true",
                    help="charge each B1 / B4 dispatch by its plan (the "
                         "walker's kernel reading)")
    ap.add_argument("--autotune-gemm", action="store_true",
                    help="look up (and cache) the ternary-GEMM block-shape "
                         "tuner's picks for this arch's projection shapes "
                         "and record them")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = dryrun.parse_override(k, v)
    head, cell = dryrun.trace_cell(args.arch, args.shape,
                                   multi_pod=args.multi_pod,
                                   overrides=overrides)
    if cell is None:
        raise SystemExit(f"{args.arch} {args.shape}: {head['reason']}")
    rec = record(cell, head, args.tag, args.kernel_model, args.top)
    if args.autotune_gemm:
        rec["autotune_gemm"] = autotune_picks(cell.cfg, cell.shape)
        print(" autotuned ternary blocks:", rec["autotune_gemm"])
    else:
        rec["autotune_gemm"] = None

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR,
                        f"{args.arch}_{args.shape}_{args.tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"== {args.arch} {args.shape} [{args.tag}] chips={cell.mesh.size}"
          f" ==")
    print(f" t_compute={rec['t_compute_s']:.4e}s "
          f"t_memory={rec['t_memory_s']:.4e}s "
          f"t_collective={rec['t_collective_s']:.4e}s "
          f"dominant={rec['dominant']}")
    ratio = rec["useful_ratio"]
    print(f" useful_ratio={'n/a' if ratio is None else f'{ratio:.3f}'} "
          f"hbm={rec['hbm_gb']:.1f}GB compile={rec['compile_s']}s")
    print(" top ops by bytes (op, GB, GFLOP):")
    for k, b, fl in rec["top_bytes_by_op"]:
        print(f"   {k:24s} {b / 1e9:12.2f} {fl / 1e9:12.2f}")
    print(" collectives:", {k: f"{v / 1e9:.2f}GB"
                            for k, v in rec["collective_by_type"].items()})
    print(f" wrote {path}")
    return rec


if __name__ == "__main__":
    main()
