#!/usr/bin/env python3
"""Markdown tables of the port's dry-run records (``python -m
repro_torch.launch.dryrun``'s JSON files, one a cell), for PERF.md.

    python3 scripts/dryrun_table.py experiments/dryrun_torch/16x16 \
        experiments/dryrun_torch/2x16x16

The first directory's cells of the configs' own quantization, one row
each: per-rank FLOPs, bytes (plain / with kernels), collective bytes, the
compute, memory and collective times, what dominates, the peak and
whether it fits 80 GiB; from the second directory (another mesh) the same
cell's times, dominant and peak beside them. The skipped cells in one
line. Then the ``ternary_packed`` serving cells of the first directory,
one row an architecture: plain and kernel bytes, the kernel reading's
memory time and the peak, prefill and decode. Last, the train cells of
both directories: the rank's arguments, its params and AdamW moments
(``state_size_in_bytes``), the peak and the link bytes of its data and
model groups."""
import glob
import json
import os
import sys


def _load(d):
    out = {}
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        packed = os.path.basename(f).endswith("_ternary_packed.json")
        out[(rec["arch"], rec["shape"], packed)] = rec
    return out


def _g(x, unit=1.0):
    return f"{x / unit:.3g}"


def _times(r):
    return (f"{_g(r['t_compute_s'])} / {_g(r['t_memory_s'])} / "
            f"{_g(r['t_collective_s'])}")


def _peak(r):
    m = r["memory"]
    return f"{_g(m['peak_bytes'], 2 ** 30)} ({'yes' if m['fits'] else 'no'})"


def main(first_dir, other_dir):
    first, other = _load(first_dir), _load(other_dir)
    a, b = (os.path.basename(d.rstrip("/")) for d in (first_dir, other_dir))
    print(f"| cell | TFLOP | TB plain / kernels | coll. GB | {a}: t comp / "
          f"mem / coll s | dominant | peak GiB (fits) | {b}: t comp / mem /"
          f" coll s | dominant | peak GiB (fits) |")
    print("| --- " * 10 + "|")
    skipped = []
    for (arch, shape, packed), r in sorted(first.items()):
        if packed:
            continue
        if r["status"] == "skipped":
            skipped.append(f"{arch} {shape}")
            continue
        o = other.get((arch, shape, False), {"status": "missing"})
        rest = (f"{_times(o)} | {o['dominant']} | {_peak(o)}"
                if o["status"] == "ok" else f"{o['status']} | |")
        print(f"| {arch} {shape} | {_g(r['hlo_flops_per_chip'], 1e12)} | "
              f"{_g(r['hlo_bytes_per_chip'], 1e12)} / "
              f"{_g(r['kernel_bytes_per_chip'], 1e12)} | "
              f"{_g(r['collective_bytes_per_chip']['total'], 1e9)} | "
              f"{_times(r)} | {r['dominant']} | {_peak(r)} | {rest} |"
              if r["status"] == "ok" else f"| {arch} {shape} | "
              f"{r['status']} |||||||| |")
    print(f"\nSkipped ({len(skipped)}, `repro`'s reason): "
          + ", ".join(skipped))
    print(f"\n| {a} `ternary_packed` | prefill_32k: TB plain / kernels | "
          "kernel t mem s | peak GiB (fits) | decode_32k: TB plain / kernels"
          " | kernel t mem s | peak GiB (fits) |")
    print("| --- " * 7 + "|")
    for arch in sorted({k[0] for k in first if k[2]}):
        cols = []
        for shape in ("prefill_32k", "decode_32k"):
            r = first.get((arch, shape, True), {"status": "missing"})
            cols.append(f"{_g(r['hlo_bytes_per_chip'], 1e12)} / "
                        f"{_g(r['kernel_bytes_per_chip'], 1e12)} | "
                        f"{_g(r['kernel_t_memory_s'])} | {_peak(r)}"
                        if r["status"] == "ok" else f"{r['status']} | |")
        print(f"| {arch} | {cols[0]} | {cols[1]} |")
    print(f"\n| train cell | {a}: args / state / peak GiB | link GB data / "
          f"model | {b}: args / state / peak GiB | link GB data / model |")
    print("| --- " * 5 + "|")
    for (arch, shape, packed), r in sorted(first.items()):
        if packed or shape != "train_4k" or r["status"] != "ok":
            continue
        o = other.get((arch, shape, False), {"status": "missing"})
        cols = [_train_mem(r)] + ([_train_mem(o)] if o["status"] == "ok"
                                  else [f"{o['status']} |"])
        print(f"| {arch} | {cols[0]} | {cols[1]} |")


def _train_mem(r):
    m = r["memory"]
    data = " / ".join(_g(r["collectives"].get(k, {}).get("link_bytes", 0.0),
                         1e9) for k in ("data", "model"))
    return (f"{_g(m['argument_size_in_bytes'], 2 ** 30)} / "
            f"{_g(m.get('state_size_in_bytes') or 0, 2 ** 30)} / "
            f"{_g(m['peak_bytes'], 2 ** 30)} | {data}")


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(*sys.argv[1:])
