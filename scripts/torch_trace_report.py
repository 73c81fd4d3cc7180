#!/usr/bin/env python
"""Analyse a ``repro_torch.launch.serve --trace`` export: step-time
breakdown, prefill/decode interleave bubbles, the per-request TTFT
attribution waterfall, and measured-vs-modeled kernel utilization. The
port's reader: the same sections, flags and JSON keys as
``scripts/trace_report.py``, reading the trace through ``repro_torch.obs``
alone (the trace-event format is the same in both packages, so either
reads either's traces).

The input is the Chrome trace-event JSON the engine's ``obs.trace.Tracer``
writes — the same file Perfetto renders visually; this gives the numeric
summary. Sections:

  * **step breakdown** — engine-track complete spans (decode_step,
    chunk_window, prefill, draft, verify) per engine pid: count, total
    seconds, p50/p90/p99 duration.
  * **interleave** — wall-clock span covered by the engine track, the
    fraction busy inside kernel spans vs scheduling bubbles, and how the
    busy time splits between prefill-side (prefill, chunk_window) and
    decode-side (decode_step, draft, verify) work.
  * **TTFT waterfall** — per request: queue wait vs prefill vs (chunked)
    chunk count, worst first — where the first token actually went.
  * **measured vs modeled** — kernel spans carry their plan's modeled
    roofline (``model_time_s``, bytes, flops); compare against measured
    wall time per span name: measured/modeled time ratio and achieved
    fraction of the modeled bandwidth/compute ceiling.

Usage:
  PYTHONPATH=src python scripts/torch_trace_report.py TRACE.json [--json]
      [--top 8]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.obs import (load_trace, percentiles,  # noqa: E402
                             validate_events)

# engine-track span names by scheduler side; anything else on tid 0 is
# still counted in the by-name breakdown, just not attributed to a side
PREFILL_SIDE = ("prefill", "chunk_window")
DECODE_SIDE = ("decode_step", "draft", "verify")


def _engine_spans(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Complete spans on an engine's scheduler track (tid 0)."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("tid") == 0]


def _busy_us(spans: List[Dict[str, Any]]) -> int:
    """Union length of [ts, ts+dur) intervals — overlapping spans (a
    chunk_window inside the same step as a decode_step) count once."""
    ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans)
    busy, end = 0, None
    for lo, hi in ivs:
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy


def step_breakdown(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    by_name: Dict[str, List[float]] = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e["dur"] / 1e6)
    return {name: dict(percentiles(durs) or {},
                       total_s=round(sum(durs), 6))
            for name, durs in sorted(by_name.items())}


def interleave(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    if not spans:
        return {"span_s": 0.0, "busy_frac": None, "bubble_frac": None,
                "prefill_frac": None, "decode_frac": None}
    t_lo = min(e["ts"] for e in spans)
    t_hi = max(e["ts"] + e["dur"] for e in spans)
    span_us = max(t_hi - t_lo, 1)
    busy = _busy_us(spans)
    pre = _busy_us([e for e in spans if e["name"] in PREFILL_SIDE])
    dec = _busy_us([e for e in spans if e["name"] in DECODE_SIDE])
    return {"span_s": round(span_us / 1e6, 6),
            "busy_frac": round(busy / span_us, 4),
            # scheduling bubbles: wall time on the engine track outside
            # any kernel span — host bookkeeping, queue waits, idle ticks
            "bubble_frac": round(1.0 - busy / span_us, 4),
            "prefill_frac": round(pre / span_us, 4),
            "decode_frac": round(dec / span_us, 4)}


def ttft_waterfall(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    per_rid: Dict[int, Dict[str, Any]] = {}
    for e in events:
        rid = (e.get("args") or {}).get("rid")
        if rid is None:
            continue
        row = per_rid.setdefault(rid, {"rid": rid})
        if e["ph"] == "X" and e["name"] in ("queue_wait", "prefill"):
            row[e["name"] + "_s"] = round(e["dur"] / 1e6, 6)
            if e["name"] == "prefill":
                row["chunks"] = e["args"].get("chunks")
    rows = [r for r in per_rid.values()
            if "queue_wait_s" in r or "prefill_s" in r]
    for r in rows:
        r["ttft_s"] = round(r.get("queue_wait_s", 0.0)
                            + r.get("prefill_s", 0.0), 6)
    rows.sort(key=lambda r: -r["ttft_s"])
    return rows


def measured_vs_modeled(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for e in spans:
        args = e.get("args") or {}
        if "model_time_s" in args:
            by_name.setdefault(e["name"], []).append(e)
    for name, evs in sorted(by_name.items()):
        measured = sum(e["dur"] for e in evs) / 1e6
        modeled = sum(e["args"]["model_time_s"] for e in evs)
        flops = sum(e["args"].get("modeled_flops", 0) for e in evs)
        out[name] = {
            "n": len(evs),
            "measured_s": round(measured, 6),
            "modeled_s": round(modeled, 6),
            # >1: slower than the roofline model says it could be (host
            # dispatch, unmodeled memory traffic); the gap IS the finding
            "measured_vs_model": (round(measured / modeled, 3)
                                  if modeled > 0 else None),
            "achieved_flops": (round(flops / measured, 1)
                               if measured > 0 and flops else None),
        }
    return out


def report(path: str) -> Dict[str, Any]:
    doc = load_trace(path)
    events = doc["traceEvents"]
    validate_events(events)
    spans = _engine_spans(events)
    return {
        "file": path,
        "events": len(events),
        "dropped": (doc.get("otherData") or {}).get("dropped_events", 0),
        "step_breakdown": step_breakdown(spans),
        "interleave": interleave(spans),
        "ttft_waterfall": ttft_waterfall(events),
        "measured_vs_modeled": measured_vs_modeled(spans),
    }


def _fmt_pct(v) -> str:
    return "n/a" if v is None else f"{100 * v:5.1f}%"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarise a repro_torch serve --trace export")
    ap.add_argument("trace", help="Chrome trace-event JSON from --trace")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON instead of text")
    ap.add_argument("--top", type=int, default=8,
                    help="TTFT waterfall rows shown in text mode")
    args = ap.parse_args(argv)
    try:
        rep = report(args.trace)
    except ValueError as e:         # not a trace, or an invalid event
        print(f"{args.trace}: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(rep, indent=2))
        return 0

    print(f"trace: {rep['file']}  ({rep['events']} events, "
          f"{rep['dropped']} dropped)")
    print("\n== step-time breakdown (engine track) ==")
    for name, s in rep["step_breakdown"].items():
        print(f"  {name:<14} n={s['n']:<5} total={s['total_s']:.4f}s  "
              f"p50={s['p50'] * 1e3:.2f}ms p90={s['p90'] * 1e3:.2f}ms "
              f"p99={s['p99'] * 1e3:.2f}ms")
    il = rep["interleave"]
    print("\n== interleave ==")
    print(f"  span={il['span_s']:.4f}s busy={_fmt_pct(il['busy_frac'])} "
          f"bubbles={_fmt_pct(il['bubble_frac'])} "
          f"(prefill-side={_fmt_pct(il['prefill_frac'])}, "
          f"decode-side={_fmt_pct(il['decode_frac'])})")
    print(f"\n== TTFT waterfall (worst {args.top}) ==")
    for r in rep["ttft_waterfall"][:args.top]:
        chunks = f" chunks={r['chunks']}" if r.get("chunks") else ""
        print(f"  rid={r['rid']:<4} ttft={r['ttft_s'] * 1e3:8.2f}ms  "
              f"queue={r.get('queue_wait_s', 0.0) * 1e3:8.2f}ms  "
              f"prefill={r.get('prefill_s', 0.0) * 1e3:8.2f}ms{chunks}")
    mvm = rep["measured_vs_modeled"]
    if mvm:
        print("\n== measured vs modeled (kernel spans) ==")
        for name, s in mvm.items():
            ratio = s["measured_vs_model"]
            print(f"  {name:<14} n={s['n']:<5} "
                  f"measured={s['measured_s']:.4f}s "
                  f"modeled={s['modeled_s']:.6f}s  "
                  f"x{ratio if ratio is not None else 'n/a'} of model")
    return 0


if __name__ == "__main__":
    sys.exit(main())
