"""Offline quantize-and-pack on the port: convert a model's dense weights
into the 2-bit ternary serving format and report per-layer stats — the
deployment-side half of the paper's pipeline. Packing runs on the chosen
device; the packed model's forward then goes through B1 (every packed
projection and the lm head) and B4 (the fused MLP) on the card.

Run:  PYTHONPATH=src python examples_torch/quantize_and_pack.py \\
          [--device cpu]
"""
import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.core import weights
from repro_torch.device import resolve_device
from repro_torch.launch.hlo_cost import leaf_tensors
from repro_torch.models import LM, layers as L
from repro_torch.models.transformer import layer_period


def tree_bytes(tree) -> int:
    """Payload bytes of a param tree (containers' tensor fields too)."""
    return sum(t.nbytes for t in leaf_tensors(tree))


def pack_report(params, packed_params, cfg):
    """One row (path, shape, occupancy, bytes before, bytes after) for
    every container the conversion produced: packed linears
    ({"w_packed": ...} nodes) and MoE expert banks (w_in/w_gate/w_out
    containers) alike, walking the latent and packed trees in parallel.
    Rows are in ``repro``'s layout: the port keeps a list of layers, and
    layers ``g * period + j`` of the same kind fold into one
    ``/block{j}`` row (encoder layers into ``/enc_block``), their shapes
    stacked, their bytes summed and their occupancy averaged."""
    rows = {}
    period = layer_period(cfg)

    def fold(path, shape, occ, before, after):
        parts = path.split("/")
        if len(parts) > 2 and parts[1] in ("layers", "enc_layers"):
            i = int(parts[2])
            block = (f"block{i % period}" if parts[1] == "layers"
                     else "enc_block")
            path = "/".join(["", block] + parts[3:])
        row = rows.setdefault(path, [shape, [], 0, 0])
        row[1].append(occ)
        row[2] += before
        row[3] += after

    def stats(latent, packed, path=""):
        if isinstance(packed, list):
            for i, v in enumerate(packed):
                stats(latent[i], v, f"{path}/{i}")
            return
        if not isinstance(packed, dict):
            return
        wc = packed.get("w_packed")
        if isinstance(wc, weights.TernaryWeight):
            fold(path, tuple(latent["w"].shape), wc.occupancy(),
                 tree_bytes(latent), tree_bytes(packed))
            return
        for k, v in packed.items():
            if isinstance(v, weights.TernaryWeight):     # MoE expert bank
                fold(f"{path}/{k}", tuple(latent[k].shape), v.occupancy(),
                     latent[k].nbytes, v.nbytes)
            else:
                stats(latent[k], v, f"{path}/{k}")

    stats(params, packed_params)
    out = []
    for path, (shape, occ, before, after) in rows.items():
        if path.startswith(("/block", "/enc_block")):
            shape = (len(occ),) + shape
        out.append((path, shape, sum(occ) / len(occ), before, after))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("ternary-paper", reduced=True, ternary_min_dim=64)
    model = LM(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    # the one pack entry point converts linears and MoE banks alike
    packed_params = L.pack_params(params, cfg)

    rows = pack_report(params, packed_params, cfg)
    print(f"{'layer':34s} {'shape':>18s} {'nnz':>6s} {'before':>10s} "
          f"{'after':>9s} {'ratio':>6s}")
    tot_b = tot_a = 0
    for path, shape, s, before, after in rows:
        tot_b += before
        tot_a += after
        print(f"{path:34s} {str(shape):>18s} {s:6.1%} {before:10,} "
              f"{after:9,} {before / after:5.1f}x")
    print(f"\ntotal packed: {tot_b:,} -> {tot_a:,} "
          f"({tot_b / tot_a:.1f}x weight-memory reduction)")

    # verify the packed model still runs
    m2 = LM(dataclasses.replace(cfg, quantization="ternary_packed"), dev)
    batch = {"tokens": torch.arange(32, dtype=torch.int32,
                                    device=dev).reshape(1, 32)}
    with torch.no_grad():
        x, _, _ = m2.forward(packed_params, batch)
        logits = m2._logits(packed_params, x)
    assert bool(torch.isfinite(logits).all())
    print("packed model forward: OK")
    summary = {"device": str(dev),
               "rows": [{"path": p, "shape": list(sh), "occupancy": s,
                         "before": b, "after": a}
                        for p, sh, s, b, a in rows],
               "total_before": tot_b, "total_after": tot_a,
               "ratio": tot_b / tot_a,
               "logits_shape": list(logits.shape)}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return summary


if __name__ == "__main__":
    main()
