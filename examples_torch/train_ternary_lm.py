"""End-to-end driver on the port: train an LM with ternary QAT (the
paper's weight format in the forward pass, straight-through gradients),
periodically checkpointing, then quantize-pack-serve and compare the loss.

This is the paper's deployment story in one script:
    train (QAT) -> ternarize + pack (2-bit) -> serve with the packed kernels
(B1 for every packed projection and the lm head, B4 for the MLPs, on the
card).

Run:  PYTHONPATH=src python examples_torch/train_ternary_lm.py [--steps 300]
(the paper's 12 x 1024 config by default, on the card; --small --device
cpu for a CPU demo.)
"""
import argparse
import dataclasses
import json
import os
import tempfile

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.convert import (opt_state_to_numpy,
                                            params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.hlo_cost import leaf_tensors
from repro_torch.models import LM, layers as L
from repro_torch.optim import constant


def tree_bytes(tree) -> int:
    """Payload bytes of a param tree (containers' tensor fields too)."""
    return sum(t.nbytes for t in leaf_tensors(tree))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CPU smoke runs")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "ternary_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params full; reduced for CPU demo
    if args.small:
        cfg = get_config("ternary-paper", reduced=True, ternary_min_dim=64,
                         num_layers=2, vocab_size=512)
    else:
        cfg = get_config("ternary-paper")          # 12L x 1024d, QAT on
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"quantization={cfg.quantization} device={dev}")

    model = LM(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    step_fn, opt_init = steps_lib.make_train_step(model, cfg,
                                                  constant(args.lr))
    opt = opt_init(params)
    data = SyntheticLM(cfg, args.batch, args.seq, noise=0.02)

    losses = []
    for i in range(args.steps):
        batch = data.sharded_batch(i, device=dev)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
        if (i + 1) % 100 == 0:
            # repro's checkpoint layout: either package restores it
            ckpt.save(args.ckpt_dir, i + 1,
                      {"params": params_to_numpy(params, cfg),
                       "opt": opt_state_to_numpy(opt, cfg)})

    # ---- quantize + pack for serving -------------------------------------
    packed_params = L.pack_params(params, cfg)
    cfg_packed = dataclasses.replace(cfg, quantization="ternary_packed")
    m2 = LM(cfg_packed, dev)

    eval_batch = data.sharded_batch(10_000, device=dev)
    with torch.no_grad():
        loss_qat, _ = model.loss(params, eval_batch)
        loss_packed, _ = m2.loss(packed_params, eval_batch)
    n_packed = tree_bytes(packed_params)
    n_dense = tree_bytes(params)
    summary = {
        "first_loss": losses[0], "last_loss": losses[-1],
        "eval_loss_qat": float(loss_qat),
        "eval_loss_packed_2bit": float(loss_packed),
        "serving_bytes": n_packed, "train_bytes": n_dense,
        "compression": round(n_dense / n_packed, 2),
    }
    print(json.dumps(summary, indent=1))
    assert losses[-1] < losses[0], "training must reduce loss"
    assert abs(float(loss_packed) - float(loss_qat)) < 0.05, \
        "packed serving must match QAT"
    return summary


if __name__ == "__main__":
    main()
