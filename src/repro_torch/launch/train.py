"""Training entry point of the port (``repro.launch.train``): synthetic data,
ternary QAT (the straight-through ternarization of every projection with
min dim >= ``ternary_min_dim``), AdamW with a warmup-cosine schedule and
global-norm clipping, periodic checkpoints in ``repro``'s format, and
restart from the newest intact checkpoint under ``TrainSupervisor``, with
the straggler watchdog. One process on one device; the data- and
model-parallel trainers (and ternary gradient compression) wait for
ROADMAP A14.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch ternary-paper \\
      --steps 200 --batch 8 --seq 512 --ckpt-dir CKPT
  ... --device cpu --reduced --set ternary_min_dim=64   # plain PyTorch path

The last line of standard output is ``repro``'s JSON summary: ``steps``
(run in this invocation), ``first_loss``, ``last_loss``, ``mean_step_s``
(host clock, first step excluded) and ``stragglers``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.checkpoint.convert import (opt_state_from_numpy,
                                            opt_state_to_numpy,
                                            params_from_numpy,
                                            params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (StragglerWatchdog,
                                                     TrainSupervisor)
from repro_torch.launch import steps as steps_lib
from repro_torch.models import LM
from repro_torch.obs import clock as obs_clock
from repro_torch.optim import warmup_cosine

log = logging.getLogger("repro_torch.train")

_FIELD_TYPES = {"int": int, "float": float, "str": str}


def build(cfg: ModelConfig, batch: int, seq: int, lr: float = 3e-4,
          total_steps: int = 1000, device="cuda"):
    """(model, data, train_step, init_state(seed) -> {"params", "opt"}) on
    ``device``, with ``repro``'s schedule: warmup over min(100, steps/10 +
    1) steps, cosine to a tenth of ``lr`` at ``total_steps``."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    data = SyntheticLM(cfg, batch, seq)
    lr_fn = warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps)
    train_step, opt_init = steps_lib.make_train_step(model, cfg, lr_fn)

    def init_state(seed: int) -> Dict[str, Any]:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        return {"params": params, "opt": opt_init(params)}

    return model, data, train_step, init_state


def make_supervisor(cfg: ModelConfig, *, batch: int, seq: int, lr: float,
                    steps: int, ckpt_dir: str, ckpt_every: int,
                    seed: int = 0, device="cuda", log_every: int = 10):
    """(TrainSupervisor, per-step host seconds): the training loop of
    ``main``, checkpointing ``{"params", "opt"}`` in ``repro``'s layout and
    restoring from it."""
    dev = resolve_device(device)
    _, data, train_step, init_state = build(cfg, batch, seq, lr, steps, dev)

    def to_checkpoint(state):
        return {"params": params_to_numpy(state["params"], cfg),
                "opt": opt_state_to_numpy(state["opt"], cfg)}

    def make_state(resume_step: Optional[int]):
        if resume_step is None:
            return 0, init_state(seed)
        step, flat = ckpt_lib.restore(ckpt_dir, resume_step)
        tree = ckpt_lib.unflatten(flat)
        log.info("restored step %d from %s", step, ckpt_dir)
        return step, {"params": params_from_numpy(tree["params"], cfg, dev),
                      "opt": opt_state_from_numpy(tree["opt"], cfg, dev)}

    t_hist = []

    def step_fn(step: int, state):
        t0 = obs_clock.now()
        batch_t = data.sharded_batch(step, device=dev)
        params, opt, metrics = train_step(state["params"], state["opt"],
                                          batch_t)
        metrics = {k: float(v) for k, v in metrics.items()}   # syncs
        dt = obs_clock.now() - t0
        t_hist.append(dt)
        if step % log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step, metrics["loss"], dt)
        return {"params": params, "opt": opt}, metrics

    sup = TrainSupervisor(ckpt_dir, make_state, step_fn,
                          ckpt_every=ckpt_every, watchdog=StragglerWatchdog(),
                          to_checkpoint=to_checkpoint)
    return sup, t_hist


def _overrides(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        typ = ModelConfig.__dataclass_fields__[k].type
        out[k] = (v.lower() in ("1", "true")) if typ == "bool" \
            else _FIELD_TYPES[typ](v)
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ternary-paper")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="ternary gradient sync (not ported yet)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="a ModelConfig field override, k=v")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.data_parallel * args.model_parallel > 1 or args.compress_grads:
        raise NotImplementedError(
            "--data-parallel/--model-parallel > 1 and --compress-grads need "
            "the sharded trainer, which is not ported yet (ROADMAP A14)")
    cfg = get_config(args.arch, reduced=args.reduced,
                     **_overrides(args.set))
    sup, t_hist = make_supervisor(
        cfg, batch=args.batch, seq=args.seq, lr=args.lr, steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
        device=args.device, log_every=args.log_every)
    _, history = sup.run(args.steps)
    losses = [m["loss"] for _, m in history]
    summary = {
        "steps": len(history),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "mean_step_s": float(np.mean(t_hist[1:])) if len(t_hist) > 1
        else None,
        "stragglers": sup.watchdog.straggler_steps,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
