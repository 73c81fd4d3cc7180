"""Step builders of the port (``repro.launch.steps``): the train step with
AdamW, global-norm clipping and gradient accumulation, and the prefill and
decode steps. ``input_specs`` and ``model_shardings`` belong to the
sharded trainer, which is not ported yet (ROADMAP A14)."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import LM
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine
from repro_torch.optim.optimizers import tree_leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def _value_and_grad(model: LM, params, batch):
    """(loss, metrics, grads): grads of ``model.loss`` for every floating
    leaf, zeros where the loss does not reach one."""
    live = tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                    params)
    leaves = [t for t in tree_leaves(live) if t.requires_grad]
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): (torch.zeros_like(t) if g is None else g)
             for t, g in zip(leaves, grads)}
    grads = tree_map(lambda t: by_id.get(id(t), torch.zeros_like(t)), live)
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: LM, cfg: ModelConfig,
                    lr_fn: Optional[Callable] = None
                    ) -> Tuple[Callable, Callable]:
    """Returns (train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), opt_init(params) -> opt_state). ``cfg.grad_accum``
    microbatches (the batch split on its leading axis) average their
    gradients and metrics; then clipping at global norm 1.0, ``lr =
    lr_fn(step + 1)`` (schedules start at step 1) and AdamW. Metrics:
    ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr`` as 0-d tensors."""
    lr_fn = lr_fn or warmup_cosine(3e-4, 100, 10_000)
    opt_init, opt_update = adamw(state_dtype=cfg.opt_state_dtype)
    accum = max(cfg.grad_accum, 1)

    def train_step(params, opt_state, batch):
        if accum == 1:
            metrics, grads = _value_and_grad(model, params, batch)
        else:
            grads = metrics = None
            for i in range(accum):
                micro = {k: v.reshape(accum, v.shape[0] // accum,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                m, g = _value_and_grad(model, params, micro)
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = tree_map(torch.add, grads, g)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = tree_map(lambda g: g / accum, grads)
            metrics = {k: v / accum for k, v in metrics.items()}
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = lr_fn(opt_state["step"] + 1)
        params, opt_state = opt_update(grads, opt_state, params, lr)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step, opt_init


def make_prefill_step(model: LM, cfg: ModelConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_decode_step(model: LM, cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return decode_step
