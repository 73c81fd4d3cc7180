"""Step builders of the port (``repro.launch.steps``): the train step with
AdamW, global-norm clipping and gradient accumulation — on one device, or
as one rank of a data- and tensor-parallel mesh (its gradients averaged
in f32 over the data group, or reduce-scattered into its data shards
where the model holds them, its clip norm summed over both groups) — and
the prefill and decode steps; ``input_specs`` (the batch of
one step of a cell as ``(shape, dtype)`` stand-ins) and
``model_shardings`` (the parameters' shapes, allocated nowhere, and their
resolved specs on a mesh; packed containers for a ``ternary_packed``
config) and ``cache_specs_shapes`` (a decode cell's cache, likewise)."""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import LM
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine
from repro_torch.optim.optimizers import tree_leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "value_and_grad", "mean_all_reduce", "input_specs",
           "model_shardings", "cache_specs_shapes", "packed_shapes"]

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


def _value_and_grad(model: LM, params, batch, marks=None):
    """(metrics, grads): grads of ``model.loss`` for every floating leaf,
    zeros where the loss does not reach one. ``marks`` (a tensor-parallel
    rank's, ``tp.strip_marks``) are attached for the model's call only."""
    from repro_torch.distributed import tp as tp_lib
    live = tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                    params)
    leaves = [t for t in tree_leaves(live) if t.requires_grad]
    with torch.enable_grad():
        loss, metrics = model.loss(
            tp_lib.attach_marks(live, marks) if marks else live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): (torch.zeros_like(t) if g is None else g)
             for t, g in zip(leaves, grads)}
    grads = tree_map(lambda t: by_id.get(id(t), torch.zeros_like(t)), live)
    return {k: v.detach() for k, v in metrics.items()}, grads


def value_and_grad(model: LM, cfg: ModelConfig, params, batch, marks=None,
                   accum: Optional[int] = None):
    """(metrics, grads) of one step's batch: ``accum`` (default
    ``cfg.grad_accum``) microbatches (the batch split on its leading
    axis) average their gradients and metrics."""
    accum = max(cfg.grad_accum if accum is None else accum, 1)
    if accum == 1:
        return _value_and_grad(model, params, batch, marks)
    grads = metrics = None
    for i in range(accum):
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                 for k, v in batch.items()}
        m, g = _value_and_grad(model, params, micro, marks)
        if grads is None:
            grads, metrics = g, m
        else:
            grads = tree_map(torch.add, grads, g)
            metrics = {k: metrics[k] + m[k] for k in metrics}
    grads = tree_map(lambda g: g / accum, grads)
    return {k: v / accum for k, v in metrics.items()}, grads


def mean_all_reduce(grads, group, skip=None):
    """The mean of every floating leaf over ``group``, summed in f32: all
    leaves in one flat f32 buffer, all-reduced in buckets
    (``Group.all_reduce_flat``), then each leaf / n cast back to its
    dtype. ``skip`` (a tree like ``grads``, ``fsdp.data_marks``) leaves
    out every leaf it marks (a data shard's gradient, already the
    group's mean)."""
    if skip is not None:
        keep = tree_leaves(tree_map(lambda g, m: m is None, grads, skip))
    else:
        keep = [True] * len(tree_leaves(grads))
    leaves = [g for g, k in zip(tree_leaves(grads), keep)
              if k and g.is_floating_point()]
    flat = torch.cat([g.reshape(-1).float() for g in leaves])
    group.all_reduce_flat(flat)
    out, at = {}, 0
    for g in leaves:
        out[id(g)] = (flat[at:at + g.numel()].reshape(g.shape)
                      / group.size).to(g.dtype)
        at += g.numel()
    return tree_map(lambda g: out.get(id(g), g), grads)


def make_train_step(model: LM, cfg: ModelConfig,
                    lr_fn: Optional[Callable] = None, *, data_group=None,
                    marks=None) -> Tuple[Callable, Callable]:
    """Returns (train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), opt_init(params) -> opt_state). Gradients of ``cfg.
    grad_accum`` microbatches (``value_and_grad``); then clipping at
    global norm 1.0, ``lr = lr_fn(step + 1)`` (schedules start at step 1)
    and AdamW. Metrics: ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``
    as 0-d tensors.

    As a rank of a mesh: ``data_group`` (a ``distributed.tp.Group``) is
    its data-parallel group — the gradients are averaged over it in f32
    (``mean_all_reduce``) and ``loss`` is its ranks' mean; ``marks``
    (``tp.strip_marks`` of its shards) make it a tensor-parallel rank of
    ``model.comm`` — the clip's norm sums the split leaves' squares over
    that group and counts the replicated ones once. Every rank of a data
    group then holds the same gradients, so the same update.

    ``model.shards`` (``distributed.fsdp.Shards`` over ``data_group``)
    makes the params the rank's data shards (``cfg.fsdp``): the model
    gathers them at use, their gradients arrive reduce-scattered (each
    microbatch's, under accumulation) and only the whole leaves are
    all-reduced; the norm sums the shards' squares over the data group
    too, and AdamW updates the shards."""
    lr_fn = lr_fn or warmup_cosine(3e-4, 100, 10_000)
    opt_init, opt_update = adamw(state_dtype=cfg.opt_state_dtype)
    split = None
    shards = model.shards

    def train_step(params, opt_state, batch):
        nonlocal split
        metrics, grads = value_and_grad(model, cfg, params, batch, marks)
        if data_group is not None and data_group.size > 1:
            grads = mean_all_reduce(grads, data_group,
                                    None if shards is None else shards.marks)
            metrics = dict(metrics, loss=mean_loss(metrics, data_group))
        if marks and split is None:
            from repro_torch.distributed import tp as tp_lib
            split = tp_lib.split_mask(grads, marks)
        data = (None, None) if shards is None \
            else (shards.marks, shards.group)
        grads, gnorm = clip_by_global_norm(
            grads, 1.0, split, model.comm if marks else None, *data)
        lr = lr_fn(opt_state["step"] + 1)
        params, opt_state = opt_update(grads, opt_state, params, lr)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step, opt_init


def mean_loss(metrics: Dict[str, torch.Tensor], group) -> torch.Tensor:
    """``metrics["loss"]`` averaged over ``group`` (``pmean``)."""
    return group.all_reduce(metrics["loss"].float().clone()) / group.size


def make_prefill_step(model: LM, cfg: ModelConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_decode_step(model: LM, cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return decode_step


# ---------------------------------------------------------------------------
# Input specs and parameter placements
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``(shape, dtype)`` stand-ins for the batch of one step of this cell,
    as ``repro``'s ``input_specs``: decode one token a row; an
    encoder-decoder's text after its ``frontend_seq`` encoder rows
    (``enc_embeds``), a VLM's after its vision rows; ``targets`` for a
    train cell."""
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    if shape.kind == "decode":
        return {"tokens": ((b, 1), I32)}
    n_front = cfg.frontend_seq if (cfg.frontend or cfg.is_encdec) else 0
    if cfg.is_encdec:
        s_dec = s - n_front
        batch = {"tokens": ((b, s_dec), I32),
                 "enc_embeds": ((b, n_front, d), BF16)}
        if shape.kind == "train":
            batch["targets"] = ((b, s_dec), I32)
        return batch
    s_text = s - n_front if cfg.family == "vlm" else s
    batch: Dict[str, Any] = {"tokens": ((b, s_text), I32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = ((b, n_front, d), BF16)
    if shape.kind == "train":
        batch["targets"] = ((b, s_text), I32)
    return batch


def model_shardings(model: LM, cfg: ModelConfig, mesh):
    """(the parameter tree as ``meta`` tensors — shapes and dtypes, no
    storage —, their resolved specs on ``mesh``): ``LM.init`` traced under
    a fake-tensor mode (packed by ``packed_shapes`` for a
    ``ternary_packed`` config, as ``repro``'s init makes containers for
    one), then ``sharding.resolve_specs`` of ``LM.param_specs`` with
    ``cfg.fsdp``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import sharding
    with FakeTensorMode():
        fake = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    shapes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), fake)
    if cfg.quantization == "ternary_packed":
        shapes = packed_shapes(shapes, cfg)
    specs = model.param_specs(shapes)
    return shapes, sharding.resolve_specs(specs, shapes, mesh, cfg.fsdp)


def twn_density(threshold: float) -> float:
    """The share of N(0, s^2) weights that TWN ternarization at
    ``threshold`` keeps nonzero: |w| > threshold * E|w|, i.e.
    erfc(threshold / sqrt(pi))."""
    return math.erfc(threshold / math.sqrt(math.pi))


def packed_shapes(params, cfg: ModelConfig):
    """A ``meta`` parameter tree with every projection and expert bank
    that ``layers.pack_params`` packs as a ``Dense2Bit`` of ``meta``
    words, scale and bias, its ``nnz`` what packing random N(0, s^2)
    weights keeps in expectation (``twn_density``), so a plan keys the
    sparsity bucket a packed random model's does."""
    from repro_torch.core import formats, weights
    from repro_torch.models import layers, moe
    density = twn_density(cfg.ternary_threshold)

    def container(w, bias=None):
        k, n = w.shape[-2:]
        lead = tuple(w.shape[:-2])
        return weights.Dense2Bit(
            packed=torch.empty(lead + (-(-k // formats.K_PER_WORD), n),
                               dtype=torch.int32, device="meta"),
            scale=torch.empty(lead + (n,), dtype=torch.float32,
                              device="meta"),
            bias=None if bias is None else torch.empty(
                lead + (n,), dtype=torch.float32, device="meta"),
            shape=(k, n), nnz=int(round(density * k * n)))

    def walk(p):
        if isinstance(p, dict):
            if moe.is_moe_node(p):
                if not layers._is_ternary(cfg, *p["w_in"].shape[-2:]):
                    return p
                return {k: (container(v) if k in moe._BANKS else v)
                        for k, v in p.items()}
            w = p.get("w")
            if w is not None and w.ndim in (2, 3) \
                    and layers._is_ternary(cfg, *w.shape[-2:]):
                return {"w_packed": container(w, p.get("b"))}
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v) for v in p]
        return p

    return walk(params)


def cache_specs_shapes(model: LM, cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[Any, Any]:
    """(the decode cache of ``shape`` as ``meta`` tensors, its logical spec
    tree ``LM.cache_specs``), as ``repro``'s ``cache_specs_shapes``: an
    encoder-decoder's adds ``enc_out`` (B, frontend_seq, d) bf16 over
    ``("pod", "data")``. ``sharding.resolve_specs`` resolves the specs."""
    b, s = shape.global_batch, shape.seq_len
    shapes = LM(cfg, "meta").init_cache(b, s)
    specs = model.cache_specs()
    if cfg.is_encdec:
        shapes = dict(shapes, enc_out=torch.empty(
            (b, cfg.frontend_seq, cfg.d_model), dtype=BF16, device="meta"))
        specs = dict(specs, enc_out=(("pod", "data"), None, None))
    return shapes, specs
