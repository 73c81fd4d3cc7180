"""Ternary gradient compression (TernGrad-style) with error feedback — the
port's counterpart of ``repro.distributed.compression``.

The paper's value system {-1, 0, +1} applied to the communication layer:
the data-parallel gradient sync of ``launch/train.py --compress-grads``
sends each leaf as ternary codes plus one scale per rank instead of the
f32 gradient. A ring all-reduce sums at every hop, and a sum of ternary
codes is no longer ternary, so the codes cross the wire as a bf16 sum
(half the bytes of f32): a sum of n codes is an integer of size at most
n, exact in bf16 for n <= 256. The scales are averaged. Error feedback
(the part of g + err the codes did not carry) keeps the compression
unbiased over steps.

``ternarize_gradient`` keeps ``repro``'s operations in its order: an f32
sum g + err, Δ = factor · mean|·| over the whole leaf, the codes as bf16,
the scale as the mean of |·| over the kept entries (at least one).
``compressed_all_reduce`` is ``compressed_psum`` over a process group
(``distributed.tp.Group``): each leaf's result is ``(Σ codes · mean
scale / n).to(g.dtype)``, as ``repro``'s. A leaf is ``repro``'s: the
port keeps a list of per-layer trees where ``repro`` stacks the layers
``g * period + j`` into one ``block{j}`` leaf (and every encoder layer
into ``enc_block``), so with ``period`` those layers' gradients
ternarize together, with one Δ and one scale (``leaf_groups``). Every
leaf's codes go into one flat bf16 buffer (all-reduced in buckets) and
every scale into one f32 vector, whatever the number of leaves.
The error state keeps the port's per-layer tree (it is elementwise).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.optim.optimizers import tree_map

__all__ = ["ternarize_gradient", "leaf_groups", "ternarize_tree",
           "synced_tree", "compressed_all_reduce", "init_error_state",
           "wire_bytes"]


def ternarize_gradient(g: torch.Tensor, err: torch.Tensor,
                       threshold_factor: float = 0.7
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g + err) -> (ternary codes as bf16, f32 scale, new f32 error)."""
    gf = g.float() + err
    absg = gf.abs()
    delta = threshold_factor * absg.mean()
    mask = absg > delta
    t = torch.sign(gf) * mask
    nnz = mask.sum().clamp_min(1)
    scale = (absg * mask).sum() / nnz
    new_err = gf - scale * t
    return t.to(torch.bfloat16), scale, new_err


def leaf_groups(tree, period: int = 1) -> Dict[tuple, List[torch.Tensor]]:
    """The floating leaves of a port tree (params, grads, error state)
    grouped as ``repro``'s leaves: the same place in the layers ``i``
    with equal ``i % period`` of ``"layers"`` (in layer order), the same
    place in every layer of ``"enc_layers"``, every other leaf alone;
    keyed by that place, in a fixed order for trees of one structure."""
    groups: dict = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, key + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                if key == ("layers",):
                    walk(v, key + (i % period,))
                elif key == ("enc_layers",):
                    walk(v, key)
                else:
                    walk(v, key + (i,))
        elif isinstance(node, torch.Tensor) and node.is_floating_point():
            groups.setdefault(key, []).append(node)

    walk(tree, ())
    return groups


def _joined(ts: List[torch.Tensor]) -> torch.Tensor:
    return ts[0] if len(ts) == 1 else torch.stack(ts)


def ternarize_tree(grads, err_state, threshold_factor: float = 0.7,
                   period: int = 1):
    """One rank's side of the sync before the wire: every ``repro`` leaf
    of ``grads`` (``leaf_groups``) ternarized with its error state ->
    (all codes as one flat bf16 tensor, the scales as one f32 vector, the
    new error state in ``err_state``'s structure)."""
    gs, es = leaf_groups(grads, period), leaf_groups(err_state, period)
    es = [es[key] for key in gs]
    parts = [ternarize_gradient(_joined(g), _joined(e), threshold_factor)
             for g, e in zip(gs.values(), es)]
    new = {}
    for e, (_, _, ne) in zip(es, parts):
        for old, piece in zip(e, ne.unbind(0) if len(e) > 1 else [ne]):
            new[id(old)] = piece
    return (torch.cat([t.reshape(-1) for t, _, _ in parts]),
            torch.stack([s for _, s, _ in parts]),
            tree_map(lambda e: new.get(id(e), e), err_state))


def synced_tree(grads, code_sum: torch.Tensor, scale_sum: torch.Tensor,
                n: int, period: int = 1):
    """``grads``' structure filled from the n ranks' summed codes and
    scales (``ternarize_tree``'s layout): each leaf ``(Σ codes · (Σ scales
    / n) / n)`` in the gradient's dtype; a non-floating leaf unchanged."""
    out, at = {}, 0
    for i, g in enumerate(leaf_groups(grads, period).values()):
        shape = ((len(g),) if len(g) > 1 else ()) + tuple(g[0].shape)
        numel = len(g) * g[0].numel()
        t = code_sum[at:at + numel].reshape(shape)
        at += numel
        s = (t.float() * (scale_sum[i] / n) / n).to(g[0].dtype)
        for old, piece in zip(g, s.unbind(0) if len(g) > 1 else [s]):
            out[id(old)] = piece
    return tree_map(lambda g: out.get(id(g), g), grads)


def compressed_all_reduce(grads, err_state, group,
                          threshold_factor: float = 0.7, period: int = 1):
    """Ternarize every ``repro`` leaf of ``grads`` (with its error state),
    sum the codes over ``group`` on a bf16 wire and average the scales.
    Returns (synced grads, new error state); ``group=None`` is one
    rank."""
    codes, scales, new_err = ternarize_tree(grads, err_state,
                                            threshold_factor, period)
    if group is not None:
        group.all_reduce_flat(codes)
        group.all_reduce(scales)
    n = 1 if group is None else group.size
    return synced_tree(grads, codes, scales, n, period), new_err


def init_error_state(params):
    """f32 zeros shaped like each floating leaf, a 0-d zero otherwise."""
    def zeros(p):
        if p.is_floating_point():
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return torch.zeros((), dtype=torch.float32, device=p.device)
    return tree_map(zeros, params)


def wire_bytes(params, compressed: bool, period: int = 1) -> int:
    """Bytes one rank puts into a step's gradient all-reduces: every
    floating leaf in f32, or its codes in bf16 plus one f32 scale a
    ``repro`` leaf."""
    groups = leaf_groups(params, period)
    numel = sum(t.numel() for g in groups.values() for t in g)
    if compressed:
        return 2 * numel + 4 * len(groups)
    return 4 * numel
