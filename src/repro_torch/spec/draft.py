"""Draft models of the port's self-speculative decoding
(``repro.spec.draft``'s counterpart).

A *draft* is any cheap model whose greedy continuations of the target's
stream are often the target's own: the verify window (``spec.verify``)
accepts the longest matching prefix, so a draft moves throughput, never
the tokens. Three strategies build one behind the ``DraftModel`` protocol
(a name, an ``LM`` and its params):

* ``resparsify``: every packed ``TernaryWeight`` of the target is
  re-ternarized at a lower nnz fraction into a fresh pack of the same
  format, in numpy with ``repro``'s arithmetic, so packs and scales are
  bitwise ``repro``'s. On the main path the packs are ``dense2bit`` and
  B1 decodes every word whatever the occupancy, so such a draft costs a
  target step per feed: it is not cheaper there.
* ``layer_skip``: the first ``n_layers`` of the target's layer list
  (shared, not copied) with the target's final norm and lm head.
* ``external``: any other ``ModelConfig`` with its own params.

The draft round (``make_draft_round``) runs on the draft's own dense KV
cache, never on the target's pool: one re-sync feed of the second-newest
committed token at ``pos - 1``, then ``k`` chained greedy feeds. Its
proposals land in the verify window's buffer beside the newest token, so
the engine replays the draft round and the verify window back to back
with no host read between them (on the card each is one CUDA graph).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import weights
from repro_torch.models import LM

__all__ = ["DraftModel", "Draft", "SpecConfig", "build_draft",
           "resparsify", "layer_skip", "external", "make_draft_round"]


@runtime_checkable
class DraftModel(Protocol):
    """What the engine needs from a draft: a display name, the draft
    ``LM`` (its config may differ from the target's) and its params."""

    name: str
    model: LM
    params: Any


@dataclasses.dataclass
class Draft:
    name: str
    model: LM
    params: Any


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for ``ContinuousScheduler(spec=...)``.

    ``draft``: a strategy name (``"resparsify"``, ``"layer_skip"``,
    ``"external"``) that ``build_draft`` resolves against the loaded
    params, or a ready ``DraftModel``. ``k``: the proposal depth; each
    round drafts ``k`` tokens a slot and verifies the ``k+1``-token window
    in one target forward (the engine reserves ``k`` positions of
    headroom a request)."""

    draft: Any = "layer_skip"
    k: int = 4
    draft_sparsity: float = 0.125      # resparsify: the target nnz fraction
    draft_layers: int = 0              # layer_skip: 0 = half the layers
    draft_cfg: Optional[ModelConfig] = None   # external
    draft_params: Any = None                  # external


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

def _reternarize(eff: np.ndarray, sparsity: float):
    """``repro``'s re-ternarization of one effective (scale-applied)
    ternary matrix at a lower nnz fraction: a *global* |w| quantile (every
    nonzero of a column shares its magnitude, so a per-column quantile is
    degenerate; the global one drops low-scale columns' mass first), and
    the survivors' per-column mean |w| as the new scale."""
    absw = np.abs(eff)
    delta = np.quantile(absw.reshape(-1), 1.0 - sparsity)
    mask = (absw >= delta) & (absw > 0)
    t = (np.sign(eff) * mask).astype(np.int8)
    cnt = np.maximum(mask.sum(axis=0), 1)
    alpha = ((absw * mask).sum(axis=0) / cnt).astype(np.float32)
    return t, alpha


def _resparsify_container(w: weights.TernaryWeight, sparsity: float,
                          ) -> weights.TernaryWeight:
    eff = w.materialize(torch.float32, with_scale=True).cpu().numpy()
    lead, (kk, n) = eff.shape[:-2], eff.shape[-2:]
    e2 = eff.reshape((-1, kk, n))
    ts, alphas = zip(*(_reternarize(e2[i], sparsity)
                       for i in range(e2.shape[0])))
    dev = w.packed.device
    t = torch.from_numpy(np.stack(ts).reshape(lead + (kk, n))).to(dev)
    alpha = torch.from_numpy(np.stack(alphas).reshape(lead + (n,))).to(dev)
    return weights.FORMATS[w.format_name].from_dense(t, scale=alpha,
                                                     bias=w.bias)


def _map_packed(tree, fn: Callable):
    """Apply ``fn`` to every ``TernaryWeight`` of a param tree (dicts and
    lists), sharing every other leaf."""
    if isinstance(tree, weights.TernaryWeight):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_packed(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_packed(v, fn) for v in tree]
    return tree


def resparsify(model: LM, params, sparsity: float) -> Draft:
    """The target re-packed at ``sparsity`` nnz fraction: the same config,
    embeddings and unpacked params, every ``TernaryWeight`` replaced by a
    fresh pack of its format."""
    if not 0.0 < sparsity <= 1.0:
        raise ValueError(f"draft sparsity {sparsity} not in (0, 1]")
    n_packed = 0

    def conv(w):
        nonlocal n_packed
        n_packed += 1
        return _resparsify_container(w, sparsity)

    dparams = _map_packed(params, conv)
    if n_packed == 0:
        raise ValueError(
            "resparsify found no TernaryWeight containers in the params — "
            "pack them first (models.layers.pack_params / --packed), or use "
            "the layer_skip/external draft strategies")
    return Draft(name=f"resparsify(s={sparsity:g})", model=model,
                 params=dparams)


def layer_skip(model: LM, params, n_layers: int) -> Draft:
    """Depth-truncated self-draft: the target's first ``n_layers`` layers
    (the same tensors, not copies) and its final norm and lm head."""
    cfg = model.cfg
    if not 0 < n_layers < cfg.num_layers:
        raise ValueError(f"layer_skip needs 0 < n_layers < {cfg.num_layers},"
                         f" got {n_layers}")
    dmodel = LM(dataclasses.replace(cfg, num_layers=n_layers), model.device)
    dparams = dict(params, layers=params["layers"][:n_layers])
    return Draft(name=f"layer_skip({n_layers}/{cfg.num_layers})",
                 model=dmodel, params=dparams)


def external(cfg: ModelConfig, params=None, *, device="cuda") -> Draft:
    """Any independent (typically smaller) model as the drafter. ``params``
    default to a fresh init from seed 0 on ``device``, for plumbing tests;
    real use passes trained params."""
    m = LM(cfg, device)
    if params is None:
        params = m.init(torch.Generator(device=m.device).manual_seed(0))
    return Draft(name=f"external({cfg.name})", model=m, params=params)


def build_draft(spec: SpecConfig, model: LM, params) -> DraftModel:
    """Resolve a ``SpecConfig`` against the loaded target params."""
    if not isinstance(spec.draft, str):
        return spec.draft
    if spec.draft == "resparsify":
        return resparsify(model, params, spec.draft_sparsity)
    if spec.draft == "layer_skip":
        return layer_skip(model, params, spec.draft_layers
                          or max(1, model.cfg.num_layers // 2))
    if spec.draft == "external":
        if spec.draft_cfg is None:
            raise ValueError("draft='external' needs SpecConfig.draft_cfg")
        return external(spec.draft_cfg, spec.draft_params,
                        device=model.device)
    raise ValueError(f"unknown draft strategy {spec.draft!r}; expected "
                     f"'resparsify', 'layer_skip', 'external' or a "
                     f"DraftModel instance")


# ---------------------------------------------------------------------------
# The draft round
# ---------------------------------------------------------------------------

def make_draft_round(draft: DraftModel, max_len: int, k: int):
    """The per-round drafter, in place:
    ``round_(layers, pos, prev_tok, tok, window)`` writes the draft's K/V
    into ``layers`` (its dense cache) and ``[tok, d_1 .. d_k]`` into
    ``window`` (B, k+1) int32. ``pos``, ``prev_tok`` and ``tok`` are the
    engine's per-slot position and second-newest and newest committed
    tokens. The re-sync feed writes ``prev_tok``'s K/V at ``pos - 1``:
    after a round that accepted the whole window, that is the one
    committed token the draft never fed; otherwise it rewrites a value the
    draft holds. Free slots (pos 0) compute garbage into rows the next
    admission overwrites."""
    dlm, dparams = draft.model, draft.params

    @torch.no_grad()
    def round_(layers, pos, prev_tok, tok, window):
        pos_c = torch.clamp(pos, max=max_len - 1 - k)
        cache = {"layers": layers, "pos": torch.clamp(pos_c - 1, min=0)}
        _, cache = dlm.decode_step(dparams, cache, prev_tok[:, None])
        window[:, 0].copy_(tok)
        cur = tok
        for j in range(k):
            logits, cache = dlm.decode_step(dparams, cache, cur[:, None])
            cur = logits[:, -1].argmax(dim=-1).to(torch.int32)
            window[:, j + 1].copy_(cur)

    return round_
