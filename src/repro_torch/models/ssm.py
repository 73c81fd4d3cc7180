"""Mamba2 (SSD, state-space duality) mixer of the port: the chunked scan for
full sequences and the O(1)-state single-token step, the counterpart of
``repro.models.ssm`` with the same rounding points. Used by the ``ssm``
family (mamba2-130m) and the ``hybrid`` family (jamba).

The in/out projections are ``layers.linear`` layers, so packed ones run
through ``ops.ternary_gemm`` (B1 on the card); the state updates are
activation-activation products with no weights to ternarize.

A head-split rank (``distributed.tp.ssm_split``: its config a
``tp.ShardConfig`` with the local d_inner) runs the same code on its
heads: its in_proj columns and conv channels hold all of B and C, the
gated norm's sum of squares is all-reduced, out_proj is a row split.

Caches are ``{"state": (B, H, P, S) f32, "conv": (B, conv-1, conv_dim)}``.
A single-token step writes both in place (the engine's captured decode
step reads them as static buffers); the full-sequence path returns new
ones.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp as tp_lib
from repro_torch.models.layers import (_group, _randn, dtype_of,
                                       linear_apply, linear_init)

NEG_INF = -1e30


def ssm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, s, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * s
    d_proj = 2 * di + 2 * g * s + h          # in_proj emits [z, x, B, C, dt]
    pdt = dict(dtype=dtype_of(cfg.param_dtype), device=gen.device)
    return {
        "in_proj": linear_init(gen, cfg, d, d_proj),
        "out_proj": linear_init(gen, cfg, di, d),
        "conv_w": _randn(gen, (cfg.ssm_conv, conv_dim), cfg)
        / math.sqrt(cfg.ssm_conv),
        "conv_b": torch.zeros((conv_dim,), **pdt),
        "a_log": torch.log(torch.arange(1, h + 1, **pdt)),
        "dt_bias": torch.zeros((h,), **pdt),
        "d_skip": torch.ones((h,), **pdt),
        "norm_scale": torch.ones((di,), **pdt),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    di, g, s, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * g * s]
    dt = proj[..., -h:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) via shifted adds."""
    width = w.shape[0]
    out = xbc * w[-1]
    for i in range(1, width):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[width - 1 - i]
    return F.silu(out + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., q) -> (..., q, q); out[t, s] = sum_{s < r <= t} a[r]."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, torch.full_like(d, NEG_INF))


def _f32(*ts):
    return tuple(t.float() for t in ts)


def ssd_chunked(x_dt: torch.Tensor, a_dt: torch.Tensor, bm: torch.Tensor,
                cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked algorithm (Mamba2 paper, minimal form).

    x_dt: (B, L, H, P) inputs pre-multiplied by dt
    a_dt: (B, L, H)   log-decay per step (A * dt, negative), f32
    bm, cm: (B, L, H, S) input/output projections (groups pre-broadcast)
    Returns (y (B, L, H, P) in x_dt's dtype, final_state (B, H, P, S) f32).
    Products of compute-dtype operands accumulate in f32 (``repro``'s
    ``preferred_element_type``)."""
    b, l, h, p = x_dt.shape
    s = bm.shape[-1]
    q = min(chunk, l)
    assert l % q == 0, (l, q)
    nc = l // q

    def ch(t):  # (B, L, ...) -> (B, nc, q, ...)
        return t.reshape(b, nc, q, *t.shape[2:])

    xc, bc, cc = ch(x_dt), ch(bm), ch(cm)
    ac = ch(a_dt).permute(0, 3, 1, 2)                        # (B, H, nc, q)
    a_cum = torch.cumsum(ac, dim=-1)

    # 1) intra-chunk (the "quadratic attention-like" term)
    l_mat = torch.exp(_segsum(ac))                           # (B,H,nc,q,q)
    cf, bf, lf, xf = _f32(cc, bc, l_mat.to(cc.dtype), xc)
    scores = torch.einsum("bcqhs,bckhs->bhcqk", cf, bf) * lf
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", scores, xf)

    # 2) per-chunk output states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)        # (B,H,nc,q)
    ds = decay_states.to(bc.dtype).float()
    states = torch.einsum("bcqhs,bhcq,bcqhp->bchps", bf, ds, xf)

    # 3) inter-chunk recurrence over chunk boundaries
    if init_state is None:
        init_state = torch.zeros((b, h, p, s), dtype=torch.float32,
                                 device=x_dt.device)
    a_chunk = a_cum[..., -1]                                 # (B,H,nc)
    decay_chunk = torch.exp(_segsum(F.pad(a_chunk, (1, 0))))
    all_states = torch.cat([init_state[:, None].float(), states], dim=1)
    states_in = torch.einsum("bhzc,bchps->bzhps", decay_chunk, all_states)
    final_state = states_in[:, -1]
    states_in = states_in[:, :-1]                            # entering each

    # 4) inter-chunk contribution to outputs
    state_decay = torch.exp(a_cum)                           # (B,H,nc,q)
    si, sd = _f32(states_in.to(cc.dtype), state_decay.to(cc.dtype))
    y_off = torch.einsum("bcqhs,bchps,bhcq->bcqhp", cf, si, sd)
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y.to(x_dt.dtype), final_state


def _gated_norm(y, z, scale, eps, group=None):
    """RMS norm of y * silu(z) over the whole d_inner: a head-split rank
    (``group``) holds its slice, so the f32 sum of squares is summed over
    the group (``tp.sum_over_group``, its gradient too)."""
    y = y * F.silu(z)
    yf = y.float()
    if group is None:
        var = yf.square().mean(dim=-1, keepdim=True)
    else:
        var = tp_lib.sum_over_group(yf.square().sum(dim=-1, keepdim=True),
                                    group) / (yf.shape[-1] * group.size)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _split_inputs(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """A head-split rank's (params, x, group) (``tp.ssm_split``): x enters
    through Megatron's f, and the replicated B and C columns of its
    in_proj and conv get their partial gradients summed over the group
    (``tp.reduce_grad_columns``); (params, x, None) for a whole mixer."""
    mark = params.get("tp")
    if mark is None:
        return params, x, None
    group = _group()
    rep_in, rep_conv = tp_lib.ssm_replicated(mark)
    ip = {k: (tp_lib.reduce_grad_columns(v, rep_in, group)
              if k in ("w", "b") else v)
          for k, v in params["in_proj"].items()}
    params = dict(params, in_proj=ip, **{
        n: tp_lib.reduce_grad_columns(params[n], rep_conv, group)
        for n in ("conv_w", "conv_b")})
    return params, tp_lib.copy_to_group(x, group), group


def _heads(t: torch.Tensor, b: int, g: int, h: int, s: int) -> torch.Tensor:
    """(B, ..., g*s) group projections -> (B, ..., h, s), each group's
    row repeated for its h/g heads."""
    lead = t.shape[1:-1]
    t = t.reshape(b, *lead, g, 1, s).expand(b, *lead, g, h // g, s)
    return t.reshape(b, *lead, h, s)


def ssm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (train/prefill; ``cache_pos`` None) or single-token
    (decode) Mamba2 mixer. Prefill returns the new cache; a decode step
    writes ``cache`` in place and returns it."""
    di, g, s, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    b = x.shape[0]
    params, x, group = _split_inputs(params, x, cfg)
    proj = linear_apply(params["in_proj"], x, cfg)
    z, xbc, dt = _split_proj(proj, cfg)
    a = -torch.exp(params["a_log"].float())                  # (H,)
    dt = dt.float() + params["dt_bias"].float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))           # softplus

    if cache_pos is None:
        # ---- full sequence ----
        xbc = _causal_conv(xbc, params["conv_w"].to(x.dtype),
                           params["conv_b"].to(x.dtype))
        xi = xbc[..., :di].reshape(b, -1, h, p)
        bm = _heads(xbc[..., di:di + g * s], b, g, h, s)
        cm = _heads(xbc[..., di + g * s:], b, g, h, s)
        x_dt = xi * dt[..., None].to(xi.dtype)
        a_dt = a[None, None, :] * dt                         # (B, L, H)
        init_state = cache["state"] if cache is not None else None
        y, final_state = ssd_chunked(x_dt, a_dt, bm, cm, cfg.ssm_chunk,
                                     init_state)
        y = y + xi * params["d_skip"].to(xi.dtype)[None, None, :, None]
        y = y.reshape(b, -1, di)
        new_cache = None
        if cache is not None:
            new_cache = {"state": final_state,
                         "conv": xbc_raw_tail(x, proj, cfg)}
    else:
        # ---- single-token decode ----
        conv_cache = cache["conv"]                           # (B, w-1, C)
        window = torch.cat([conv_cache, xbc[:, :1]], dim=1)
        w = params["conv_w"].to(x.dtype)                     # (w, C)
        conv_out = torch.sum(window * w[None], dim=1) \
            + params["conv_b"].to(x.dtype)
        xbc1 = F.silu(conv_out)                              # (B, C)
        xi = xbc1[..., :di].reshape(b, h, p)
        bm = _heads(xbc1[..., di:di + g * s], b, g, h, s)
        cm = _heads(xbc1[..., di + g * s:], b, g, h, s)
        dt1 = dt[:, 0]                                       # (B, H)
        # the chunked path's numerics: decay factors and B/C/x*dt round
        # through the compute dtype, the state accumulates in f32
        decay = torch.exp(dt1 * a[None]).to(x.dtype).float()
        xdt = (xi * dt1[..., None].to(x.dtype)).to(x.dtype)
        state = cache["state"] * decay[..., None, None] \
            + xdt.float()[..., None] * bm.float()[:, :, None, :]
        y = torch.einsum("bhps,bhs->bhp", state.to(x.dtype).float(),
                         cm.float())
        y = y.to(x.dtype) + xi * params["d_skip"].to(x.dtype)[None, :, None]
        y = y.reshape(b, 1, di)
        z = z[:, :1]
        cache["state"].copy_(state)
        cache["conv"].copy_(window[:, 1:])
        new_cache = cache

    y = _gated_norm(y, z.reshape(y.shape), params["norm_scale"], cfg.norm_eps,
                    group)
    return linear_apply(params["out_proj"], y, cfg), new_cache


def xbc_raw_tail(x: torch.Tensor, proj: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The last (conv-1) pre-conv xbc inputs: the decode conv cache."""
    di, g, s = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    xbc = proj[..., di:di + di + 2 * g * s]
    return xbc[:, -(cfg.ssm_conv - 1):]


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device="cpu") -> dict:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
