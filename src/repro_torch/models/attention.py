"""GQA attention of the port: full-sequence attention with no cache
(training and evaluation: ``flash_attention``, the blockwise version,
B6 through ``kernels.flash_attention``, or ``naive_attention``, by
``cfg.attn_impl``), prefill-into-cache and per-slot decode over a dense
cache, and one-token decode over a paged cache — the counterparts of
``repro.models.attention``. Dense caches come in ``repro``'s three
layouts (``init_kv_cache``): ``bshd`` (B, S, KV, hd), ``flat`` (B, S,
KV*hd) read through ``_cache_view``, and ``opt`` (K (B, KV, S, hd), V
(B, KV, hd, S)), whose decode writes nothing in the layer
(``delta_decode_attention``) and is committed by ``LM.decode_step``
after the stack. A sliding-window model keeps a rolling cache of
``min(max_len, window)`` positions: token p at slot ``p % cache_len``.

``repro``'s attend-the-view rule carries over: prefill rounds K/V to the
cache dtype, writes them, and attends the full ``max_len``-wide written
cache view with causal masking; decode scatters each slot's token K/V at
its own position and attends the view with ``kv_valid_len = pos + 1``.
A (B, S > 1) decode window (chunked prefill) scatters all S tokens' K/V
at ``cache_pos[b] + j`` first and then attends: the dense view causally
with each row's query offset, the paged pool through B5 over the (B*S)
flattened rows with ``lengths = pos + j + 1`` — so token j of a window
sees what the j-th of S one-token steps would.
The cache tensors are updated in place (JAX returns new ones): the slot
or page pool owns them and nothing else reads the old values.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.kernels import ops
from repro_torch.models.layers import (linear_apply, linear_init,
                                      region_input, rope)
from repro_torch.paging.quant import Int8Pages, quantize_rows

NEG_INF = -1e30


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, kv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    h = cfg.num_heads + cfg.head_pad
    return {"q": linear_init(gen, cfg, d, h * hd),
            "k": linear_init(gen, cfg, d, kv * hd),
            "v": linear_init(gen, cfg, d, kv * hd),
            "o": linear_init(gen, cfg, h * hd, d)}


def flash_attention(q, k, v, *, causal: bool, block_q: int,
                    block_kv: int, window: int = 0) -> torch.Tensor:
    """Blockwise attention, differentiable (``repro``'s XLA
    ``flash_attention``): q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq,
    H, hd). Per query block an online softmax over the KV blocks it can
    see (causality and the sliding window shorten the walk), scores and
    statistics in f32, p rounded to v's dtype before the PV product."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    pad_q, pad_kv = (-sq) % bq, (-skv) % bkv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nkv = (skv + pad_kv) // bkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for i in range((sq + pad_q) // bq):
        q_blk = q[:, i * bq:(i + 1) * bq].reshape(b, bq, kvh, g, hd).float()
        q_lo = i * bq
        hi_blk = nkv if not causal else max(
            1, min(nkv, -(-min(q_lo + bq, skv) // bkv)))
        lo_blk = max(0, (q_lo - window) // bkv) if window else 0
        hi_blk = max(hi_blk, lo_blk + 1)
        q_pos = q_lo + torch.arange(bq, device=dev)
        m = torch.full((b, kvh, g, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, bq, hd), dtype=torch.float32,
                          device=dev)
        for j in range(lo_blk, hi_blk):
            kc, vc = (t[:, j * bkv:(j + 1) * bkv] for t in (k, v))
            k_pos = j * bkv + torch.arange(bkv, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, kc.float()) * scale
            mask = (k_pos < skv)[None, :].expand(bq, bkv)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window:
                mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vc.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        outs.append(o.reshape(b, h, bq, hd).transpose(1, 2).to(q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :sq]


def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset=0, kv_valid_len=None) -> torch.Tensor:
    """Full-materialization attention. q: (B, Sq, H, hd); k/v: (B, Skv, KV,
    hd). ``q_offset`` / ``kv_valid_len`` are ints or (B,) tensors (each slot
    at its own position). Scores, softmax and both products in f32; the
    probabilities are rounded to v's dtype before the second product, as in
    ``repro``."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    dev = q.device
    q_off = torch.as_tensor(q_offset, device=dev)
    q_pos = q_off[..., None] + torch.arange(sq, device=dev)  # (sq,)|(B, sq)
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    k_pos = torch.arange(skv, device=dev)
    mask = torch.ones((1, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos)
    if window:
        mask = mask & (q_pos[:, :, None] - k_pos < window)
    if kv_valid_len is not None:
        valid = torch.as_tensor(kv_valid_len, device=dev)
        valid = valid[:, None, None] if valid.ndim else valid
        mask = mask & (k_pos < valid)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def attn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, causal: bool = True,
               cache: Optional[dict] = None,
               cache_pos: Optional[torch.Tensor] = None,
               kv_override: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None,
               block_table: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One attention layer over the full sequence, a dense cache or a paged
    cache, or cross-attention.

    * no cache (training, evaluation, the encoder): x (B, S, d), attention
      over the S tokens, causal unless ``causal=False`` (the encoder), by
      ``cfg.attn_impl`` — ``"pallas"`` (no window): K/V repeated to H
      heads and B6 on (B*H, S, hd); ``"flash"``: the blockwise version;
      otherwise ``naive_attention``. Returns (y, None);
    * cross-attention: ``kv_override`` = (k, v), each (B, S_enc, KV, hd),
      projected from the encoder's output by the caller: no rope on q or
      on them, never causal, no cache, and always ``naive_attention``
      (``repro`` keeps ``kv_override`` out of its flash and Pallas
      branches). Returns (y, None);
    * prefill (``cache_pos is None``): x (B, S, d); K/V of all S tokens are
      written at positions 0..S-1 and the layer attends the cache view. A
      rolling cache shorter than S keeps the last ``cache_len`` tokens at
      their ``pos % cache_len`` slots, and an ``opt`` cache is written
      whole; both attend the fresh (cache-rounded) K/V as the no-cache
      branch does, with the window;
    * decode: x (B, S, d) and ``cache_pos`` an int tensor, scalar or (B,)
      (each slot at its own position); S > 1 is a window whose token j
      sits at ``cache_pos + j``, all below the cache's length (non-rolling
      ``bshd``/``flat`` caches only: ``LM.decode_step`` unrolls the rest).
      A rolling cache writes at ``pos % cache_len`` and attends
      ``min(pos + 1, cache_len)`` slots; an ``opt`` cache is not written
      here: the layer attends the stale cache plus its own token
      (``delta_decode_attention``) and returns ``{"k_tok", "v_tok"}``, which
      ``LM.decode_step`` commits after the stack;
    * paged decode: cache ``{"k_pages", "v_pages"}``, ``block_table``
      (B, T) int32 and ``cache_pos`` a (B,) vector, through the registry
      row ``cfg.paged_attn_impl``; prefill never sees a paged cache (the
      page pool scatters prefilled rows into pages).
    """
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    h = cfg.num_heads + cfg.head_pad
    lead = x.shape[:-1]
    x = region_input(x, params["q"])
    q = linear_apply(params["q"], x, cfg).reshape(*lead, h, hd)
    if kv_override is not None:
        k, v = kv_override
        o = naive_attention(q, k, v, causal=False,
                            window=cfg.sliding_window)
        return linear_apply(params["o"], o.reshape(*lead, h * hd), cfg), None
    k = linear_apply(params["k"], x, cfg).reshape(*lead, kv, hd)
    v = linear_apply(params["v"], x, cfg).reshape(*lead, kv, hd)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        o = _full_sequence(q, k, v, cfg, causal)
        return linear_apply(params["o"], o.reshape(*lead, h * hd), cfg), None

    if "k_pages" in cache:
        if cache_pos is None or block_table is None:
            raise ValueError("paged caches are decode-only and need "
                             "cache_pos and a block table")
        o = _paged_decode(q, k, v, cache, cache_pos, block_table, cfg)
        y = linear_apply(params["o"], o.reshape(*lead, h * hd), cfg)
        return y, cache

    opt = cfg.cache_layout == "opt"
    k_c, v_c = cache["k"], cache["v"]
    cache_len = k_c.shape[2] if opt else k_c.shape[1]
    rolling = bool(cfg.sliding_window) and cache_len <= cfg.sliding_window
    new_cache = cache
    if cache_pos is None:
        o = _prefill(q, k, v, k_c, v_c, cfg, opt, rolling)
    elif k.shape[1] > 1:
        # window: every token's K/V is stored before any query attends,
        # and causality keeps token j off positions past cache_pos + j. A
        # garbage row running past the cache's end stores its overflow at
        # the last position, as the decode step clamps its garbage lanes
        if opt or rolling:
            raise ValueError("a decode window needs a non-rolling bshd or "
                             "flat cache; LM.decode_step unrolls the rest")
        pos2d = _window_positions(cache_pos, k.shape[0],
                                  k.shape[1]).clamp(max=cache_len - 1)
        rows = torch.arange(k.shape[0], device=k.device)[:, None]
        k_c[rows, pos2d] = _store_view(k, k_c).to(k_c.dtype)
        v_c[rows, pos2d] = _store_view(v, v_c).to(v_c.dtype)
        o = naive_attention(q, _cache_view(k_c, cfg), _cache_view(v_c, cfg),
                            causal=True, window=cfg.sliding_window,
                            q_offset=cache_pos)
    elif opt:
        o = delta_decode_attention(
            q, k_c, v_c, k.to(k_c.dtype), v.to(v_c.dtype),
            cache_pos=cache_pos, rolling=rolling, window=cfg.sliding_window)
        new_cache = {"k_tok": k.transpose(1, 2).to(k_c.dtype),
                     "v_tok": v.permute(0, 2, 3, 1).to(v_c.dtype)}
    else:
        slot = cache_pos % cache_len if rolling else cache_pos
        tok_k, tok_v = _store_view(k, k_c)[:, 0], _store_view(v, v_c)[:, 0]
        if slot.ndim:
            rows = torch.arange(k.shape[0], device=k.device)
            k_c[rows, slot] = tok_k.to(k_c.dtype)
            v_c[rows, slot] = tok_v.to(v_c.dtype)
        else:
            k_c[:, slot] = tok_k.to(k_c.dtype)
            v_c[:, slot] = tok_v.to(v_c.dtype)
        if rolling:
            # slot i holds position pos - ((pos - i) mod cache_len): every
            # stored one lies inside the window, so the valid count alone
            # masks (on the device: a captured step reads no host value)
            valid, win = torch.clamp(cache_pos + 1, max=cache_len), 0
        else:
            valid, win = cache_pos + 1, cfg.sliding_window
        o = naive_attention(q, _cache_view(k_c, cfg), _cache_view(v_c, cfg),
                            causal=False, window=win, q_offset=cache_pos,
                            kv_valid_len=valid)
    y = linear_apply(params["o"], o.reshape(*lead, h * hd), cfg)
    return y, new_cache


def _prefill(q, k, v, k_c, v_c, cfg: ModelConfig, opt: bool,
             rolling: bool) -> torch.Tensor:
    """Write a prompt's K/V into a fresh cache in place and attend (see
    ``attn_apply``). K/V are rounded to the cache dtype first, so what the
    prompt attends is what later readers of those positions read."""
    k = k.to(k_c.dtype).to(k.dtype)
    v = v.to(v_c.dtype).to(v.dtype)
    s = k.shape[1]
    if opt:
        ks, vs = k.transpose(1, 2), v.permute(0, 2, 3, 1)   # (B,KV,S,hd|hd,S)
        cache_len, seq_k, seq_v = k_c.shape[2], 2, 3
    else:
        ks, vs = _store_view(k, k_c), _store_view(v, v_c)
        cache_len, seq_k, seq_v = k_c.shape[1], 1, 1
    if s > cache_len and not rolling:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                         f"{cache_len} positions")
    if s > cache_len:
        # a rolling cache keeps the last cache_len tokens, token p at slot
        # p % cache_len, so a decode at pos = s writes the oldest one
        shift = (s - cache_len) % cache_len
        k_c.copy_(torch.roll(ks.narrow(seq_k, s - cache_len, cache_len),
                             shift, dims=seq_k))
        v_c.copy_(torch.roll(vs.narrow(seq_v, s - cache_len, cache_len),
                             shift, dims=seq_v))
        return _full_sequence(q, k, v, cfg)
    k_c.narrow(seq_k, 0, s).copy_(ks)
    v_c.narrow(seq_v, 0, s).copy_(vs)
    if opt:
        return _full_sequence(q, k, v, cfg)
    # attend the written cache view (its full width, the stale tail masked
    # as future), the reduction the decode and window readers of these
    # positions run, never the blockwise or B6 kernels
    return naive_attention(q, _cache_view(k_c, cfg), _cache_view(v_c, cfg),
                           causal=True, window=cfg.sliding_window)


def opt_decode_attention(q, k_cache, v_cache, *, kv_valid_len, window=0,
                         q_offset=0) -> torch.Tensor:
    """Decode attention on the ``opt`` layouts: q (B, 1, H, hd); k_cache
    (B, KV, S, hd); v_cache (B, KV, hd, S); ``kv_valid_len`` / ``q_offset``
    ints or 0-d tensors. Both products contract the minor dimension."""
    b, sq, h, hd = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    scores = torch.einsum("bqkgd,bksd->bkgqs", qg.float(),
                          k_cache.float()) * (1.0 / math.sqrt(hd))
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos < torch.as_tensor(kv_valid_len, device=q.device)
    if window:
        mask = mask & ((torch.as_tensor(q_offset, device=q.device) - k_pos)
                       < window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bkds->bqkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def delta_decode_attention(q, k_cache, v_cache, k_tok, v_tok, *,
                           cache_pos: torch.Tensor, rolling: bool,
                           window: int = 0) -> torch.Tensor:
    """Decode attention without writing the cache: the stale ``opt`` cache
    (the current position masked out) plus the fresh token's own term,
    one softmax over both — what attending the written cache gives. q
    (B, 1, H, hd); k_cache (B, KV, S, hd); v_cache (B, KV, hd, S); k_tok,
    v_tok (B, 1, KV, hd); ``cache_pos`` a scalar or (B,) tensor."""
    b, sq, h, hd = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd).float()
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgd,bksd->bkgqs", qg, k_cache.float()) * scale
    cp = cache_pos.reshape(-1, 1)                  # (1, 1) or (B, 1)
    idx = torch.arange(s, device=q.device)[None]  # (1, S)
    if rolling:
        mask = torch.where(cp >= s, idx != cp % s, idx < cp)
    else:
        mask = idx < cp
        if window:
            mask = mask & ((cp - idx) < window)
    scores = torch.where(mask[:, None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    self_score = torch.einsum("bqkgd,bqkd->bkgq", qg, k_tok.float()) * scale
    m = torch.maximum(scores.amax(dim=-1), self_score)     # (B, KV, G, 1)
    p_cache = torch.exp(scores - m[..., None])
    p_self = torch.exp(self_score - m)
    denom = p_cache.sum(dim=-1) + p_self
    o = torch.einsum("bkgqs,bkds->bqkgd", p_cache.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o + torch.einsum("bkgq,bqkd->bqkgd", p_self.to(q.dtype).float(),
                         v_tok.float())
    o = o / denom.permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _cache_view(c: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, KV*hd) ``flat`` storage -> the (B, S, KV, hd) compute view."""
    if c.ndim == 3:
        return c.view(c.shape[0], c.shape[1], cfg.num_kv_heads,
                      cfg.head_dim)
    return c


def _store_view(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, S, KV, hd) K or V -> the shape cache ``c`` stores a token in:
    (B, S, KV*hd) for ``flat`` storage, unchanged for ``bshd``."""
    return t.reshape(*t.shape[:2], *c.shape[2:])


def _full_sequence(q, k, v, cfg: ModelConfig,
                   causal: bool = True) -> torch.Tensor:
    """Attention of (B, S, H, hd) q over its own K/V, causal or not (the
    encoder), with the config's sliding window (``repro``'s no-cache
    branch, ``attention.py:433-466``: B6 never takes a window)."""
    h = q.shape[2]
    window = cfg.sliding_window
    if cfg.attn_impl == "pallas" and not window:
        if k.shape[2] < h:
            k = k.repeat_interleave(h // k.shape[2], dim=2)
            v = v.repeat_interleave(h // v.shape[2], dim=2)
        b, s, _, hd = q.shape

        def heads(t):
            return t.transpose(1, 2).reshape(b * h, s, hd).contiguous()

        o = flash_lib.flash_attention(
            heads(q), heads(k), heads(v), causal=causal,
            block_q=min(cfg.attn_block_q, 512),
            block_kv=min(cfg.attn_block_kv, 512))
        return o.reshape(b, h, s, hd).transpose(1, 2)
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=causal, window=window,
                               block_q=cfg.attn_block_q,
                               block_kv=cfg.attn_block_kv)
    return naive_attention(q, k, v, causal=causal, window=window)


def _window_positions(cache_pos: torch.Tensor, b: int,
                      sq: int) -> torch.Tensor:
    """(B, S) positions ``cache_pos[b] + j`` of a window's tokens, in
    ``cache_pos``'s dtype."""
    base = cache_pos[:, None] if cache_pos.ndim else cache_pos
    steps = torch.arange(sq, dtype=cache_pos.dtype, device=cache_pos.device)
    return (base + steps).expand(b, sq)


def _paged_decode(q, k, v, cache: dict, cache_pos: torch.Tensor,
                  block_table: torch.Tensor, cfg: ModelConfig):
    """Write each token's K/V (quantized first for int8 pages) at
    ``block_table[row, pos // ps]``, offset ``pos % ps``, in place, then
    attend the row's pages through the registry row
    ``cfg.paged_attn_impl``. Live rows write to pages they own alone (the
    pool copies shared pages on write first); free slots' table rows are
    all zero, so their garbage writes land in the trash page 0. A window
    (S > 1) writes all S tokens first, then runs B5 over the B*S rows,
    row (b, j) reading ``block_table[b]`` up to ``pos[b] + j + 1``."""
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    ps = k_pages.shape[1]
    b, sq = k.shape[:2]
    if sq == 1:
        rows = torch.arange(b, device=k.device)
        pids = block_table[rows, cache_pos // ps]
        offs = cache_pos % ps
        toks = (k[:, 0], v[:, 0])
    else:
        pos2d = _window_positions(cache_pos, b, sq)
        rows = torch.arange(b, device=k.device)[:, None]
        pids = block_table[rows, pos2d // ps]
        offs = pos2d % ps
        toks = (k, v)
    for pages, tok in zip((k_pages, v_pages), toks):
        if isinstance(pages, Int8Pages):
            codes, scales = quantize_rows(tok)
            pages.codes[pids, offs] = codes
            pages.scales[pids, offs] = scales
        else:
            pages[pids, offs] = tok.to(pages.dtype)
    if sq == 1:
        o = ops.paged_decode_attention(q[:, 0], k_pages, v_pages,
                                       block_table, cache_pos + 1,
                                       window=cfg.sliding_window,
                                       impl=cfg.paged_attn_impl)
        return o[:, None]
    h, hd = q.shape[2:]
    o = ops.paged_decode_attention(
        q.reshape(b * sq, h, hd), k_pages, v_pages,
        block_table.repeat_interleave(sq, dim=0),
        (pos2d + 1).reshape(-1), window=cfg.sliding_window,
        impl=cfg.paged_attn_impl)
    return o.reshape(b, sq, h, hd)


def init_paged_kv_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                        dtype=torch.bfloat16, kv_dtype: Optional[str] = None,
                        device="cpu") -> dict:
    """One layer's pages: K and V as (n_pages, page_size, KV, hd) tensors
    of ``dtype``, or ``Int8Pages`` for ``kv_dtype="int8"``. Page 0 is the
    pool's trash page for free slots' garbage writes."""
    shape = (n_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        return {"k_pages": Int8Pages.zeros(shape, device),
                "v_pages": Int8Pages.zeros(shape, device)}
    if kv_dtype is not None:
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu") -> dict:
    """One layer's dense cache. A sliding-window model keeps a rolling
    cache of ``min(max_len, window)`` positions. Layouts
    (``cfg.cache_layout`` / ``cfg.decode_cache_shard``): ``bshd`` K and V
    (B, S, KV, hd); ``opt`` K (B, KV, S, hd) and V (B, KV, hd, S), the
    products' contracted dimension minor; ``flat`` (B, S, KV*hd)."""
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.cache_layout == "opt":
        k_shape, v_shape = (batch, kv, s, hd), (batch, kv, hd, s)
    elif cfg.decode_cache_shard == "flat":
        k_shape = v_shape = (batch, s, kv * hd)
    else:
        k_shape = v_shape = (batch, s, kv, hd)
    return {"k": torch.zeros(k_shape, dtype=dtype, device=device),
            "v": torch.zeros(v_shape, dtype=dtype, device=device)}
