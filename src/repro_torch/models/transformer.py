"""The LM of the port: a Python loop over per-layer parameter dicts where
``repro`` scans stacked ones. Every family ``repro`` builds: dense and MoE
attention stacks, the SSM family and the hybrid (attention + SSM, MLP +
MoE) family, each decoder layer an (``attn`` | ``ssm``) mixer and an
(``mlp`` | ``moe`` | ``none``) FFN as ``cfg.layer_kind`` /
``cfg.layer_ffn`` say; the encoder-decoder family (``cfg.enc_layers``
non-causal encoder blocks over the batch's ``enc_embeds``, and a
cross-attention in every decoder block) and the VLM family (the batch's
``vision_embeds`` rows prepended to the embedded tokens).

    m = LM(cfg, device="cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = m.loss(params, {"tokens": toks, "targets": tgts})
    cache, logits = m.prefill(params, {"tokens": toks}, max_len)
    logits, cache = m.decode_step(params, cache, next_tokens)

Parameter tree: ``{"embed": {"table"}, "layers": [{"norm1", "mixer",
"norm2", "ffn"}, ...], "final_norm", "unembed"}``: the mixer ``{q, k, v,
o}`` (attention) or ``{in_proj, out_proj, conv_w, ...}`` (SSM), the FFN
``{in, gate, out}`` (MLP) or ``{router, w_in, w_gate, w_out, ...}`` (MoE),
with ``{"w"}`` (and ``{"b"}``) latent or ``{"w_packed": Dense2Bit}``
linears (the bias inside the container) and latent or ``Dense2Bit``
expert banks. An encoder-decoder adds ``"enc_layers"`` (attention + MLP
blocks, ``repro``'s stacked ``enc_block``) and ``"enc_norm"``, and
``"norm_cross"`` + ``"cross"`` ``{q, k, v, o}`` to every decoder block.
``period`` and ``block_kinds`` are ``repro``'s: layer ``g * period + j``
is ``repro``'s ``block{j}`` of group ``g``.

``param_specs(cfg, params)`` is the tree's logical spec twin, ``repro``'s
``init_with_specs`` specs laid over the port's per-layer list for every
family (q/k/v, up and gate ``("fsdp", "model")``, o and down ``("model",
"fsdp")``, the embedding table ``("model", "fsdp")``, the lm head
``("fsdp", "model")``, norms ``(None,)``, the SSM mixer's and the MoE
banks' as ``repro`` writes them); ``distributed.tp.shard_params``
resolves it. A model
whose ``comm`` is a ``distributed.tp.Group`` runs its forward, loss,
prefill and decode calls inside that group (a tensor-parallel rank, whose
config holds its local head counts: ``tp.local_config``).

Caches: ``{"layers": [per layer], "pos": int32 tensor}``, ``pos`` a scalar
or a (B,) vector of per-slot positions, and an encoder-decoder's prefill
adds ``"enc_out"`` (B, S_enc, d), from which every decode step projects
the cross K/V again in every layer, as ``repro``'s does. An attention
layer holds ``{"k", "v"}`` in the config's layout
(``attention.init_kv_cache``: ``bshd``, ``flat`` or ``opt``, rolling when
the model has a sliding window), or ``{"k_pages", "v_pages"}`` in a paged
cache (``init_paged_cache``, decoded with a ``"block_table"`` entry beside
``"pos"``); an SSM layer holds per-row ``{"state", "conv"}`` in both. A
VLM's vision rows take the first cache positions.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import weights
from repro_torch.device import resolve_device
from repro_torch.distributed import tp as tp_lib
from repro_torch.distributed.sharding import EXPERT, FSDP, MODEL
from repro_torch.models import attention, layers, moe, ssm


def layer_period(cfg: ModelConfig) -> int:
    """``repro``'s period: the smallest p with L % p == 0 over which the
    layers' (mixer, ffn) kinds repeat; its ``block{j}`` stacks layers
    ``g * p + j``."""
    kinds = [(cfg.layer_kind(i), cfg.layer_ffn(i))
             for i in range(cfg.num_layers)]
    p = 1
    while p <= cfg.num_layers:
        if cfg.num_layers % p == 0 and all(
                kinds[i] == kinds[i % p] for i in range(cfg.num_layers)):
            break
        p += 1
    return p


def param_specs(cfg: ModelConfig, params: Optional[dict] = None) -> dict:
    """The logical spec twin of an ``LM``'s parameter tree (module
    docstring): one spec per tensor, a tuple of axis entries, and for a
    packed linear ``layers.linear_spec(..., packed=True)``'s twin, for a
    packed expert bank ``{"packed", "scale", "bias"}``. Every family, as
    ``repro``'s ``init_with_specs`` writes them: attention (self, cross
    and the encoder's) q/k/v ``("fsdp", "model")`` and o ``("model",
    "fsdp")``; the SSM mixer's in_proj ``("fsdp", "model")``, out_proj
    ``("model", "fsdp")``, conv and ``norm_scale`` on ``"model"``, its
    per-head vectors whole; a MoE node's router whole, its banks
    ``("expert", "fsdp", "model")`` / ``("expert", "model", "fsdp")``
    and its shared expert as an MLP. With ``params`` the twin follows its
    packed and biased linears and packed banks; without, the latent tree
    ``LM.init`` draws."""
    F, M, E = FSDP, MODEL, EXPERT

    def lin(p, name, in_axis, out_axis, bias=None):
        node = None if p is None else p[name]
        if node is None:
            return layers.linear_spec(in_axis, out_axis,
                                      cfg.use_bias if bias is None else bias)
        wc = node.get("w_packed")
        if wc is not None:
            return layers.linear_spec(in_axis, out_axis,
                                      wc.bias is not None, packed=True)
        return layers.linear_spec(in_axis, out_axis, "b" in node)

    def norm():
        return ({"scale": (None,), "bias": (None,)}
                if cfg.norm_type == "layernorm" else {"scale": (None,)})

    def attn(p):
        return {"q": lin(p, "q", F, M), "k": lin(p, "k", F, M),
                "v": lin(p, "v", F, M), "o": lin(p, "o", M, F)}

    def ssm_mixer(p):
        return {"in_proj": lin(p, "in_proj", F, M),
                "out_proj": lin(p, "out_proj", M, F),
                "conv_w": (None, M), "conv_b": (M,), "a_log": (None,),
                "dt_bias": (None,), "d_skip": (None,), "norm_scale": (M,)}

    def bank(p, name, spec, scale):
        if p is not None and isinstance(p[name], weights.TernaryWeight):
            return {"packed": spec, "scale": scale, "bias": None}
        return spec

    def moe_ffn(p):
        out = {"router": (None, None),
               "w_in": bank(p, "w_in", (E, F, M), (E, M)),
               "w_gate": bank(p, "w_gate", (E, F, M), (E, M)),
               "w_out": bank(p, "w_out", (E, M, F), (E, F))}
        if cfg.n_shared_experts:
            out.update(shared_in=(F, M), shared_gate=(F, M),
                       shared_out=(M, F))
        return out

    def block(lp, kind, ffn, cross):
        get = (lambda k: None) if lp is None else lp.get
        spec = {"norm1": norm(),
                "mixer": attn(get("mixer")) if kind == "attn"
                else ssm_mixer(get("mixer"))}
        if cross:
            spec["norm_cross"] = norm()
            spec["cross"] = attn(get("cross"))
        if ffn != "none":
            spec["norm2"] = norm()
            f = get("ffn")
            spec["ffn"] = moe_ffn(f) if ffn == "moe" else {
                "in": lin(f, "in", F, M), "gate": lin(f, "gate", F, M),
                "out": lin(f, "out", M, F)}
        return spec

    def nth(name, i):
        return None if params is None else params[name][i]

    specs = {"embed": {"table": (M, F)},
             "layers": [block(nth("layers", i), cfg.layer_kind(i),
                              cfg.layer_ffn(i), cfg.is_encdec)
                        for i in range(cfg.num_layers)]}
    if cfg.is_encdec:
        specs["enc_layers"] = [block(nth("enc_layers", i), "attn", "mlp",
                                     False) for i in range(cfg.enc_layers)]
        specs["enc_norm"] = norm()
    specs["final_norm"] = norm()
    if not cfg.tie_embeddings:
        specs["unembed"] = lin(params, "unembed", F, M, bias=False)
    return specs


def _in_group(fn):
    """Run an ``LM`` call inside the model's tensor-parallel group."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self.comm is None:
            return fn(self, *args, **kwargs)
        with tp_lib.bound(self.comm):
            return fn(self, *args, **kwargs)
    return wrapped


class LM:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # a distributed.tp.Group when this model is a tensor-parallel rank
        self.comm = None
        self.kinds = [(cfg.layer_kind(i), cfg.layer_ffn(i))
                      for i in range(cfg.num_layers)]
        self.period = layer_period(cfg)
        self.block_kinds = self.kinds[:self.period]  # [(mixer, ffn)] * p

    # ------------------------------------------------------------------
    def _block_init(self, g: torch.Generator, kind: str, ffn: str,
                    cross: bool) -> dict:
        cfg = self.cfg
        bp = {"norm1": layers.norm_init(g, cfg, cfg.d_model),
              "mixer": (attention.attn_init(g, cfg) if kind == "attn"
                        else ssm.ssm_init(g, cfg))}
        if cross:
            bp["norm_cross"] = layers.norm_init(g, cfg, cfg.d_model)
            bp["cross"] = attention.attn_init(g, cfg)
        if ffn != "none":
            bp["norm2"] = layers.norm_init(g, cfg, cfg.d_model)
            bp["ffn"] = (moe.moe_init(g, cfg) if ffn == "moe"
                         else layers.mlp_init(g, cfg, cfg.d_ff))
        return bp

    def init(self, generator: torch.Generator, layer_fn=None) -> dict:
        """Random latent parameters drawn from ``generator`` on its device
        (which must be this model's). ``layer_fn`` maps each layer's
        parameters (decoder and encoder blocks alike) as they are drawn
        (e.g. ``layers.pack_params``), so a model whose latent weights
        would not fit at once is packed layer by layer."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator lies on {generator.device}, the "
                             f"model on {self.device}")
        cfg, g = self.cfg, generator
        fn = layer_fn or (lambda bp: bp)
        # draw order: decoder blocks, encoder blocks, then the rest (a
        # decoder-only model's draws are those of the port before the
        # encoder was added)
        blocks = [fn(self._block_init(g, kind, ffn, cfg.is_encdec))
                  for kind, ffn in self.kinds]
        enc = [fn(self._block_init(g, "attn", "mlp", False))
               for _ in range(cfg.enc_layers)]
        params = {"embed": layers.embed_init(g, cfg), "layers": blocks}
        if cfg.is_encdec:
            params["enc_layers"] = enc
            params["enc_norm"] = layers.norm_init(g, cfg, cfg.d_model)
        params["final_norm"] = layers.norm_init(g, cfg, cfg.d_model)
        if not cfg.tie_embeddings:
            params["unembed"] = layers.unembed_init(g, cfg)
        return params

    # ------------------------------------------------------------------
    def _apply_block(self, bp, x, kind, ffn, *, positions, cache, cache_pos,
                     block_table, causal=True, enc_out=None):
        cfg = self.cfg
        h = layers.norm_apply(bp["norm1"], x, cfg)
        if kind == "attn":
            h, new_cache = attention.attn_apply(
                bp["mixer"], h, cfg, positions=positions, causal=causal,
                cache=cache, cache_pos=cache_pos, block_table=block_table)
        else:
            h, new_cache = ssm.ssm_apply(bp["mixer"], h, cfg, cache=cache,
                                         cache_pos=cache_pos)
        x = x + h
        if enc_out is not None and "cross" in bp:
            # the cross K/V are projected from the encoder's output here,
            # every call (repro's _apply_block, transformer.py:165-175)
            hc = layers.norm_apply(bp["norm_cross"], x, cfg)
            lead = enc_out.shape[:-1]
            kv, hd = cfg.num_kv_heads, cfg.head_dim
            # a head-split rank's cross K/V are a column-split region too
            enc_in = layers.region_input(enc_out, bp["cross"]["k"])
            ek = layers.linear_apply(bp["cross"]["k"], enc_in, cfg)
            ev = layers.linear_apply(bp["cross"]["v"], enc_in, cfg)
            hc, _ = attention.attn_apply(
                bp["cross"], hc, cfg, positions=positions,
                kv_override=(ek.reshape(*lead, kv, hd),
                             ev.reshape(*lead, kv, hd)))
            x = x + hc
        aux = None
        if ffn != "none":
            h2 = layers.norm_apply(bp["norm2"], x, cfg)
            if ffn == "moe":
                h2, aux = moe.moe_apply(bp["ffn"], h2, cfg)
            else:
                h2 = layers.mlp_apply(bp["ffn"], h2, cfg)
            x = x + h2
        return x, new_cache, aux

    def _apply_block_in_group(self, *args, **kwargs):
        with tp_lib.bound(self.comm):
            return self._apply_block(*args, **kwargs)

    def _run_stack(self, params, x, *, positions, caches=None,
                   cache_pos=None, block_table=None, enc_out=None):
        """``caches=None`` runs the full-sequence (training) stack; each
        block is then recomputed in the backward when ``cfg.remat ==
        "full"`` and a gradient is being taken — as ``repro`` remats only
        where there is a backward pass. Returns (x, new caches, aux): the
        MoE aux losses summed per group of ``period`` layers, then over
        the groups, as ``repro``'s scan sums them (0 without MoE layers;
        the layers without an aux add nothing, where ``repro`` adds 0)."""
        remat = (caches is None and self.cfg.remat == "full"
                 and torch.is_grad_enabled())
        # the backward's recomputation runs outside the call's group scope
        block = self._apply_block if self.comm is None \
            else self._apply_block_in_group
        new_caches = []
        aux_total = group = None
        for i, bp in enumerate(params["layers"]):
            kind, ffn = self.kinds[i]
            kw = dict(positions=positions,
                      cache=None if caches is None else caches[i],
                      cache_pos=cache_pos, block_table=block_table,
                      enc_out=enc_out)
            if remat:
                x, nc, aux = torch_checkpoint.checkpoint(
                    block, bp, x, kind, ffn, use_reentrant=False, **kw)
            else:
                x, nc, aux = self._apply_block(bp, x, kind, ffn, **kw)
            if aux is not None:
                group = aux if group is None else group + aux
            if (i + 1) % self.period == 0 and group is not None:
                aux_total = group if aux_total is None else aux_total + group
                group = None
            new_caches.append(nc)
        if aux_total is None:
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, new_caches, aux_total

    def _run_encoder(self, params, enc_x):
        """The encoder blocks over (B, S_enc, d) ``enc_x``, non-causal and
        cacheless, then ``enc_norm`` (``repro``'s ``_run_encoder``); each
        block is recomputed in the backward under ``cfg.remat == "full"``
        when a gradient is being taken."""
        positions = torch.arange(enc_x.shape[1], device=enc_x.device).expand(
            enc_x.shape[0], -1)
        remat = self.cfg.remat == "full" and torch.is_grad_enabled()
        kw = dict(positions=positions, cache=None, cache_pos=None,
                  block_table=None, causal=False)
        # the backward's recomputation runs outside the call's group scope
        block = self._apply_block if self.comm is None \
            else self._apply_block_in_group
        x = enc_x
        for bp in params["enc_layers"]:
            if remat:
                x = torch_checkpoint.checkpoint(
                    block, bp, x, "attn", "mlp",
                    use_reentrant=False, **kw)[0]
            else:
                x = self._apply_block(bp, x, "attn", "mlp", **kw)[0]
        return layers.norm_apply(params["enc_norm"], x, self.cfg)

    def _inputs(self, params, batch):
        """(x (B, S, d), n_front, enc_out): the embedded tokens after a
        VLM's ``vision_embeds`` rows (``n_front`` of them, cast to the
        activations' dtype), and an encoder-decoder's encoder output over
        its ``enc_embeds`` (else None)."""
        cfg = self.cfg
        x = layers.embed_apply(params["embed"], batch["tokens"], cfg)
        n_front = 0
        if "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(x.dtype)
            x = torch.cat([ve, x], dim=1)
            n_front = ve.shape[1]
        enc_out = None
        if cfg.is_encdec:
            enc_out = self._run_encoder(params,
                                        batch["enc_embeds"].to(x.dtype))
        return x, n_front, enc_out

    def _logits(self, params, x):
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["table"].to(x.dtype).T
        return layers.unembed_apply(params["unembed"], x, self.cfg)

    def param_specs(self, params: Optional[dict] = None) -> dict:
        """``param_specs(self.cfg, params)``."""
        return param_specs(self.cfg, params)

    # ------------------------------------------------------------------
    @_in_group
    def forward(self, params, batch):
        """Full-sequence forward -> (hidden (B, S, D), n_frontend: the
        vision rows in front of the text, aux f32: the MoE layers'
        load-balancing loss, 0 without them)."""
        cfg = self.cfg
        x, n_front, enc_out = self._inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[0], -1)
        x, _, aux = self._run_stack(params, x, positions=positions,
                                    enc_out=enc_out)
        x = layers.norm_apply(params["final_norm"], x, cfg)
        return x, n_front, aux

    @_in_group
    def loss(self, params, batch):
        """Causal-LM cross-entropy, chunked over the sequence when
        ``cfg.logits_chunk`` divides it -> (loss, {"loss", "ce", "aux"})."""
        cfg = self.cfg
        x, n_front, aux = self.forward(params, batch)
        x = x[:, n_front:]
        targets = batch["targets"].long()

        def ce_of(xc, tc):
            logits = self._logits(params, xc).float()
            gold = logits.gather(-1, tc[..., None])[..., 0]
            return torch.logsumexp(logits, dim=-1) - gold

        chunk = cfg.logits_chunk
        if chunk and x.shape[1] % chunk == 0:
            ce = torch.cat([ce_of(x[:, i:i + chunk], targets[:, i:i + chunk])
                            for i in range(0, x.shape[1], chunk)], dim=1)
        else:
            ce = ce_of(x, targets)
        loss = ce.mean() + 0.01 * aux
        return loss, {"loss": loss, "ce": ce.mean(), "aux": aux}

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        cfg = self.cfg
        dtype = layers.dtype_of(cfg.cache_dtype) if dtype is None else dtype
        return {"layers": [
            attention.init_kv_cache(cfg, batch, max_len, dtype, self.device)
            if kind == "attn" else
            ssm.init_ssm_cache(cfg, batch, dtype, self.device)
            for kind, _ in self.kinds],
            "pos": torch.zeros((), dtype=torch.int32, device=self.device)}

    def cache_specs(self) -> dict:
        """``repro``'s logical spec tree of ``init_cache``'s output, laid
        over the port's per-layer list (no stacked group axis): the batch
        over ``("pod", "data")``; an attention layer's sequence over
        ``"model"`` (its head dim under ``decode_cache_shard="heads"``,
        its channels under ``"flat"``, the new position's axis of an
        ``opt`` layout); an SSM layer's conv channels over ``"model"``;
        ``pos`` whole. ``sharding.resolve_specs`` resolves it."""
        cfg = self.cfg
        dp = ("pod", "data")
        seq_ax, hd_ax = MODEL, None
        if cfg.decode_cache_shard == "heads":
            seq_ax, hd_ax = None, MODEL
        specs = []
        for kind, _ in self.kinds:
            if kind != "attn":
                specs.append({"state": (dp, None, None, None),
                              "conv": (dp, None, MODEL)})
            elif cfg.cache_layout == "opt":
                specs.append({"k": (dp, None, seq_ax, None),
                              "v": (dp, None, None, seq_ax)})
            elif cfg.decode_cache_shard == "flat":
                specs.append({"k": (dp, None, MODEL), "v": (dp, None, MODEL)})
            else:
                specs.append({"k": (dp, seq_ax, None, hd_ax),
                              "v": (dp, seq_ax, None, hd_ax)})
        return {"layers": specs, "pos": ()}

    def init_paged_cache(self, n_pages: int, page_size: int, batch: int,
                         dtype=None, kv_dtype=None) -> dict:
        """Attention layers: page tensors shared by all slots and indexed
        through per-slot block tables (owned by
        ``repro_torch.paging.PagePool``); SSM layers keep their O(1)
        per-slot rows (``batch`` of them), as ``repro``'s do."""
        cfg = self.cfg
        dtype = layers.dtype_of(cfg.cache_dtype) if dtype is None else dtype
        return {"layers": [
            attention.init_paged_kv_cache(cfg, n_pages, page_size, dtype,
                                          kv_dtype, self.device)
            if kind == "attn" else
            ssm.init_ssm_cache(cfg, batch, dtype, self.device)
            for kind, _ in self.kinds]}

    @staticmethod
    def insert_cache(pool_layers: List[Dict[str, torch.Tensor]],
                     req_layers: List[Dict[str, torch.Tensor]],
                     slots) -> List[Dict[str, torch.Tensor]]:
        """Write a freshly prefilled k-request cache (batch dim k, same
        max_len) into the batch rows ``slots`` of a pool cache, in place:
        every leaf of each layer (K/V, or SSM state and conv)."""
        for big, small in zip(pool_layers, req_layers):
            idx = None
            for name, t in big.items():
                if idx is None:
                    idx = torch.as_tensor(slots, device=t.device).reshape(-1)
                t[idx] = small[name].to(t.dtype)
        return pool_layers

    @_in_group
    def prefill(self, params, batch, max_len: int,
                cache_dtype=torch.bfloat16, logits_from: int = -1):
        """Run the prompt, fill the caches, return (cache, logits of the
        positions from ``logits_from`` on: by default the last, (B, 1,
        V)). ``cache_dtype`` defaults to bf16 whatever the config says, as
        ``repro``'s prefill does. A VLM's vision rows take the first
        positions (``max_len`` must hold them too); an encoder-decoder's
        cache keeps the encoder's output as ``"enc_out"``."""
        cfg = self.cfg
        x, _, enc_out = self._inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[0], -1)
        cache0 = self.init_cache(x.shape[0], max_len, cache_dtype)
        x, new_caches, _ = self._run_stack(params, x, positions=positions,
                                           caches=cache0["layers"],
                                           cache_pos=None, enc_out=enc_out)
        x = layers.norm_apply(params["final_norm"], x, cfg)
        logits = self._logits(params, x[:, logits_from:])
        cache = {"layers": new_caches,
                 "pos": torch.tensor(x.shape[1], dtype=torch.int32,
                                     device=x.device)}
        if enc_out is not None:
            cache["enc_out"] = enc_out
        return cache, logits

    def _decode_window_unrolled(self, cache) -> bool:
        """Whether a (B, S > 1) window must run as S one-token steps: the
        batched window (every token's K/V written, then attended causally)
        equals one-token steps only where a write cannot clobber what an
        earlier token of the window reads. Rolling sliding-window caches
        (a wrapped write overwrites the oldest live entry), the ``opt``
        delta-commit layout and SSM recurrences unroll; paged pools refuse
        the first two."""
        cfg = self.cfg
        if cfg.cache_layout == "opt" or any(
                kind == "ssm" for kind, _ in self.block_kinds):
            return True
        if "block_table" in cache:
            return False
        if cfg.sliding_window:
            return cache["layers"][0]["k"].shape[1] <= cfg.sliding_window
        return False

    @_in_group
    def decode_step(self, params, cache, tokens):
        """tokens (B, S) -> (logits (B, S, V), cache). S is 1 for plain
        decode; S > 1 is a window (a chunk of a prompt, a verify window)
        whose tokens sit at positions pos..pos+S-1, each position's logits
        those of the j-th of S one-token steps (rolling and ``opt`` caches
        run exactly those steps). ``cache["pos"]`` is a scalar or a (B,)
        vector of per-slot positions; the caches are written in place, an
        ``opt`` cache after the stack (each layer's token at ``pos``, or
        ``pos % cache_len`` when rolling). A ``cache["block_table"]`` entry
        switches the attention layers to the paged cache."""
        cfg = self.cfg
        pos = cache["pos"]
        sq = tokens.shape[1]
        if sq > 1 and self._decode_window_unrolled(cache):
            lgs, cur = [], cache
            for j in range(sq):
                lg, cur = self.decode_step(params, cur, tokens[:, j:j + 1])
                lgs.append(lg)
            return torch.cat(lgs, dim=1), cur
        x = layers.embed_apply(params["embed"], tokens, cfg)
        src = pos[:, None] if pos.ndim else pos
        if sq > 1:
            src = src + torch.arange(sq, dtype=pos.dtype, device=pos.device)
        positions = src.expand(tokens.shape)
        x, new_caches, _ = self._run_stack(
            params, x, positions=positions, caches=cache["layers"],
            cache_pos=pos, block_table=cache.get("block_table"),
            enc_out=cache.get("enc_out"))
        x = layers.norm_apply(params["final_norm"], x, cfg)
        logits = self._logits(params, x)
        if cfg.cache_layout == "opt":
            new_caches = self._commit_tokens(cache["layers"], new_caches,
                                             pos)
        return logits, dict(cache, layers=new_caches, pos=pos + sq)

    def _commit_tokens(self, layers, toks, pos):
        """Write each ``opt`` layer's ``{"k_tok", "v_tok"}`` into its cache
        in place at ``pos`` (``pos % cache_len`` when rolling), per row;
        returns the layers."""
        window = self.cfg.sliding_window
        for layer, tok in zip(layers, toks):
            if "k_tok" not in tok:               # an SSM layer's own cache
                continue
            k_c, v_c = layer["k"], layer["v"]
            s_len = k_c.shape[2]
            rolling = bool(window) and s_len <= window
            slot = (pos % s_len if rolling else pos).reshape(-1).expand(
                k_c.shape[0])
            rows = torch.arange(k_c.shape[0], device=k_c.device)
            k_c[rows, :, slot] = tok["k_tok"][:, :, 0]
            v_c[rows, :, :, slot] = tok["v_tok"][..., 0]
        return layers
