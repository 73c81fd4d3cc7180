"""The MLP block over every packed format, held against ``repro``: ``tiled``
packs run the fused block (B4 reads their words in place on the card; its
plain version here), ``bitplane`` and ``base3`` packs the chain of
``ternary_gemm`` calls, as ``repro`` routes them (``_FUSED_FORMATS``,
``_lower_fused_chain``). The oracle is ``repro``'s chain of ``impl="ref"``
GEMMs: its ``"chain"`` lowering would dispatch the tiled and bitplane
GEMMs to Pallas kernels in interpret mode.

Tolerances: in float32 the two packages add the same exact products in
another order (1e-5 of the output's magnitude). In bfloat16 each side
rounds yi/yg, the activation and the product to bf16 on the way, and a
sum taken in another order can land one bf16 ulp (2^-8) the other side
of a rounding boundary, so the block is held to 2^-6 of its magnitude,
as tests/test_torch_kernels.py holds the dense2bit block.

Also here: the reduced LM with ``tiled`` MLP packs (tiles emptied so the
skipping rows run) against ``repro``'s LM on the same ternary matrices,
and the numpy model of B7's fragment decode against the plain plane
decode.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import weights as rweights
from repro.kernels import ops as rops
from repro.models import LM as RLM
from repro_torch.core import formats, weights
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib
from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib
from repro_torch.models import LM

from test_torch_model import _packed_pair

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -6)}
FORMAT_OPTS = {"dense2bit": {}, "tiled": {"tile_k": 32, "tile_n": 16},
               "bitplane": {}, "base3": {}}
ACTS = {"silu": jax.nn.silu, "relu": jax.nn.relu, "none": lambda y: y}


def _close(got: torch.Tensor, ref, tol: float) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _weights(rng, k, ff, n, biased, sparse_tiles):
    """Ternary (in, gate, out) with per-channel scales; ``sparse_tiles``
    empties every other 32 x 16 tile so a tiled pack's skip rows plan."""
    ws = {}
    for name, (kk, nn) in (("in", (k, ff)), ("gate", (k, ff)),
                           ("out", (ff, n))):
        t = rng.integers(-1, 2, size=(kk, nn)).astype(np.int8)
        if sparse_tiles:
            for i in range(0, kk, 32):
                for j in range(0, nn, 16):
                    if (i // 32 + j // 16) % 2:
                        t[i:i + 32, j:j + 16] = 0
        s = rng.random(nn).astype(np.float32) * 0.1 + 0.02
        b = rng.standard_normal(nn).astype(np.float32) if biased else None
        ws[name] = (t, s, b)
    return ws


def _pack_both(ws, fmt):
    opts = FORMAT_OPTS[fmt]
    rw = {name: rweights.pack(t, fmt, scale=jnp.asarray(s),
                              bias=None if b is None else jnp.asarray(b),
                              **opts) for name, (t, s, b) in ws.items()}
    pw = {name: weights.pack(torch.from_numpy(t), fmt,
                             scale=torch.from_numpy(s),
                             bias=None if b is None else torch.from_numpy(b),
                             **opts) for name, (t, s, b) in ws.items()}
    return rw, pw


def _repro_chain(x, w_in, w_out, w_gate, activation):
    """repro's _lower_fused_chain with each GEMM pinned to its ref row."""
    yi = rops.ternary_gemm(x, w_in, impl="ref")
    if w_gate is not None:
        h = ACTS[activation](rops.ternary_gemm(x, w_gate, impl="ref")) * yi
    else:
        h = ACTS[activation](yi)
    return rops.ternary_gemm(h, w_out, impl="ref")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", ["tiled", "bitplane", "base3"])
@pytest.mark.parametrize("gated,activation,biased",
                         [(True, "silu", False), (True, "silu", True),
                          (False, "relu", True)])
def test_fused_mlp_formats_match_repro_chain(dtype, fmt, gated, activation,
                                             biased):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(7)
    m, k, ff, n = 6, 72, 100, 40       # tiled: K, ff and N tile-padded
    x = rng.standard_normal((m, k)).astype(np.float32)
    rw, pw = _pack_both(_weights(rng, k, ff, n, biased, fmt == "tiled"),
                        fmt)
    ref = _repro_chain(jnp.asarray(x, jdt), rw["in"], rw["out"],
                       rw["gate"] if gated else None, activation)
    got = ops.fused_mlp(torch.from_numpy(x).to(tdt), pw["in"], pw["out"],
                        pw["gate"] if gated else None, activation=activation)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    _close(got, ref, tol)


@pytest.mark.parametrize("up,down", [("dense2bit", "dense2bit"),
                                     ("tiled", "tiled"),
                                     ("tiled", "dense2bit"),
                                     ("bitplane", "bitplane"),
                                     ("base3", "base3"),
                                     ("tiled", "bitplane")])
def test_fused_route_follows_repro(up, down, monkeypatch):
    """The port fuses exactly when repro's predicate does: every
    projection dense2bit or tiled; otherwise the chain runs."""
    rng = np.random.default_rng(3)
    ws = _weights(rng, 64, 96, 32, False, True)
    rw, pw = {}, {}
    for name in ws:
        pair = _pack_both({name: ws[name]}, down if name == "out" else up)
        rw[name], pw[name] = pair[0][name], pair[1][name]
    want = rops._fusable(rw["in"], rw["out"], rw["gate"], 4, None)
    assert want == (up in ops.FUSED_FORMATS and down in ops.FUSED_FORMATS)
    assert ops._fusable(pw["in"], pw["out"], pw["gate"], 4, None) == want
    calls = []
    row = ops._FUSED["chain"]
    monkeypatch.setitem(ops._FUSED, "chain", dataclasses.replace(
        row, fn=lambda *a: calls.append(a) or torch.zeros(4, 32)))
    ops.fused_mlp(torch.zeros(4, 64), pw["in"], pw["out"], pw["gate"])
    assert len(calls) == (0 if want else 1)


def test_fused_mlp_gate_with_other_tiles_takes_the_chain():
    """A tiled gate whose tiles differ from the up projection's plans
    other blocks: repro sends the block to the chain, and so does the
    port; both agree with repro's ref chain."""
    rng = np.random.default_rng(5)
    ws = _weights(rng, 64, 96, 32, False, True)
    t, s, _ = ws["gate"]
    rw, pw = _pack_both(ws, "tiled")
    rw["gate"] = rweights.pack(t, "tiled", scale=jnp.asarray(s), tile_k=64,
                               tile_n=32)
    pw["gate"] = weights.pack(torch.from_numpy(t), "tiled",
                              scale=torch.from_numpy(s), tile_k=64,
                              tile_n=32)
    assert not rops._fusable(rw["in"], rw["out"], rw["gate"], 4, None)
    assert not ops._fusable(pw["in"], pw["out"], pw["gate"], 4, None)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    _close(ops.fused_mlp(torch.from_numpy(x), pw["in"], pw["out"],
                         pw["gate"]),
           _repro_chain(jnp.asarray(x), rw["in"], rw["out"], rw["gate"],
                        "silu"), 1e-5)


def test_skip_block_n_caps_the_decode_width():
    assert [gemm_lib.skip_block_n(tn) for tn in (16, 48, 64, 128, 256)] == \
        [16, 16, 64, 128, 128]
    assert [gemm_lib.skip_block_n(tn, 64) for tn in (16, 48, 64, 128)] == \
        [16, 16, 64, 64]


def _tiled_mlp_pair(num_layers=2):
    """repro's and the port's reduced packed LMs on the same ternary
    matrices, the port's MLPs re-packed as ``tiled`` with every third
    32 x 16 tile emptied (in repro's dense2bit packs too)."""
    rcfg, rparams, pcfg, pparams = _packed_pair("float32", num_layers)
    for name in ("in", "gate", "out"):
        rleaf = rparams["block0"]["ffn"][name]["w_packed"]
        mats, scales = [], []
        for i in range(num_layers):
            wc = pparams["layers"][i]["ffn"][name]["w_packed"]
            t = wc.materialize(torch.float32).to(torch.int8).numpy().copy()
            for a in range(0, t.shape[0], 32):
                for b in range(0, t.shape[1], 16):
                    if (a // 32 + b // 16 + i) % 3 == 0:
                        t[a:a + 32, b:b + 16] = 0
            tiled = weights.pack(torch.from_numpy(t), "tiled",
                                 scale=wc.scale, bias=wc.bias, tile_k=32,
                                 tile_n=16)
            assert tiled.occupancy() <= ops.SKIP_OCCUPANCY_CUTOFF
            pparams["layers"][i]["ffn"][name]["w_packed"] = tiled
            mats.append(t)
            scales.append(wc.scale.numpy())
        rparams["block0"]["ffn"][name]["w_packed"] = rweights.pack(
            np.stack(mats), "dense2bit", scale=jnp.asarray(np.stack(scales)),
            bias=rleaf.bias)
    return rcfg, rparams, pcfg, pparams


def test_tiled_mlp_lm_greedy_tokens_match_repro():
    """Prefill and three greedy decode steps, float32: the port's LM with
    tiled MLP packs (skip rows, their plain versions here) against
    repro's LM on the same matrices; logits within 1e-4 of their
    magnitude (the same sums in another order through 2 layers) and equal
    greedy tokens."""
    rcfg, rparams, pcfg, pparams = _tiled_mlp_pair()
    rng = np.random.default_rng(1)
    b, s, max_len = 2, 12, 20
    toks = rng.integers(0, rcfg.vocab_size, size=(b, s)).astype(np.int32)
    rlm, plm = RLM(rcfg), LM(pcfg, "cpu")
    rcache, rlog = rlm.prefill(rparams, {"tokens": jnp.asarray(toks)},
                               max_len, cache_dtype=jnp.float32)
    pcache, plog = plm.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                               max_len, cache_dtype=torch.float32)
    _close(plog, rlog, 1e-4)
    for _ in range(3):
        rnext = np.asarray(jnp.argmax(rlog[:, -1], axis=-1)).astype(np.int32)
        pnext = plog[:, -1].argmax(-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(pnext, rnext)
        rlog, rcache = rlm.decode_step(rparams, rcache,
                                       jnp.asarray(rnext[:, None]))
        plog, pcache = plm.decode_step(pparams, pcache,
                                       torch.from_numpy(pnext[:, None]))
        _close(plog, rlog, 1e-4)


def test_tiled_mlp_block_fuses_like_the_dense_block():
    """One layer's MLP of the tiled model through ops.fused_mlp (the fused
    row, plain version) equals the chain through ops.ternary_gemm in
    float32, and the same block packed dense2bit."""
    _, _, _, pparams = _tiled_mlp_pair(num_layers=1)
    ffn = pparams["layers"][0]["ffn"]
    wi, wg, wo = (ffn[n]["w_packed"] for n in ("in", "gate", "out"))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, wi.k)).astype(np.float32))
    got = ops.fused_mlp(x, wi, wo, wg)
    dense = [weights.pack(c.materialize(torch.float32).to(torch.int8),
                          scale=c.scale, bias=c.bias) for c in (wi, wo, wg)]
    chain = ops.fused_mlp(x, wi, wo, wg, impl="chain")
    torch.testing.assert_close(got, chain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, ops.fused_mlp(x, *dense), rtol=0,
                               atol=0)


# --- B7's register decode, modelled in numpy ---------------------------------

def _bf16_pair(words: np.ndarray):
    """uint32 bf16x2 words -> (low, high) float32 values."""
    lo = ((words & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (words & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo, hi


def _fragment_decode(plus: np.ndarray, minus: np.ndarray,
                     factorized_plane=None) -> np.ndarray:
    """The (kb * 8, n) matrix B7's lanes build: for each 64-deep step,
    16-deep chunk kk, column c and quad position t, registers b[0] and
    b[1] from the table, unpacked into the m16n8k16 B layout (b[0] holds
    rows 2t, 2t+1 of the chunk, b[1] rows 2t+8, 2t+9). With
    ``factorized_plane`` the index is that plane's two bits alone."""
    lut = np.asarray(bitplane_lib.PLANE_LUT, dtype=np.uint32)
    kb, n = plus.shape
    steps = -(-kb // 8)
    p = np.zeros((steps * 8, n), np.int64)
    m = np.zeros((steps * 8, n), np.int64)
    p[:kb], m[:kb] = plus, minus
    out = np.full((steps * 64, n), np.nan, np.float32)
    for s in range(steps):
        for kk in range(4):
            rows = bitplane_lib.fragment_byte_rows(kk)
            for t in range(4):
                for reg, r in enumerate(rows):
                    pb, mb = p[s * 8 + r], m[s * 8 + r]
                    if factorized_plane is None:
                        idx = bitplane_lib.fragment_index(pb, mb, t)
                    else:
                        plane = pb if factorized_plane == "plus" else mb
                        idx = bitplane_lib.fragment_index(plane, 0, t)
                    lo, hi = _bf16_pair(lut[idx])
                    k0 = s * 64 + kk * 16 + 2 * t + 8 * reg
                    out[k0], out[k0 + 1] = lo, hi
    return out


@pytest.mark.parametrize("k,n", [(64, 8), (200, 24), (37, 5)])
def test_b7_fragment_decode_matches_plane_decode(k, n):
    """Bit-exact on random planes, bytes where plus and minus both hold a
    bit (decode 0) included; each factorized fragment is its plane's 0/1
    matrix."""
    rng = np.random.default_rng(k + n)
    kb = -(-k // formats.K_PER_BYTE)
    plus = rng.integers(0, 256, size=(kb, n)).astype(np.uint8)
    minus = rng.integers(0, 256, size=(kb, n)).astype(np.uint8)
    assert np.any(plus & minus)
    zeros = torch.zeros(kb, n, dtype=torch.uint8)
    tp, tm = torch.from_numpy(plus), torch.from_numpy(minus)
    kp = kb * formats.K_PER_BYTE
    cases = [(None, formats.decode_bitplanes(tp, tm, kp, torch.float32)),
             ("plus", formats.decode_bitplanes(tp, zeros, kp, torch.float32)),
             ("minus", formats.decode_bitplanes(tm, zeros, kp,
                                                torch.float32))]
    for plane, ref in cases:
        got = _fragment_decode(plus, minus, plane)
        np.testing.assert_array_equal(got[:kp], ref.numpy())
        assert not got[kp:].any()


def test_b7_table_is_the_kernels_table():
    """PLANE_LUT is the literal kPlaneLut of csrc/ternary_gemm_bitplane.cu,
    and its entries are the bf16x2 (p - m) pairs."""
    src = (Path(bitplane_lib.__file__).parent / "csrc"
           / "ternary_gemm_bitplane.cu").read_text()
    body = re.search(r"kPlaneLut\[16\] = \{(.*?)\};", src, re.S).group(1)
    table = tuple(int(v, 16) for v in re.findall(r"0x([0-9A-Fa-f]+)u", body))
    assert table == bitplane_lib.PLANE_LUT
    lo, hi = _bf16_pair(np.asarray(table, np.uint32))
    v = np.arange(16)
    np.testing.assert_array_equal(lo, (v & 1) - ((v >> 2) & 1))
    np.testing.assert_array_equal(hi, ((v >> 1) & 1) - ((v >> 3) & 1))


def test_fused_formats_are_repros():
    assert ops.FUSED_FORMATS == rops._FUSED_FORMATS
