"""Tensor-parallel placement on the CPU against ``repro``: logical spec
resolution, the pack-boundary constraints and spec-twin validation, the
shard slicer, per-shard GEMM and fused-MLP plans field by field, and the
port's parameter spec twin against ``repro``'s ``init_with_specs``.

``repro``'s resolver and validator run on a stub mesh (``axis_names`` and
``shape``), so no fake devices are needed. Plans are compared on every
field but the tiles: the port's tuner keys a shard's own (K, N) and picks
the H100's kernel tiles (ROADMAP C12), where ``repro`` clamps its global
tiles to the shard; the port's shard plan's tiles are held equal to the
plan of the sliced container instead."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as rget_config
from repro.core import weights as rweights
from repro.distributed import sharding as rsharding
from repro.distributed import tp as rtp
from repro.kernels import ops as rops
from repro.models import LM as RLM

from repro_torch.configs import get_config
from repro_torch.core import weights
from repro_torch.distributed import sharding
from repro_torch.distributed import tp as tp_lib
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LM
from repro_torch.models.transformer import param_specs

from torch_cpu_threads import one_torch_thread  # noqa: F401


def _ternary(k, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, 2, size=(k, n)).astype(np.int8)


def _pack_both(t, fmt, **opts):
    return (rweights.pack(t, fmt, **opts),
            weights.pack(torch.from_numpy(t), fmt, **opts))


def _stub_mesh(**sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


MESHES = [dict(model=2), dict(model=4), dict(data=2, model=4),
          dict(pod=2, data=2, model=2), dict(data=8)]
SPECS = [(), (None,), ("model",), ("fsdp", "model"), ("model", "fsdp"),
         ("expert", "fsdp", "model"), ("expert", "model", "fsdp"),
         (("pod", "data"), None), (("data", "model"), "model"),
         ("data", "model"), (None, "model"), ("model", "model"),
         ("pod",), ("fsdp", "expert")]
SHAPES = [(8,), (16, 32), (6, 64), (12, 10, 8), (3, 5), (1024, 4096),
          (4, 1, 2)]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("fsdp", [False, True])
def test_resolve_spec_equals_repros(sizes, fsdp):
    mesh = _stub_mesh(**sizes)
    n = 0
    for spec in SPECS:
        for shape in SHAPES:
            if len(spec) > len(shape):
                continue
            if "expert" in spec and "model" not in sizes:
                continue                   # repro raises a KeyError there
            want = rsharding.resolve_spec(P(*spec), shape, mesh, fsdp)
            got = sharding.resolve_spec(spec, shape, mesh, fsdp)
            assert got == tuple(want), (spec, shape)
            # a plain {name: size} mesh resolves alike
            assert sharding.resolve_spec(spec, shape, dict(sizes),
                                         fsdp) == got
            n += 1
    assert n > 50
    assert sharding.batch_axes(mesh) == rsharding.batch_axes(mesh)


def test_resolve_specs_tree():
    mesh = _stub_mesh(data=2, model=2)
    tree = {"a": torch.zeros(4, 6), "b": [torch.zeros(3), torch.zeros(8)],
            "c": None}
    specs = {"a": ("fsdp", "model"), "b": [("model",), ("model",)],
             "c": None}
    assert sharding.resolve_specs(specs, tree, mesh, True) == {
        "a": ("data", "model"), "b": [(), ("model",)], "c": None}


@pytest.mark.parametrize("fmt,opts", [("dense2bit", {}), ("bitplane", {}),
                                      ("base3", {}),
                                      ("tiled", dict(tile_k=128,
                                                     tile_n=128)),
                                      ("tiled", dict(tile_k=256,
                                                     tile_n=64))])
@pytest.mark.parametrize("k,n", [(512, 256), (200, 96)])
def test_shard_constraints_equal_repros(fmt, opts, k, n):
    rw, pw = _pack_both(_ternary(k, n), fmt, **opts)
    assert pw.shard_constraints() == rw.shard_constraints()


# repro's tests/test_mesh_serving.py cases: (k, n, format, opts, spec,
# mesh); the port holds the same accept / raise outcome and message
TWIN_CASES = [
    (64, 32, "dense2bit", {}, (None, "model"), {"model": 4}),
    (64, 32, "dense2bit", {}, ("model", None), {"model": 4}),
    (64, 32, "dense2bit", {}, ("model", None), {"model": 8}),
    (512, 256, "tiled", dict(tile_k=128, tile_n=128), ("model", None),
     {"model": 4}),
    (512, 256, "tiled", dict(tile_k=128, tile_n=128), (None, "model"),
     {"model": 4}),
    (24, 32, "dense2bit", {}, ("model", "model", None), {"model": 8}),
    (24, 32, "dense2bit", {}, (), {"model": 8}),
    (64, 40, "bitplane", {}, ("model", None), {"model": 16}),
    (64, 40, "bitplane", {}, ("model", None), {"model": 8}),
    (60, 40, "base3", {}, ("model", None), {"model": 4}),
    (60, 40, "base3", {}, ("model", None), {"model": 3}),
    (64, 32, "dense2bit", {}, ("fsdp", "model"), {"data": 4, "model": 2}),
    (64, 32, "dense2bit", {}, (("data", "model"), None),
     {"data": 2, "model": 4}),
]


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", range(len(TWIN_CASES)))
@pytest.mark.parametrize("fsdp", [False, True])
def test_validate_spec_twin_equals_repros(case, fsdp):
    k, n, fmt, opts, spec, mesh = TWIN_CASES[case]
    rw, pw = _pack_both(_ternary(k, n, seed=case), fmt, **opts)
    field = "plus" if fmt == "bitplane" else "packed"
    rtwin = rw.replace(**{field: P(*spec)})
    want = _outcome(lambda: rweights.validate_spec_twin(rw, rtwin, mesh,
                                                        fsdp=fsdp))
    # the port's twin: the (K, N) spec itself, or a dict of it
    for twin in (tuple(spec), {field: tuple(spec)}):
        got = _outcome(lambda: weights.validate_spec_twin(pw, twin, mesh,
                                                          fsdp=fsdp))
        if want is None:
            assert got is None
        else:
            # the messages name the container by its own repr
            assert got is not None
            assert got.split(" of ")[0] == want.split(" of ")[0]
            assert got.split("Per-shard")[1] == want.split("Per-shard")[1]
    # nothing sharded, nothing to check
    assert weights.validate_spec_twin(pw, None, mesh) is None


@pytest.mark.parametrize("fmt,opts", [("dense2bit", {}), ("bitplane", {}),
                                      ("base3", {}),
                                      ("tiled", dict(tile_k=64,
                                                     tile_n=32))])
@pytest.mark.parametrize("part", ["k", "n"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_weight_equals_pack_of_the_slice(fmt, opts, part, tp):
    """Each rank's shard is bitwise the pack of its slice of the matrix
    (words, occupancy lists, scale and bias), and the ranks' products sum
    (K) or concatenate (N) to the whole GEMM."""
    k, n = 320, 128 if fmt != "tiled" else 128
    if fmt == "base3":
        k = 5 * 64
    t = _ternary(k, n, seed=tp)
    t[:64] = 0                      # empty tiles for the tiled lists
    scale = torch.rand(n) + 0.5
    bias = torch.randn(n)
    w = weights.pack(torch.from_numpy(t), fmt, scale=scale, bias=bias,
                     **opts)
    extent, multiple = w.shard_constraints()[part]
    if extent % (tp * multiple):
        with pytest.raises(ValueError, match="pack multiple"):
            weights.shard_weight(w, part, 0, tp)
        return
    step = extent // tp
    x = torch.randn(3, k).to(torch.bfloat16)
    parts = []
    for r in range(tp):
        lo = r * step
        if part == "k":
            sl, s, b = t[lo:lo + step], scale, bias
        else:
            sl = t[:, lo:lo + step]
            s, b = scale[lo:lo + step], bias[lo:lo + step]
        want = weights.pack(torch.from_numpy(np.ascontiguousarray(sl)), fmt,
                            scale=s.contiguous(), bias=b.contiguous(), **opts)
        got = weights.shard_weight(w, part, r, tp)
        assert got.shape == want.shape and got.nnz == want.nnz
        for leaf in want._leaves:
            a, c = getattr(got, leaf), getattr(want, leaf)
            assert (a is None) == (c is None)
            if a is not None:
                assert torch.equal(a, c), leaf
        if part == "k":
            parts.append(ops.ternary_gemm(x[:, lo:lo + step], got,
                                          partition="k", tp=tp))
        else:
            parts.append(ops.ternary_gemm(x, got))
    whole = ops.ternary_gemm(x, w)
    if part == "k":
        y = (sum(parts) + bias).to(torch.bfloat16)
        assert parts[0].dtype == torch.float32
    else:
        y = torch.cat(parts, dim=1)
    torch.testing.assert_close(y.float(), whole.float(), rtol=1e-2,
                               atol=1e-2 * float(whole.abs().max()))
    with pytest.raises(ValueError, match="partition"):
        weights.shard_weight(w, "m", 0, tp)


PLAN_FIELDS = ("format", "impl", "m", "k", "n", "phase", "occupancy",
               "partition", "collective", "tp")


def _plan_fields(plan):
    return {f: getattr(plan, f) for f in PLAN_FIELDS}


@pytest.mark.parametrize("fmt,opts", [("dense2bit", {}), ("bitplane", {}),
                                      ("tiled", dict(tile_k=128,
                                                     tile_n=64))])
@pytest.mark.parametrize("part", ["k", "n", None])
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("m,phase", [(8, "decode"), (256, "prefill")])
def test_gemm_plans_equal_repros(fmt, opts, part, tp, m, phase):
    rw, pw = _pack_both(_ternary(512, 256, seed=3), fmt, **opts)
    got = ops.ternary_gemm_plan(pw, m, phase=phase, partition=part, tp=tp)
    want = rops.ternary_gemm_plan(rw, m, phase=phase, partition=part, tp=tp,
                                  interpret=True)
    assert _plan_fields(got) == _plan_fields(want)
    gr, wr = got.roofline(), want.roofline()
    assert set(gr) == set(wr)
    for key in ("collective", "collective_bytes", "tp"):
        assert gr[key] == wr[key], key
    if part is not None and tp > 1:
        # the shard plan's tiles are the sliced container's own plan's
        shard = weights.shard_weight(pw, part, 0, tp)
        alone = ops.ternary_gemm_plan(shard, m, phase=phase)
        assert (got.block_m, got.block_n, got.block_k) == \
            (alone.block_m, alone.block_n, alone.block_k)


def test_gemm_plan_partition_errors_equal_repros():
    rw, pw = _pack_both(_ternary(512, 256), "dense2bit")
    for kw in (dict(partition="m", tp=4), dict(tp=0),
               dict(partition="k", tp=3)):
        want = _outcome(lambda: rops.ternary_gemm_plan(
            rw, 32, phase="decode", **kw))
        got = _outcome(lambda: ops.ternary_gemm_plan(pw, 32, phase="decode",
                                                     **kw))
        assert got == want and got is not None


@pytest.mark.parametrize("tp", [1, 2, 4, 3])
@pytest.mark.parametrize("gated", [False, True])
def test_fused_plans_equal_repros(tp, gated):
    ts = [_ternary(128, 256, 1), _ternary(256, 128, 2), _ternary(128, 256, 3)]
    (ri, pi), (ro, po), (rg, pg) = (_pack_both(t, "dense2bit") for t in ts)
    rg, pg = (rg, pg) if gated else (None, None)
    want = _outcome(lambda: rops.fused_mlp_plan(ri, ro, rg, m=32,
                                                phase="prefill", tp=tp,
                                                interpret=True))
    got = _outcome(lambda: ops.fused_mlp_plan(pi, po, pg, m=32,
                                              phase="prefill", tp=tp))
    assert got == want
    if want is not None:
        return
    w = rops.fused_mlp_plan(ri, ro, rg, m=32, phase="prefill", tp=tp,
                            interpret=True)
    g = ops.fused_mlp_plan(pi, po, pg, m=32, phase="prefill", tp=tp)
    for f in ("impl", "m", "k", "ff", "n", "gated", "collective", "tp"):
        assert getattr(g, f) == getattr(w, f), f
    for a, b in zip(g.sub_plans(), w.sub_plans()):
        assert (a.partition, a.collective, a.k, a.n) == \
            (b.partition, b.collective, b.k, b.n)
    gr, wr = g.roofline(), w.roofline()
    for key in ("collective", "collective_bytes", "tp"):
        assert gr[key] == wr[key], key


def _reduced(num_layers=2, **kw):
    kw = dict(ternary_min_dim=64, num_layers=num_layers, **kw)
    return rget_config("ternary-paper", reduced=True, **kw), \
        get_config("ternary-paper", reduced=True, **kw)


def _repro_spec_entry(spec):
    """repro's spec twin leaf -> the port's: a PartitionSpec -> its tuple,
    a packed container twin -> {"packed", "scale", "bias"}."""
    if isinstance(spec, rweights.TernaryWeight):
        return {"packed": tuple(spec.packed), "scale": tuple(spec.scale),
                "bias": None if spec.bias is None else tuple(spec.bias)}
    if isinstance(spec, P):
        return tuple(spec)
    return {k: _repro_spec_entry(v) for k, v in spec.items()}


def _unstack(spec):
    """Drop the leading None of repro's stacked block specs."""
    if isinstance(spec, dict):
        return {k: _unstack(v) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return spec[1:]
    return spec


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("overrides", [{}, dict(use_bias=True),
                                       dict(norm_type="layernorm")])
def test_param_specs_equal_repros_init_with_specs(packed, overrides):
    rcfg, pcfg = _reduced(**overrides)
    if packed:
        rcfg = dataclasses.replace(rcfg, quantization="ternary_packed")
    _, rspecs = RLM(rcfg).init_with_specs(jax.random.PRNGKey(0))
    rspecs = {k: _repro_spec_entry(v) for k, v in rspecs.items()}
    model = LM(pcfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    if packed:
        from repro_torch.models.layers import pack_params
        params = pack_params(params, pcfg)
    got = model.param_specs(params)
    period = RLM(rcfg).period
    for name in ("embed", "final_norm", "unembed"):
        assert got[name] == rspecs[name], name
    for i, block in enumerate(got["layers"]):
        want = _unstack(rspecs[f"block{i % period}"])
        assert block == want, i
    assert set(rspecs) == {"embed", "final_norm", "unembed"} | {
        f"block{j}" for j in range(period)}
    # every packed twin validates on a 2-way model mesh
    assert tp_lib.validate_param_specs(params, got, {"model": 2}) == (
        tp_lib.validate_param_specs(params, got, {"model": 1}))


def test_param_specs_refuse_other_families():
    """No family is refused any more: an SSM stack's twin carries the
    mixer's specs (every family against repro's resolution:
    ``test_torch_tp_family_train``)."""
    specs = param_specs(get_config("mamba2-130m", reduced=True))
    mixer = specs["layers"][0]["mixer"]
    assert mixer["in_proj"] == {"w": ("fsdp", "model")}
    assert mixer["conv_w"] == (None, "model") and mixer["a_log"] == (None,)


def test_shard_params_marks_and_slices():
    """tp 2 of a reduced packed ternary-paper: q/k/v, up, gate column
    shards, o and down row shards, the lm head a gathered column shard,
    the embedding table split by vocabulary rows, norms whole; the head
    rule gives each rank the one K/V head its query heads read when the
    K/V heads do not divide."""
    _, pcfg = _reduced()
    pcfg, params = serve.build_params(pcfg, 0, "cpu", True)
    specs = param_specs(pcfg, params)
    mesh = tp_lib.replica_meshes(1, 2, ["cpu", "cpu"])[0]
    for rank in (0, 1):
        sh = tp_lib.shard_params(params, specs, mesh, rank=rank, cfg=pcfg)
        lay, full = sh["layers"][0], params["layers"][0]
        for name, part in (("q", "n"), ("k", "n"), ("v", "n"), ("o", "k")):
            assert lay["mixer"][name]["tp"] == part
            w = lay["mixer"][name]["w_packed"]
            want = weights.shard_weight(full["mixer"][name]["w_packed"],
                                        part, rank, 2)
            assert torch.equal(w.packed, want.packed)
        for name, part in (("in", "n"), ("gate", "n"), ("out", "k")):
            assert lay["ffn"][name]["tp"] == part
        assert sh["unembed"]["tp"] == "gather"
        assert sh["unembed"]["w_packed"].n == params["unembed"][
            "w_packed"].n // 2
        table, rows = params["embed"]["table"], pcfg.padded_vocab() // 2
        assert sh["embed"]["tp"] == "vocab"
        assert torch.equal(sh["embed"]["table"],
                           table[rank * rows:(rank + 1) * rows])
        assert sh["final_norm"] is not None
    plans = ops.precompute_plans(sh, decode_ms=(4,),
                                 shard=tp_lib.gemm_shard_fn(mesh, sh))
    parts = sorted({(p.partition, p.collective) for p in plans.values()},
                   key=str)
    assert parts == [("k", "psum"), ("n", None)]
    fused = ops.precompute_fused_plans(sh, decode_ms=(4,), tp=2)
    assert {(p.collective, p.tp) for p in fused.values()} == {("psum", 2)}
    # the head rule: one K/V head does not split two ways, so both ranks
    # keep it (its columns whole) beside their half of the query heads
    gcfg = dataclasses.replace(pcfg, num_kv_heads=1)
    g_params = serve.build_params(dataclasses.replace(
        gcfg, quantization="ternary"), 0, "cpu", True)[1]
    sh = tp_lib.shard_params(g_params, param_specs(gcfg, g_params), mesh,
                             rank=1, cfg=gcfg)
    mixer = sh["layers"][0]["mixer"]
    assert (mixer["q"]["tp"], mixer["o"]["tp"]) == ("n", "k")
    for n in "kv":
        assert mixer[n]["tp"] == ("kv", 1, 2)
        # one head's 32 columns are below ternary_min_dim: latent
        assert torch.equal(mixer[n]["w"], g_params["layers"][0]["mixer"][n]
                           ["w"])
    assert sh["layers"][0]["ffn"]["out"]["tp"] == "k"
    local = tp_lib.local_config(gcfg, 2)
    assert (local.num_heads, local.num_kv_heads) == (gcfg.num_heads // 2, 1)
    assert tp_lib.local_config(pcfg, 2).num_heads == pcfg.num_heads // 2
    # an SSM stack's rank holds its heads' share of d_inner
    mamba = get_config("mamba2-130m", reduced=True)
    local = tp_lib.local_config(mamba, 2)
    assert (local.d_inner, local.ssm_heads) == (mamba.d_inner // 2,
                                                mamba.ssm_heads // 2)


def test_cache_sharding_equals_repros():
    _, pcfg = _reduced()
    kv, hd = pcfg.num_kv_heads, pcfg.head_dim
    leaves = {"k": torch.zeros(3, 16, kv, hd), "s": torch.zeros(5, 8, kv),
              "pos": torch.zeros(3), "other": torch.zeros(4, 7)}
    for tp in (1, 2, 4):
        got = tp_lib.cache_sharding(leaves, pcfg, {"model": tp})
        rmesh = _stub_mesh(model=tp)
        with_stub = types.SimpleNamespace(shape={"model": tp})
        want = {}
        for name, t in leaves.items():
            shp = tuple(t.shape)
            shardable = tp > 1 and kv % tp == 0
            if shardable and shp[-2:] == (kv, hd):
                want[name] = (None,) * (len(shp) - 2) + ("model",)
            elif shardable and shp[-1] == kv:
                want[name] = (None,) * (len(shp) - 1) + ("model",)
            else:
                want[name] = ()
        assert got == want
        del rmesh, with_stub
        put = tp_lib.device_put_cache(leaves, pcfg, {"model": tp}, rank=0)
        if tp > 1 and kv % tp == 0:
            assert put["k"].shape[-2] == kv // tp
            assert torch.equal(put["s"], leaves["s"][..., :kv // tp])
        elif tp > 1:
            # the head rule's replicated K/V head: rank 0 keeps head 0,
            # a placement no spec holds
            assert tp_lib.attention_split(pcfg, tp) == "replicate"
            assert put["k"].shape[-2] == 1
            assert torch.equal(put["s"], leaves["s"][..., :1])
        else:
            assert put["k"].shape == leaves["k"].shape
    assert tp_lib.replicated_sharding({"a": torch.zeros(2)}, {"model": 2}) \
        == {"a": ()}


def test_meshes_as_repros():
    assert tp_lib.parse_mesh("2,4") == rtp.parse_mesh("2,4") == (2, 4)
    assert tp_lib.parse_mesh("4") == rtp.parse_mesh("4") == (1, 4)
    assert tp_lib.parse_mesh(" 1 , 2 ") == (1, 2)
    for bad in ("1,2,3", "0,4"):
        with pytest.raises(ValueError):
            tp_lib.parse_mesh(bad)
        with pytest.raises(ValueError):
            rtp.parse_mesh(bad)
    meshes = tp_lib.replica_meshes(2, 2, ["cpu"] * 5)
    assert [m.devices for m in meshes] == [("cpu", "cpu")] * 2
    assert meshes[0].shape == {"model": 2} and meshes[0].backend == "gloo"
    assert tp_lib.Mesh(("model",), (2,), ("cuda:0", "cuda:1")).backend \
        == "nccl"
    assert tp_lib.Mesh(("model",), (2,), ("cuda:0", "cuda:0")).backend \
        == "gloo"
    with pytest.raises(ValueError, match="needs 4 devices"):
        tp_lib.replica_meshes(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tp_lib.Mesh(("model",), (2,), ("cpu",))
    assert tp_lib.mesh_axis_sizes(meshes[0]) == rtp.mesh_axis_sizes(
        {"model": 2})
    local = make_local_mesh()
    assert local.shape == {"data": 1, "model": 1} and local.size == 1
    with pytest.raises(ValueError, match="ranks"):
        make_local_mesh(1, 2)
