"""The port's dry run (``repro_torch.launch.dryrun``) against ``repro``'s:
``model_flops`` for every architecture and shape, the cells' status and
skip reasons, ``make_production_mesh``'s shapes and axes, the decode
cache's resolved specs, the matmul FLOPs of reduced granite's prefill
against ``repro``'s walker over its jitted prefill, and the argument
bytes of reduced fsdp train cells (state split over the data axes)
against ``repro``'s compiled ``memory_analysis``. ``repro.launch.dryrun``
sets ``XLA_FLAGS`` when it is imported, so every ``repro`` reading comes
from one child process (``REPRO_DRYRUN_DEVICES``, Auto mesh axes, no
``train_4k`` cell). The recording group counts what a real 2-rank gloo
group does on a dense and a MoE decode step; the CLI writes ``repro``'s
record keys and exits 0."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, hlo_cost, make_production_mesh, steps
from repro_torch.models import LM

from test_torch_gloo_ranks import run_ranks
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_family_ranks import decode_comm_rank, fsdp_train_comm_rank

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE_ARCHS = ("granite-3-8b", "jamba-v0.1-52b", "seamless-m4t-large-v2")
CACHE_SHAPE = (64, 8)                      # (cache length, batch)
PREFILL = (2, 48, 64)                      # (batch, prompt, max_len)
# reduced fsdp train cells: (sequence, global batch, (data, model) mesh)
TRAIN_CELL = (64, 32, (4, 1))
TRAIN_ARCHS = ("granite-3-8b", "mixtral-8x22b")

_CHILD = r"""
import json, os, sys
os.environ["REPRO_DRYRUN_DEVICES"] = "512"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import SHAPES, get_config, list_archs
from repro.configs.base import ShapeConfig
from repro.distributed import sharding as shlib
from repro.launch import dryrun, hlo_cost, steps
from repro.launch.mesh import make_production_mesh
from repro.models import LM, set_mesh

def auto(dims, names):
    return jax.make_mesh(dims, names, axis_types=(AxisType.Auto,) * len(dims))

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

out = {"model_flops": {}, "supports": {}, "meshes": {}, "cells": {},
       "cache": {}}
for a in list_archs():
    for s in SHAPES:
        out["model_flops"][a + "|" + s] = dryrun.model_flops(
            get_config(a), SHAPES[s])
        out["supports"][a + "|" + s] = list(get_config(a).supports_shape(s))
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out["meshes"][str(mp)] = [list(m.devices.shape), list(m.axis_names)]
mesh = auto((2, 4), ("data", "model"))
for s in ("prefill_32k", "decode_32k", "long_500k"):
    rec = dryrun.run_cell("granite-3-8b", s, mesh=mesh, reduced=True)
    out["cells"][s] = [rec["status"], rec.get("reason", "")]
length, batch = %(cache)r
for a in %(archs)r:
    cfg = get_config(a, reduced=True)
    set_mesh(mesh)
    shapes, pspec = steps.cache_specs_shapes(
        LM(cfg), cfg, ShapeConfig("d", length, batch, "decode"))
    sh = shlib.resolve_specs(pspec, shapes, mesh, fsdp=True)
    out["cache"][a] = jax.tree.map(
        lambda s, x: [list(x.shape), spec(s)], sh, shapes)
set_mesh(auto((1, 1), ("data", "model")))
b, s, max_len = %(prefill)r
cfg = get_config("granite-3-8b", reduced=True, attn_impl="naive")
model = LM(cfg)
p_shapes, _ = model.init_with_specs_abstract()
step = steps.make_prefill_step(model, cfg, max_len)
tokens = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
c = jax.jit(step).lower(p_shapes, tokens).compile()
out["dot"] = hlo_cost.analyze(c.as_text()).by_op.get("dot", [0, 0])[0]
out["train_args"] = {}
length, batch, dims = %(train)r
for a in %(train_archs)r:
    tmesh = auto(tuple(dims), ("data", "model"))
    set_mesh(tmesh)
    cfg = get_config(a, reduced=True, fsdp=True)
    model = LM(cfg)
    p_shapes, p_sh = steps.model_shardings(model, cfg, tmesh)
    shape = ShapeConfig("train", length, batch, "train")
    tbatch = steps.input_specs(cfg, shape)
    step, opt_init = steps.make_train_step(model, cfg)
    o_shapes = jax.eval_shape(opt_init, p_shapes)
    o_sh = shlib.opt_state_shardings(p_sh, o_shapes, tmesh)
    c = jax.jit(step, in_shardings=(p_sh, o_sh, shlib.batch_sharding(
        tbatch, tmesh)), donate_argnums=(0, 1)).lower(
        p_shapes, o_shapes, tbatch).compile()
    out["train_args"][a] = dryrun._mem_dict(c.memory_analysis())[
        "argument_size_in_bytes"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def repro_side():
    code = _CHILD % {"cache": CACHE_SHAPE, "archs": CACHE_ARCHS,
                     "prefill": PREFILL, "train": TRAIN_CELL,
                     "train_archs": TRAIN_ARCHS}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code, str(ROOT / "src")],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_model_flops_equal_repros(repro_side):
    archs = list_archs()
    assert len(archs) == 11
    got = {f"{a}|{s}": dryrun.model_flops(get_config(a), SHAPES[s])
           for a in archs for s in SHAPES}
    assert got == repro_side["model_flops"]


def test_status_and_skip_reasons_equal_repros(repro_side):
    """Every architecture's skip decision and reason, as ``run_cell``
    records it (one ``ok`` cell traced for each of decode_32k and
    long_500k per architecture; ``repro``'s side compiles reduced
    granite's three serving cells)."""
    mesh = dryrun.parse_mesh("2x4")
    for a in list_archs():
        for s in SHAPES:
            ok, reason = repro_side["supports"][f"{a}|{s}"]
            assert list(get_config(a).supports_shape(s)) == [ok, reason]
        for s in ("decode_32k", "long_500k"):
            rec = dryrun.run_cell(a, s, mesh=mesh, reduced=True)
            ok, reason = repro_side["supports"][f"{a}|{s}"]
            assert rec["status"] == ("ok" if ok else "skipped"), (a, s)
            assert rec.get("reason", "") == reason
    for s, (status, reason) in repro_side["cells"].items():
        rec = dryrun.run_cell("granite-3-8b", s, mesh=mesh, reduced=True)
        assert [rec["status"], rec.get("reason", "")] == [status, reason]


def test_production_mesh_equals_repros(repro_side):
    for mp in (False, True):
        m = make_production_mesh(multi_pod=mp)
        assert [list(m.sizes), list(m.axis_names)] == \
            repro_side["meshes"][str(mp)]
        assert set(m.devices) == {"meta"}


def _norm(entry):
    return entry[0] if isinstance(entry, (list, tuple)) and len(entry) == 1 \
        else (list(entry) if isinstance(entry, tuple) else entry)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_resolve_as_repros(arch, repro_side):
    """``cache_specs_shapes`` resolved on a 2 x 4 mesh: every layer's
    shape and spec is ``repro``'s less its stacked group axis."""
    cfg = get_config(arch, reduced=True)
    length, batch = CACHE_SHAPE
    shapes, specs = steps.cache_specs_shapes(
        LM(cfg, "meta"), cfg, ShapeConfig("d", length, batch, "decode"))
    got = sharding.resolve_specs(specs, shapes, {"data": 2, "model": 4},
                                 True)
    assert all(t.is_meta for t in hlo_cost.leaf_tensors(shapes))
    want = repro_side["cache"][arch]
    layers = LM(cfg, "meta")
    period = layers.period
    for i, layer in enumerate(shapes["layers"]):
        ref = want["layers"][f"cache{i % period}"]
        for name, t in layer.items():
            shape, spec = ref[name]
            assert list(t.shape) == shape[1:], (i, name)
            assert [_norm(e) for e in got["layers"][i][name]] == \
                [_norm(e) for e in spec[1:]], (i, name)
    if cfg.is_encdec:
        shape, spec = want["enc_out"]
        assert list(shapes["enc_out"].shape) == shape
        assert [_norm(e) for e in got["enc_out"]] == [_norm(e) for e in spec]


def test_prefill_matmul_flops_equal_repros_walker(repro_side):
    """Reduced granite's prefill with naive attention: the port's matmul
    class over its eager step equals ``by_op["dot"]`` of ``repro``'s HLO
    walker over its jitted one on one device."""
    b, s, max_len = PREFILL
    cfg = get_config("granite-3-8b", reduced=True, attn_impl="naive")
    model = LM(cfg, "meta")
    params, _ = steps.model_shardings(model, cfg, {"data": 1, "model": 1})
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                   device="meta")}
    t = hlo_cost.trace(steps.make_prefill_step(model, cfg, max_len),
                       params, batch)
    assert hlo_cost.matmul_flops(t.plain) == repro_side["dot"] > 0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fsdp_train_cell_arguments_equal_repros(arch, repro_side):
    """A reduced fsdp train cell on a (4, 1) mesh: rank 0's parameters,
    AdamW state and batch rows (``memory.argument_size_in_bytes``) are
    ``repro``'s compiled record's to the byte — every fsdp leaf and its
    moments a quarter, the norms and the step whole — and a quarter or
    so of the same cell's with fsdp off; the collectives gather and
    reduce-scatter."""
    length, batch, dims = TRAIN_CELL
    shape = ShapeConfig("train", length, batch, "train")
    mesh = dryrun.parse_mesh("x".join(str(d) for d in dims))
    rec = dryrun.run_cell(arch, "train_4k", reduced=True, mesh=mesh,
                          shape=shape, overrides={"fsdp": True})
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == repro_side["train_args"][arch]
    whole = dryrun.run_cell(arch, "train_4k", reduced=True, mesh=mesh,
                            shape=shape, overrides={"fsdp": False})
    assert whole["memory"]["argument_size_in_bytes"] \
        > 3.5 * mem["argument_size_in_bytes"]
    assert 0 < mem["state_size_in_bytes"] < mem["argument_size_in_bytes"]
    coll = rec["collective_bytes_per_chip"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert "reduce-scatter" not in whole["collective_bytes_per_chip"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cells_keep_whole_params_whatever_fsdp_says(kind):
    """The port's engine is replicated (C19): a reduced fsdp config's
    prefill or decode cell on a 2 x 2 mesh gives the same record with
    fsdp on and off — rank 0 holds whole parameters on every data rank."""
    shape = ShapeConfig(kind, 64, 4, kind)
    recs = []
    for flag in (False, True):
        rec = dryrun.run_cell("granite-3-8b", f"{kind}_32k", reduced=True,
                              mesh=dryrun.parse_mesh("2x2"), shape=shape,
                              overrides={"fsdp": flag})
        rec.pop("trace_s")
        rec.pop("overrides")
        recs.append(rec)
    assert recs[0]["status"] == "ok" and recs[0] == recs[1]
    assert recs[0]["memory"]["state_size_in_bytes"] is None


@pytest.mark.parametrize("arch,accum", [("ternary-paper", 1),
                                        ("mixtral-8x22b", 2)])
def test_recording_group_counts_reduce_scatter_as_a_real_gloo_rank(arch,
                                                                   accum):
    """Rank 0's data collectives in one fsdp train step at dp 2 — the
    slices gathered at use, their gradients reduce-scattered (each
    microbatch's under accumulation), the whole leaves' all-reduced, the
    norm, the loss — counted by the recording group in the dry run's meta
    trace equal a real 2-rank gloo group's."""
    cfg = get_config(arch, reduced=True, fsdp=True, grad_accum=accum)
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rows, length = 4, 16
    batch = {k: v.numpy() for k, v in SyntheticLM(
        cfg, rows, length).sharded_batch(0).items()}
    real = run_ranks(2, fsdp_train_comm_rank, cfg, params, batch)[0]
    step, args, groups = dryrun.rank_step(
        cfg, ShapeConfig("train", length, rows, "train"),
        dryrun.parse_mesh("2x1"))
    hlo_cost.trace(step, *args)
    (data,) = groups
    assert (data.calls, data.bytes) == real
    assert data.calls > 2 * accum


@pytest.mark.parametrize("arch", ["granite-3-8b", "mixtral-8x22b"])
def test_recording_group_counts_as_a_real_gloo_rank(arch):
    """Rank 0's data collectives in one decode step at tp 2 — a dense
    model (attention split by heads, MLP rows all-reduced, the lm head's
    logits gathered) and a MoE model (expert parallel) — counted by the
    recording group (on CPU tensors and in the dry run's meta trace)
    equal a real 2-rank gloo group's."""
    cfg = get_config(arch, reduced=True)
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rows, length = 4, 32
    real = run_ranks(2, decode_comm_rank, cfg, params, rows, length)[0]
    rec = dryrun.RecordingGroup("model", 0, [0, 1])
    assert decode_comm_rank(rec, 0, cfg, params, rows, length) == real
    assert real[0] > 0
    step, args, groups = dryrun.rank_step(
        cfg, ShapeConfig("decode", length, rows, "decode"),
        dryrun.parse_mesh("1x2"))
    hlo_cost.trace(step, *args)
    (model,) = groups
    assert (model.calls, model.bytes) == real


def test_collectives_cross_nodes_as_the_ranks_lie():
    """Ranks lie row-major on nodes of 8 cards, ``model`` innermost: on
    16 x 16 rank 0's model group spans two nodes (InfiniBand) and its
    data group one card of every second node; on 32 x 8 the model group
    is one node (NVLink)."""
    data, model = dryrun._groups(make_production_mesh())
    assert (model.size, model.link, data.size, data.link) == (
        16, "infiniband", 16, "infiniband")
    data, model = dryrun._groups(dryrun.parse_mesh("32x8"))
    assert (model.link, model.bandwidth) == ("nvlink", dryrun.NVLINK_BW)
    assert data.link == "infiniband"
    data, model = dryrun._groups(make_production_mesh(multi_pod=True))
    assert data.size == 32 and data.ranks[-1] == 31 * 16
    assert dryrun._groups(dryrun.parse_mesh("8x1"))[0].link == "nvlink"


def test_cli_writes_repros_record_keys(tmp_path):
    """The CLI at full size on the production mesh: a sub-quadratic
    decode cell (mamba2, long_500k) traces ``ok`` with ``repro``'s record
    keys (less the compiler's timings and cost analysis, which
    ``trace_s`` and ``flop_counter`` replace) and the port's, and a
    quadratic one is skipped with ``repro``'s reason; the run exits 0."""
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert ex.value.code == 0
    rec = json.loads((tmp_path / "mamba2-130m_long_500k_16x16.json")
                     .read_text())
    repro_keys = {"arch", "shape", "mesh", "quant", "overrides", "status",
                  "chips", "hlo_flops_per_chip", "hlo_bytes_per_chip",
                  "collective_bytes_per_chip", "memory", "t_compute_s",
                  "t_memory_s", "t_collective_s", "dominant",
                  "model_flops_total", "model_flops_per_chip",
                  "useful_flops_ratio", "params_total", "params_active"}
    port_keys = {"trace_s", "flop_counter", "kernel_flops_per_chip",
                 "kernel_bytes_per_chip"}
    assert repro_keys | port_keys <= set(rec)
    assert rec["status"] == "ok" and rec["chips"] == 256
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] == \
        mem["peak_bytes"] - mem["argument_size_in_bytes"]
    assert mem["fits"] is True
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert ex.value.code == 0
    rec = json.loads((tmp_path / "granite-3-8b_long_500k_16x16.json")
                     .read_text())
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


def test_a_packed_cell_charges_the_kernels_by_their_plans():
    """A ``ternary_packed`` serving cell of a reduced model on a 2 x 2
    mesh: the kernel reading moves fewer bytes than the plain one (the
    2-bit words read in place of decoded weights) and both readings
    charge the same collectives."""
    rec = dryrun.run_cell("granite-3-8b", "decode_32k",
                          quant="ternary_packed", reduced=True,
                          overrides={"ternary_min_dim": 64},
                          mesh=dryrun.parse_mesh("2x2"))
    assert rec["status"] == "ok" and rec["quant"] == "ternary_packed"
    assert 0 < rec["kernel_bytes_per_chip"] < rec["hlo_bytes_per_chip"]
    assert rec["collectives"]["model"]["calls"] > 0
