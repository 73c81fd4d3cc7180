"""The port's user entry points (``examples_torch/``) held against
``repro``'s (``examples/``) on the CPU, where every kernel row takes its
plain version (``repro``'s kernel row pinned to ``ref``, C3):

* quickstart: on the same numpy seed, the TCSC / Blocked / Interleaved
  byte counts, the 2-bit container's bytes and the ``GemmPlan``'s format
  and row equal ``repro``'s, and every variant's output lies within the
  example's own 1e-3 of ``repro``'s (float32 throughout);
* quantize_and_pack: the report's rows (path, shape, bytes before and
  after) equal the rows ``repro``'s example builds from its own tree
  (occupancy depends on the init, which differs between the packages);
* train_ternary_lm ``--small --steps 12`` passes its two asserts;
* serve_batched in each of its four modes on a reduced ``ternary-paper``
  with 4 requests drains them all, and the continuous mode's greedy
  streams equal ``repro``'s engine's on ``repro``'s weights carried
  across (``repro_tree_to_numpy`` -> ``params_from_numpy``);
* every example asks for the card by default and raises without one.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as rget_config
from repro.core import formats as rformats
from repro.core import quantize as rquantize
from repro.core import weights as rweights
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.launch import serve as rserve
from repro.models import LM as RLM
from repro.models import layers as rlayers
from repro.serving import ContinuousScheduler as RScheduler
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config

from test_torch_model import repro_tree_to_numpy
from test_torch_tp import _near_tie
from torch_cpu_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-3
NAMES = ("quickstart", "quantize_and_pack", "train_ternary_lm",
         "serve_batched")


def _example(name):
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return {name: _example(name) for name in NAMES}


@pytest.fixture(scope="module")
def repro_quickstart():
    """``examples/quickstart.py``'s steps on ``repro``, its kernel row
    pinned to ``ref``."""
    rng = np.random.default_rng(0)
    m, k, n = 32, 2048, 1024
    w_dense = jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.float32)
    t, alpha = rquantize.ternarize(w_dense)
    t_np = np.asarray(t)
    tcsc = rformats.TCSC.from_dense(t_np)
    blocked = rformats.BlockedTCSC.from_dense(t_np, block_size=4096)
    inter = rformats.InterleavedTCSC.from_dense(t_np, group=4)
    bias = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32)
    alpha_v = alpha.reshape(-1)
    wc = rweights.pack(t_np, "dense2bit", scale=alpha_v, bias=bias)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    plan = rops.ternary_gemm_plan(wc, m)
    outs = {
        "oracle": rref.ternary_matmul_dense(x, t, alpha_v, bias),
        "kernel": rops.ternary_gemm(x, wc, impl="ref"),
        "TCSC": rref.tcsc_matmul(x, tcsc, alpha_v, bias),
        "BlockedTCSC": rref.tcsc_matmul_blocked(x, blocked, alpha_v, bias),
        "InterleavedTCSC": rref.tcsc_matmul_interleaved(x, inter, alpha_v,
                                                        bias),
        "Base3 (ref)": rops.ternary_gemm(
            x, rweights.pack(t_np, "base3", scale=alpha_v, bias=bias))}
    return {"tcsc_bytes": tcsc.nbytes(), "blocked_bytes": blocked.nbytes(),
            "interleaved_bytes": inter.nbytes(), "dense2bit_bytes":
            wc.nbytes, "plan": (plan.format, plan.impl),
            "outputs": {k: np.asarray(v) for k, v in outs.items()}}


def test_quickstart_matches_repros(examples, repro_quickstart):
    got = examples["quickstart"].main(["--device", "cpu"])
    want = repro_quickstart
    for key in ("tcsc_bytes", "blocked_bytes", "interleaved_bytes",
                "dense2bit_bytes"):
        assert got[key] == want[key], key
    assert (got["plan"]["format"], got["plan"]["impl"]) == want["plan"]
    assert got["activations"] == "float32"
    outs = got["outputs"]
    row = f"{got['plan']['format']}/{got['plan']['impl']}"
    pairs = [("oracle", "oracle"), (row, "kernel"), ("TCSC", "TCSC"),
             ("BlockedTCSC", "BlockedTCSC"),
             ("InterleavedTCSC", "InterleavedTCSC"),
             ("Base3 (ref)", "Base3 (ref)")]
    for mine, theirs in pairs:
        np.testing.assert_allclose(outs[mine], want["outputs"][theirs],
                                   rtol=0, atol=TOL, err_msg=mine)


def repro_pack_rows():
    """``examples/quantize_and_pack.py``'s rows (its ``stats`` walk) over
    ``repro``'s own tree."""
    cfg = rget_config("ternary-paper", reduced=True, ternary_min_dim=64)
    params = RLM(cfg).init(jax.random.PRNGKey(0))
    packed_params = rlayers.pack_params(params, cfg)
    rows = []

    def stats(latent, packed, path=""):
        if not isinstance(packed, dict):
            return
        wc = packed.get("w_packed")
        if isinstance(wc, rweights.TernaryWeight):
            before = sum(v.nbytes for v in jax.tree.leaves(latent))
            after = sum(v.nbytes for v in jax.tree.leaves(packed))
            rows.append((path, tuple(latent["w"].shape), before, after))
            return
        for k, v in packed.items():
            if isinstance(v, rweights.TernaryWeight):
                rows.append((f"{path}/{k}", tuple(latent[k].shape),
                             latent[k].nbytes, v.nbytes))
            else:
                stats(latent[k], v, f"{path}/{k}")

    stats(params, packed_params)
    return rows


def test_pack_report_rows_equal_repros(examples):
    got = examples["quantize_and_pack"].main(["--device", "cpu"])
    rows = [(r["path"], tuple(r["shape"]), r["before"], r["after"])
            for r in got["rows"]]
    want = repro_pack_rows()
    assert sorted(rows) == sorted(want)
    assert got["total_before"] == sum(r[2] for r in want)
    assert got["total_after"] == sum(r[3] for r in want)
    assert all(0.5 < r["occupancy"] < 0.65 for r in got["rows"])
    assert got["logits_shape"] == [1, 32, 512]


def test_train_small_passes_its_asserts(examples, tmp_path):
    got = examples["train_ternary_lm"].main(
        ["--small", "--steps", "12", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)])
    assert got["last_loss"] < got["first_loss"]
    assert abs(got["eval_loss_packed_2bit"] - got["eval_loss_qat"]) < 0.05
    assert got["serving_bytes"] < got["train_bytes"]


SERVE = ["--arch", "ternary-paper", "--requests", "4", "--device", "cpu"]
MODES = {"continuous": [], "static": ["--static"],
         "spec": ["--spec", "--spec-k", "4"],
         "traffic": ["--traffic", "poisson", "--rate", "12"]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_modes_drain(examples, mode):
    got = examples["serve_batched"].main(SERVE + MODES[mode])
    assert got["submitted"] == got["drained"] == 4
    assert got["engine"] == ("static" if mode == "static" else "continuous")
    assert len(got["outputs"]) == 4
    assert got["generated_tokens"] == sum(len(o) for o in got["outputs"])
    if mode == "spec":
        assert got["spec"]["k"] == 4
    if mode == "traffic":
        assert got["traffic"]["n"] == 4
        assert got["sched"]["chunk_steps"] > 0


def test_continuous_streams_equal_repros(examples, monkeypatch):
    """``repro``'s example's continuous run (its engine, its weights from
    ``PRNGKey(0)``) and the port's example on those weights: each stream
    equal, or parting at a near tie (the config serves bfloat16:
    ``test_torch_tp``'s rule, both tokens at the split and every later
    port token within 3e-2 of max|logit| below the top logit, teacher-
    forced on the port's stream)."""
    rcfg = rget_config("ternary-paper", reduced=True)
    gen_lens, prompt_len = (4, 16), 32
    max_len = prompt_len + max(gen_lens) + 1
    prompts, gens, _ = rserve.build_workload(rcfg, 4, prompt_len,
                                             list(gen_lens))
    engine = RScheduler(rcfg, max_slots=4, max_len=max_len)
    rparams = engine.model.init(jax.random.PRNGKey(0))
    engine.load(rparams)
    want, _ = rserve.run_continuous(engine, prompts, gens)

    mod = examples["serve_batched"]
    pcfg = get_config("ternary-paper", reduced=True)
    carried = params_from_numpy(repro_tree_to_numpy(rparams), pcfg, "cpu")
    monkeypatch.setattr(mod, "init_params", lambda model: carried)
    got = mod.main(SERVE)
    assert len(got["outputs"]) == len(want) == 4
    for prompt, a, b in zip(prompts, want, got["outputs"]):
        b = np.asarray(b, np.int32)
        assert len(a) == len(b)
        if not np.array_equal(a, b):
            _near_tie(pcfg, carried, prompt, np.asarray(a), b)


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_the_card(examples, name):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        examples[name].main(["--arch", "ternary-paper"]
                            if name == "serve_batched" else [])
