"""The port's checkpoints and fault tolerance held against ``repro``'s.

Checkpoints cross both ways on disk — ``repro.checkpoint.save`` read by the
port's ``restore`` and the port's ``save`` read by ``repro``'s — and every
leaf comes back bit for bit (float32, int32 and bfloat16 leaves; the
manifests list the same shapes, dtypes and crc32s). A corrupted leaf
raises ``CheckpointCorruptError`` and ``latest_step(verify=True)`` skips
its step. ``TrainSupervisor`` and ``StragglerWatchdog`` keep the semantics
``tests/test_fault_tolerance.py`` pins for ``repro``'s: restart from the
newest checkpoint with identical state evolution, a bounded restart
budget, flags against the pre-update EWMA, a bounded event ring. These
tests compare exact values: no tolerance.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as rckpt
from repro_torch import checkpoint as ckpt
from repro_torch.distributed.fault_tolerance import (StragglerWatchdog,
                                                     TrainSupervisor)


def _numpy_state():
    rng = np.random.default_rng(0)
    return {
        "params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                   "b": rng.standard_normal(4).astype(np.float32),
                   "layers": [rng.standard_normal(2).astype(np.float32)
                              for _ in range(2)]},
        "opt": {"m": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
                "step": np.asarray(7, np.int32)},
    }


def _repro_state():
    s = _numpy_state()
    out = jax.tree.map(jnp.asarray, s)
    out["params"]["b"] = jnp.asarray(s["params"]["b"], jnp.bfloat16)
    return out


def _port_state():
    s = _numpy_state()
    out = jax.tree.map(torch.from_numpy, s)
    out["params"]["b"] = torch.from_numpy(s["params"]["b"]).to(
        torch.bfloat16)
    return out


def _bits(x):
    """A leaf's stored bytes, whichever package made it."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.uint16) if str(a.dtype) == "bfloat16" else a).tobytes()


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_repro_checkpoint_restores_in_the_port(tmp_path):
    rckpt.save(str(tmp_path), 7, _repro_state())
    step, flat = ckpt.restore(str(tmp_path))
    assert step == 7
    ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               _repro_state())[0]}
    assert set(flat) == set(ref)
    for key, leaf in ref.items():
        assert _bits(flat[key]) == _bits(leaf), key
    assert flat["params/b"].dtype == torch.bfloat16
    assert flat["opt/step"].dtype == torch.int32
    # with a target: the structure and dtypes follow it
    _, tree = ckpt.restore(str(tmp_path), target=_port_state())
    assert tree["params"]["layers"][1].shape == (2,)
    assert _bits(tree["params"]["b"]) == _bits(_port_state()["params"]["b"])


def test_port_checkpoint_restores_in_repro(tmp_path):
    ckpt.save(str(tmp_path), 9, _port_state())
    step, restored = rckpt.restore(str(tmp_path),
                                   target=jax.eval_shape(_repro_state))
    assert step == 9
    for a, b in zip(jax.tree.leaves(_repro_state()),
                    jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        assert _bits(a) == _bits(b)


def test_both_packages_write_the_same_manifest(tmp_path):
    rckpt.save(str(tmp_path / "r"), 1, _repro_state())
    ckpt.save(str(tmp_path / "p"), 1, _port_state())
    assert _manifest(str(tmp_path / "r"), 1) == \
        _manifest(str(tmp_path / "p"), 1)


def _corrupt_leaf(d, step, key, value):
    """Rewrite one stored array behind the manifest's back."""
    path = os.path.join(str(d), f"step_{step:08d}", "state.npz")
    data = dict(np.load(path).items())
    data[key] = value
    np.savez(path, **data)


@pytest.mark.parametrize("key,value", [
    ("params|w", np.full((3, 4), 99.0, np.float32)),
    ("params|b", np.zeros((4,), np.uint16)),          # bf16's stored view
    ("opt|step", np.asarray(8, np.int32))])
def test_corrupt_leaf_raises(tmp_path, key, value):
    ckpt.save(str(tmp_path), 3, _port_state())
    _corrupt_leaf(tmp_path, 3, key, value)
    with pytest.raises(ckpt.CheckpointCorruptError) as ei:
        ckpt.restore(str(tmp_path))
    assert ei.value.key == key.replace("|", "/")
    assert "state.npz" in str(ei.value)


def test_latest_step_verify_skips_corrupt(tmp_path):
    for s in (5, 10, 20):
        ckpt.save(str(tmp_path), s, _port_state())
    _corrupt_leaf(tmp_path, 20, "params|w", np.zeros((3, 4), np.float32))
    assert ckpt.latest_step(str(tmp_path)) == 20
    assert ckpt.latest_step(str(tmp_path), verify=True) == 10
    assert rckpt.latest_step(str(tmp_path), verify=True) == 10
    os.remove(os.path.join(str(tmp_path), "step_00000010", "manifest.json"))
    assert ckpt.latest_step(str(tmp_path), verify=True) == 5


def test_torn_and_missing(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    os.makedirs(tmp_path / ".tmp_abc")
    ckpt.save(str(tmp_path), 3, {"x": torch.zeros(())})
    assert ckpt.latest_step(str(tmp_path)) == 3
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), target={"x": torch.zeros(()),
                                            "y": torch.zeros(())})
    ckpt.save(str(tmp_path), 3, {"x": torch.ones(())})
    _, st = ckpt.restore(str(tmp_path), target={"x": torch.zeros(())})
    assert float(st["x"]) == 1.0


def test_unflatten_inverts_the_key_paths():
    flat = {"a/b": 1, "a/c/0": 2, "d": 3}
    assert ckpt.unflatten(flat) == {"a": {"b": 1, "c": {"0": 2}}, "d": 3}


# ---------------------------------------------------------------------------
# TrainSupervisor / StragglerWatchdog (tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------

def _deterministic_trainer(d, fail_at=None, ckpt_every=5):
    calls = {"fails": 0}

    def make_state(resume):
        if resume is None:
            return 0, {"x": torch.tensor(0.0), "step": torch.tensor(0)}
        target = {"x": torch.zeros(()),
                  "step": torch.zeros((), dtype=torch.int64)}
        return ckpt.restore(str(d), resume, target=target)

    def step_fn(step, state):
        return ({"x": state["x"] + step, "step": state["step"] + 1},
                {"x": float(state["x"])})

    def injector(step):
        if fail_at is not None and step == fail_at and calls["fails"] == 0:
            calls["fails"] += 1
            raise RuntimeError("simulated node failure")

    return TrainSupervisor(str(d), make_state, step_fn,
                           ckpt_every=ckpt_every), injector


def test_restart_resumes_identically(tmp_path):
    sup0, _ = _deterministic_trainer(tmp_path / "clean")
    state0, _ = sup0.run(20)
    sup1, inj = _deterministic_trainer(tmp_path / "faulty", fail_at=13)
    state1, hist1 = sup1.run(20, failure_injector=inj)
    assert sup1.restarts == 1
    assert float(state0["x"]) == float(state1["x"]) == float(sum(range(20)))
    assert int(state1["step"]) == 20
    # steps 10..12 ran twice: before the failure and after the restart
    assert [s for s, _ in hist1].count(11) == 2


def test_restart_budget_exhaustion(tmp_path):
    def step_fn(step, state):
        raise RuntimeError("always fails")

    sup = TrainSupervisor(str(tmp_path), lambda resume: (0, {}), step_fn,
                          max_restarts=2)
    with pytest.raises(RuntimeError):
        sup.run(5)
    assert sup.restarts == 3


def test_restart_skips_a_corrupt_newest_checkpoint(tmp_path):
    """The failure at step 12 also rots step 10's save: the restart
    resumes from step 5, the newest intact one, and converges."""
    sup, _ = _deterministic_trainer(tmp_path, ckpt_every=5)
    fails = []

    def injector(step):
        if step == 12 and not fails:
            fails.append(step)
            _corrupt_leaf(tmp_path, 10, "x", np.asarray(-1.0, np.float32))
            raise RuntimeError("node failure during a save")

    state, hist = sup.run(15, failure_injector=injector)
    assert sup.restarts == 1
    assert float(state["x"]) == float(sum(range(15)))
    assert [s for s, _ in hist].count(5) == 2


def test_to_checkpoint_shapes_what_is_saved(tmp_path):
    sup = TrainSupervisor(str(tmp_path), lambda r: (0, {"x": 1.0}),
                          lambda s, st: (st, {}), ckpt_every=2,
                          to_checkpoint=lambda st: {"saved": torch.tensor(
                              st["x"])})
    sup.run(2)
    _, flat = ckpt.restore(str(tmp_path))
    assert set(flat) == {"saved"}


def test_straggler_watchdog():
    w = StragglerWatchdog(factor=2.0, alpha=0.5)
    for i in range(10):
        assert not w.observe(i, 1.0)
    assert w.observe(10, 5.0)
    assert w.straggler_steps == 1
    assert w.events[0][0] == 10
    assert not w.observe(11, 1.0)


def test_straggler_ewma_math():
    w = StragglerWatchdog(factor=2.0, alpha=0.1)
    assert not w.observe(0, 1.0)       # seed: nothing to compare against
    assert w.ewma == 1.0
    assert not w.observe(1, 2.0)       # 2.0 == factor * ewma, not >
    assert abs(w.ewma - 1.1) < 1e-12
    assert w.observe(2, 2.3)           # against the pre-update ewma
    assert abs(w.ewma - (0.9 * 1.1 + 0.1 * 2.3)) < 1e-12
    assert w.straggler_steps == 1
    assert w.registry.snapshot() == {"step_time_s": w.ewma,
                                     "straggler_steps": 1}


def test_straggler_events_bounded():
    w = StragglerWatchdog(factor=2.0, alpha=0.0, events_cap=8)
    w.observe(0, 1.0)
    for i in range(1, 101):
        w.observe(i, 5.0)
    assert w.straggler_steps == 100
    assert len(w.events) == 8
    assert sorted(e[0] for e in w.events) == list(range(93, 101))
