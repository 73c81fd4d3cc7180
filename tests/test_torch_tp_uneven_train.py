"""Training with query heads split by whole heads where tp does not
divide them (the head rule's uneven case, ROADMAP C15), on the CPU:

* reduced ternary-paper with 6 query heads and 2 K/V heads at tp 4 over
  four gloo ranks (2, 1, 2 and 1 query heads, K/V heads 0, 0, 1 and 1):
  the state gathered after the restore bit for bit the checkpoint's
  (``tp.gather_tree`` over unequal q/o ranges); the first f32 step
  against one process's and ``repro``'s (1e-5); each K/V head's
  gradients summed over its two ranks alone and equal on them
  (``check_replicas``: 2 layers x 2 leaves x 2 second ranks);
* 3 query heads and one K/V head at dp 2 x tp 2 with the state split
  over the data group (``cfg.fsdp``): the model ranks hold 2 and 1
  heads, and each data rank its half of their q and o leaves along
  d_model (``fsdp.data_marks``, where ``repro`` puts the data axes); the
  restored state, the first step and the K/V head's gradients as above.

Serving, the placement and the dry run are in
``test_torch_tp_uneven.py``."""
import dataclasses

import numpy as np
import pytest

from repro_torch.distributed import tp as tp_lib
from repro_torch.launch import train

from test_torch_dist_train import _trainer
from test_torch_tp_heads_replicas import (_leaves, check_first_step,
                                          first_step_refs)
from torch_cpu_threads import one_torch_thread  # noqa: F401

TP = 4
HEADS = dict(num_heads=6, num_kv_heads=2)


# ---------------------------------------------------------------------------
# 6 heads, 2 K/V heads at tp 4: the first step, the gathered state, the
# K/V heads' gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uneven_step(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("uneven_step0"))
    return (d,) + first_step_refs(d, **HEADS)


def test_uneven_tp4_first_train_step(uneven_step):
    ckpt0, pcfg, one, rep, start = uneven_step
    tr = _trainer(pcfg, 1, TP)
    try:
        assert tr.restore(ckpt0, 0) == 0
        whole = tr.checkpoint_tree()["params"]
        met = tr.step(0)
        state = tr.checkpoint_tree()
        reports = tr.report(grads_step=1)
    finally:
        tr.close()
    got, want = dict(_leaves(whole)), dict(_leaves(start))
    assert got.keys() == want.keys()
    # q's columns and o's rows, stacked over the 2 layers: 6 heads of 32
    qo = [path for path in got if path[-2] in ("q", "o")]
    assert sorted(got[path].shape for path in qo) == [
        (2, 128, 6 * 32), (2, 6 * 32, 128)]
    for path, leaf in want.items():
        assert np.array_equal(got[path], leaf), path
        assert got[path].tobytes() == leaf.tobytes(), path
    check_first_step(met, state, (one, rep))
    counts = train.check_replicas(reports)
    # k and v of each of the 2 layers; each of the 2 K/V heads on 2 ranks
    assert counts["head_grads_compared"] == 2 * 2 * 2
    for r, rep_r in enumerate(reports):
        held = [h for h in rep_r["heads"] if h is not None]
        assert held == [r // 2] * (2 * 2)


# ---------------------------------------------------------------------------
# 3 heads, 1 K/V head at dp 2 x tp 2 with the state sharded (cfg.fsdp)
# ---------------------------------------------------------------------------

def test_uneven_fsdp_dp2_tp2_first_train_step(tmp_path):
    ckpt0 = str(tmp_path)
    pcfg, one, rep, start = first_step_refs(ckpt0, num_heads=3,
                                            num_kv_heads=1)
    cfg = dataclasses.replace(pcfg, fsdp=True)
    assert tp_lib.attention_split(cfg, 2) == "replicate"
    assert [list(tp_lib.query_heads(cfg, r, 2)) for r in range(2)] == [
        [0, 1], [2]]
    tr = _trainer(cfg, 2, 2)
    try:
        assert tr.restore(ckpt0, 0) == 0
        whole = tr.checkpoint_tree()["params"]
        met = tr.step(0)
        state = tr.checkpoint_tree()
        reports = tr.report(grads_step=1)
    finally:
        tr.close()
    got, want = dict(_leaves(whole)), dict(_leaves(start))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].tobytes() == leaf.tobytes(), path
    assert all(r["sharded"] for r in reports)
    check_first_step(met, state, (one, rep))
    # k and v of the 2 layers, on the second model rank of each data rank
    counts = train.check_replicas(reports)
    assert counts["head_grads_compared"] == 2 * 2 * 2
