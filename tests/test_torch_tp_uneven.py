"""Query heads split by whole heads where tp does not divide them (the head
rule's uneven case, ROADMAP C15), on the CPU:

* ``weights.shard_range``: a row or column range of every format equals
  ``pack`` of the sliced matrix bit for bit, and a boundary off the pack
  multiple raises;
* reduced ternary-paper with 6 query heads and 2 K/V heads at tp 4 over
  four gloo ranks: each K/V group's 3 heads split 2 + 1 over its two
  ranks, so the ranks hold 2, 1, 2 and 1 query heads and K/V heads 0, 0,
  1 and 1 — deepseek-coder-33b's 4 + 3 at tp 16 in small, over two
  groups: streams, dense and paged bf16, against tp 1 and ``repro``'s
  engine (equal, or parting at a near tie: ``test_torch_tp``'s rule), the
  first decode step's logits within ``LOGIT_TOL`` of max|logit| of tp 1's;
* a reduced dry-run prefill cell at tp 4: rank 0's attention scores (the
  softmax's FLOPs) are 2/6 of tp 1's.

Its training (the first step, the gathered state, the K/V heads'
gradients, and the split with the state sharded over a data group) is in
``test_torch_tp_uneven_train.py``."""
import numpy as np
import pytest
import torch

from repro.serving import ContinuousScheduler as RScheduler

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import weights
from repro_torch.distributed import tp as tp_lib
from repro_torch.launch import dryrun

from test_torch_model import _packed_pair
from test_torch_tp import (ENGINE, LOGIT_TOL, MODES, _serve_port, _streams,
                           _workload)
from torch_cpu_threads import one_torch_thread  # noqa: F401

TP = 4
HEADS = dict(num_heads=6, num_kv_heads=2)


# ---------------------------------------------------------------------------
# the range form of a container's shard
# ---------------------------------------------------------------------------

FORMAT_OPTS = {"dense2bit": {}, "tiled": dict(tile_k=32, tile_n=32),
               "bitplane": {}, "base3": {}}


@pytest.mark.parametrize("fmt", list(FORMAT_OPTS))
@pytest.mark.parametrize("part", ["k", "n"])
def test_shard_range_equals_pack_of_the_slice(fmt, part):
    gen = torch.Generator().manual_seed(7)
    w = torch.randint(-1, 2, (160, 96), generator=gen).to(torch.int8)
    scale = torch.rand(96, generator=gen) + 0.5
    bias = torch.randn(96, generator=gen)
    wc = weights.pack(w, fmt, scale=scale, bias=bias, **FORMAT_OPTS[fmt])
    multiple = wc.shard_constraints()[part][1]
    extent = wc.k if part == "k" else wc.n
    cuts = [0, 2 * 32, extent] if multiple > 1 else [0, 37, extent]
    if fmt == "base3" and part == "k":
        cuts = [0, 5 * 13, extent]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        got = weights.shard_range(wc, part, lo, hi)
        if part == "k":
            want = weights.pack(w[lo:hi], fmt, scale=scale, bias=bias,
                                **FORMAT_OPTS[fmt])
        else:
            want = weights.pack(w[:, lo:hi], fmt, scale=scale[lo:hi],
                                bias=bias[lo:hi], **FORMAT_OPTS[fmt])
        assert got.shape == want.shape
        for name in wc._leaves:
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert torch.equal(a, b), (name, lo, hi)


@pytest.mark.parametrize("fmt,part,bad", [("dense2bit", "k", 24),
                                          ("tiled", "k", 48),
                                          ("tiled", "n", 40),
                                          ("bitplane", "k", 12),
                                          ("base3", "k", 12)])
def test_shard_range_off_the_pack_multiple_raises(fmt, part, bad):
    w = torch.randint(-1, 2, (160, 96), generator=torch.Generator()
                      .manual_seed(8)).to(torch.int8)
    wc = weights.pack(w, fmt, **FORMAT_OPTS[fmt])
    with pytest.raises(ValueError, match="pack multiple"):
        weights.shard_range(wc, part, 0, bad)
    with pytest.raises(ValueError, match="pack multiple"):
        weights.validate_range(wc, part, bad, wc.k if part == "k" else wc.n)


# ---------------------------------------------------------------------------
# 6 query heads, 2 K/V heads at tp 4: serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uneven_pair():
    return _packed_pair("bfloat16", num_layers=2, **HEADS)


def test_uneven_placement():
    cfg = get_config("ternary-paper", reduced=True, **HEADS)
    assert tp_lib.attention_split(cfg, TP) == "replicate"
    heads = [tp_lib.query_heads(cfg, r, TP) for r in range(TP)]
    assert [list(h) for h in heads] == [[0, 1], [2], [3, 4], [5]]
    assert [list(tp_lib.kv_heads(2, r, TP)) for r in range(TP)] == [
        [0], [0], [1], [1]]
    assert [(c.num_heads, c.num_kv_heads, c.head_pad) for c in (
        tp_lib.local_config(cfg, TP, r) for r in range(TP))] == [
        (2, 1, 0), (1, 1, 0), (2, 1, 0), (1, 1, 0)]


@pytest.mark.parametrize("mode", ["dense", "paged_bf16"])
def test_uneven_tp4_streams(uneven_pair, mode):
    rcfg, rparams, pcfg, pparams = uneven_pair
    prompts, gens = _workload(pcfg.vocab_size, seed=29)
    pkw, rkw = MODES[mode]
    one, first1, _ = _serve_port(pcfg, pparams, prompts, gens, **pkw)
    four, first4, metrics = _serve_port(
        pcfg, pparams, prompts, gens, mesh=tp_lib.replica_meshes(
            1, TP, ["cpu"] * TP, timeout_s=120.0)[0], **pkw)
    assert metrics["mesh"]["tp"] == TP
    scale = float(first1.abs().max())
    assert float((first4 - first1).abs().max()) <= LOGIT_TOL * scale
    _streams(pcfg, pparams, prompts, one, four)
    reng = RScheduler(rcfg, **ENGINE, **rkw)
    reng.load(rparams)
    rreqs = [reng.submit(p, g) for p, g in zip(prompts, gens)]
    reng.run()
    _streams(pcfg, pparams, prompts,
             [np.asarray(r.tokens, np.int32) for r in rreqs], four)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_rank0_scores_its_share():
    """Rank 0 of a reduced prefill cell at tp 4 holds 2 of the 6 query
    heads: its attention scores are 2/6 of tp 1's."""
    shape = ShapeConfig("prefill_tiny", 64, 2, "prefill")
    soft = {}
    for tp in (1, TP):
        _, cell = dryrun.trace_cell(
            "ternary-paper", "prefill_tiny", mesh=dryrun.parse_mesh(
                f"1x{tp}"), reduced=True, shape=shape, overrides=HEADS)
        assert cell.cfg.num_heads == 6
        soft[tp] = cell.trace.plain.by_op["_softmax"][0]
    assert soft[1] > 0 and soft[TP] * 6 == soft[1] * 2
