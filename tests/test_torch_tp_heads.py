"""The head rule and the vocabulary-parallel embedding on the CPU, held
against ``repro``'s placement (ROADMAP C15):

* every registered config at tp 2, 4, 8 and 16: whether attention splits
  by heads, replicates its K/V heads or stays whole, each rank's query
  heads (contiguous, in rank order, covering every head; unequal where tp
  does not divide them) and local head counts, each rank's K/V heads
  (every query head of a rank reads one of them under ``repro``'s
  contiguous grouping), the table's rows; at tp 16 the production
  placement of the eight GQA-8 configs (deepseek-coder-33b's 7 heads a
  group split 4 + 3);
* that placement against ``repro``'s ``resolve_spec`` on a ``("model",)``
  mesh: q, o and the table are ``repro``'s shards, and so are k and v
  where ``repro`` splits whole K/V heads; where it splits part of a head
  the port holds the whole head (replication, C15's remainder), and where
  tp does not divide the query heads q and o hold the rank's head range
  (C15's remainder too);
* reduced ternary-paper with one K/V head at tp 2: streams, dense and
  paged, against tp 1 and ``repro``'s engine (its first train step, and
  two K/V heads at tp 4, are in ``test_torch_tp_heads_replicas.py``);
* ``head_replicas`` gives a nested marked node's every leaf its entry;
* reduced tied granite on ``repro``'s weights at tp 2 (two gloo ranks):
  the embedded rows bit for bit tp 1's, the prefill's and first decode
  step's logits within ``LOGIT_TOL`` of max|logit| of tp 1's and of
  ``repro``'s;
* a reduced dry-run prefill cell at tp 4 with two K/V heads: rank 0's
  attention scores (the softmax's FLOPs) are 1/4 of tp 1's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as rget_config
from repro.distributed import sharding as rsharding
from repro.models import LM as RLM
from repro.models.layers import FSDP, MODEL
from repro.serving import ContinuousScheduler as RScheduler

from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import tp as tp_lib
from repro_torch.launch import dryrun
from repro_torch.models import LM, layers
from repro_torch.optim.optimizers import tree_leaves

from test_torch_gloo_ranks import run_ranks
from test_torch_model import _packed_pair
from test_torch_tp import ENGINE, MODES, _serve_port, _streams, _workload
from test_torch_train import _np
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_tp_heads_ranks import tied_vocab_rank

TPS = (2, 4, 8, 16)
LOGIT_TOL = 3e-2
GQA8 = ("command-r-35b", "deepseek-coder-33b", "granite-3-8b",
        "internvl2-76b", "jamba-v0.1-52b", "kimi-k2-1t-a32b",
        "mistral-nemo-12b", "mixtral-8x22b")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", list_archs())
def test_placement_of_every_config(arch, tp):
    cfg = get_config(arch)
    place = tp_lib.attention_split(cfg, tp)
    h, kv = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads
    local = tp_lib.local_config(cfg, tp)
    if place is None:
        assert not kv or (kv % tp and tp % kv) or (
            kv % tp == 0 and h % tp) or (tp % kv == 0 and h < tp)
        assert (local.num_heads, local.num_kv_heads) == (cfg.num_heads, kv)
        assert all(tp_lib.query_heads(cfg, r, tp) == range(h)
                   for r in range(tp))
    else:
        assert place == ("heads" if kv % tp == 0 else "replicate")
        g = h // kv
        if h % tp:
            # whole heads, unequal shares: every K/V group's g heads over
            # its tp/KV ranks
            assert place == "replicate" and g >= tp // kv
        heads = [tp_lib.query_heads(cfg, r, tp) for r in range(tp)]
        # contiguous, in rank order, covering range(H)
        assert [i for hs in heads for i in hs] == list(range(h))
        held = [list(tp_lib.kv_heads(kv, r, tp)) for r in range(tp)]
        for r in range(tp):
            mine = tp_lib.local_config(cfg, tp, r)
            assert (mine.num_heads, mine.head_pad) == (len(heads[r]), 0)
            assert mine.num_kv_heads == max(kv // tp, 1) == len(held[r])
            assert min(len(hs) for hs in heads) <= mine.num_heads \
                <= len(heads[0])
            # repro's q.reshape(b, s, kvh, g, hd): query head i reads K/V
            # head i // g, and so does the rank's local head j
            per = len(heads[r]) // mine.num_kv_heads
            for j, i in enumerate(heads[r]):
                assert i // g == held[r][j // per]
        assert (local.num_heads, local.num_kv_heads) == (
            len(heads[0]), len(held[0]))
        if h % tp == 0:
            assert all(len(hs) == h // tp for hs in heads)
        assert sorted({x for hs in held for x in hs}) == list(range(kv))
        if place == "replicate":
            assert [held[r][0] for r in range(tp)] == [
                r // (tp // kv) for r in range(tp)]
    vp = cfg.padded_vocab()
    split = tp_lib.vocab_split((vp, cfg.d_model), ("model", "fsdp"),
                               {"model": tp})
    assert split == (vp % tp == 0)


def test_production_mesh_places_gqa8():
    """tp 16: the eight GQA-8 configs hold one K/V head a rank; the seven
    whose heads divide H/16 query heads a rank, deepseek's 56 heads (7 a
    K/V group, 2 ranks a group) 4 and 3 on ranks 2i and 2i + 1, both
    reading K/V head i (with head_pad=8, 4 each); every padded vocabulary
    of the registry divides."""
    for arch in GQA8:
        cfg = get_config(arch)
        assert tp_lib.attention_split(cfg, 16) == "replicate", arch
        assert cfg.padded_vocab() % 16 == 0
    cfg = get_config("deepseek-coder-33b")
    for r in range(16):
        local = tp_lib.local_config(cfg, 16, r)
        assert (local.num_heads, local.num_kv_heads) == (
            4 if r % 2 == 0 else 3, 1)
        assert list(tp_lib.kv_heads(8, r, 16)) == [r // 2]
    assert list(tp_lib.query_heads(cfg, 3, 16)) == [11, 12, 13]
    cfg = get_config("deepseek-coder-33b", head_pad=8)
    local = tp_lib.local_config(cfg, 16)
    assert (local.num_heads, local.num_kv_heads) == (4, 1)
    for arch in ("ternary-paper", "seamless-m4t-large-v2"):
        assert tp_lib.attention_split(get_config(arch), 16) == "heads"
    assert tp_lib.attention_split(get_config("mamba2-130m"), 16) is None


def _index_tree(cfg):
    """One attention layer and the table of ``cfg`` at full width, each
    weight's split axis holding its index (the other axis one wide)."""
    h, kv, hd = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads, cfg.head_dim
    vp = cfg.padded_vocab()

    def cols(n):
        return {"w": torch.arange(n, dtype=torch.float32)[None]}
    params = {"embed": {"table": torch.arange(vp, dtype=torch.float32)
                        [:, None]},
              "layers": [{"mixer": {
                  "q": cols(h * hd), "k": cols(kv * hd), "v": cols(kv * hd),
                  "o": {"w": torch.arange(h * hd, dtype=torch.float32)
                        [:, None]}}}]}
    lin = {"w": ("fsdp", "model")}
    specs = {"embed": {"table": ("model", "fsdp")},
             "layers": [{"mixer": {"q": lin, "k": lin, "v": lin,
                                   "o": {"w": ("model", "fsdp")}}}]}
    return params, specs


def _repro_width(shape, spec, tp):
    amesh = AbstractMesh((tp,), ("model",))
    return NamedSharding(amesh, rsharding.resolve_spec(
        spec, shape, amesh, False)).shard_shape(shape)


@pytest.mark.parametrize("tp", TPS)
def test_placement_against_repros_resolution(tp):
    """Each rank's q/k/v/o columns and table rows against ``repro``'s
    shards; C15's remainder counted: the configs where ``repro`` splits a
    K/V head across ranks and the port replicates it."""
    remainder = []
    for arch in list_archs():
        cfg = get_config(arch)
        if not cfg.num_kv_heads:
            continue
        h, kv, hd = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads, \
            cfg.head_dim
        d, vp = cfg.d_model, cfg.padded_vocab()
        place = tp_lib.attention_split(cfg, tp)
        params, specs = _index_tree(cfg)
        for r in range(tp):
            sh = tp_lib.shard_params(params, specs, {"model": tp}, rank=r,
                                     cfg=cfg, latent=True)
            mix = sh["layers"][0]["mixer"]
            q = mix["q"]["w"][0]
            rq = _repro_width((d, h * hd), P(FSDP, MODEL), tp)[1]
            rtab = _repro_width((vp, d), P(MODEL, FSDP), tp)[0]
            rows = sh["embed"]["table"][:, 0]
            assert torch.equal(rows, torch.arange(r * rtab, (r + 1) * rtab,
                                                  dtype=torch.float32))
            if place is None:
                assert torch.equal(q, params["layers"][0]["mixer"]["q"]
                                   ["w"][0])
                continue
            heads = tp_lib.query_heads(cfg, r, tp)
            mine = torch.arange(heads.start * hd, heads.stop * hd,
                                dtype=torch.float32)
            if h % tp == 0:
                assert torch.equal(mine, torch.arange(
                    r * rq, (r + 1) * rq, dtype=torch.float32))
            else:
                # repro's rank holds rq = H hd / tp columns, part of a
                # head; the port its whole heads
                assert mix["q"]["tp"] == ("qo", "n", h, kv, tp)
                assert mix["o"]["tp"] == ("qo", "k", h, kv, tp)
                assert rq % hd and mine.numel() in (
                    (h // tp) * hd, (h // tp + 1) * hd)
                if r == 0:
                    remainder.append(arch + ":q")
            assert torch.equal(q, mine)
            assert torch.equal(mix["o"]["w"][:, 0], q)
            want = torch.cat([torch.arange(x * hd, (x + 1) * hd)
                              for x in tp_lib.kv_heads(kv, r, tp)]).float()
            rk = _repro_width((d, kv * hd), P(FSDP, MODEL), tp)[1]
            for name in "kv":
                assert torch.equal(mix[name]["w"][0], want)
            if place == "heads":
                assert torch.equal(want, torch.arange(
                    r * rk, (r + 1) * rk, dtype=torch.float32))
            else:
                assert mix["k"]["tp"] == ("kv", kv, tp)
                assert rk < hd and want.numel() == hd
                if r == 0:
                    remainder.append(arch)
    if tp == 16:
        assert sorted(remainder) == sorted(GQA8 + ("deepseek-coder-33b:q",))
    elif tp <= 8:
        assert remainder == []


def test_cache_places_the_ranks_head():
    """``device_put_cache`` of a whole cache gives each rank its K/V head,
    the shape of the rank's own ``init_cache``."""
    cfg = get_config("ternary-paper", reduced=True, num_kv_heads=1)
    whole = LM(cfg, "cpu").init_cache(2, 8, torch.float32)["layers"][0]
    for t in whole.values():
        t.normal_()
    local = LM(tp_lib.local_config(cfg, 2), "cpu").init_cache(
        2, 8, torch.float32)["layers"][0]
    for r in (0, 1):
        got = tp_lib.device_put_cache(whole, cfg, {"model": 2}, rank=r)
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in local.items()}
        assert torch.equal(got["k"], whole["k"])


# ---------------------------------------------------------------------------
# one K/V head at tp 2: serving and the first train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_head_pair():
    return _packed_pair("bfloat16", num_layers=2, num_kv_heads=1)


@pytest.mark.parametrize("mode", ["dense", "paged_bf16"])
def test_one_kv_head_tp2_streams(one_head_pair, mode):
    rcfg, rparams, pcfg, pparams = one_head_pair
    assert tp_lib.attention_split(pcfg, 2) == "replicate"
    prompts, gens = _workload(pcfg.vocab_size, seed=21)
    pkw, rkw = MODES[mode]
    one, first1, _ = _serve_port(pcfg, pparams, prompts, gens, **pkw)
    two, first2, metrics = _serve_port(pcfg, pparams, prompts, gens,
                                       mesh=tp_lib.replica_meshes(
                                           1, 2, ["cpu", "cpu"],
                                           timeout_s=120.0)[0], **pkw)
    assert metrics["mesh"]["tp"] == 2
    scale = float(first1.abs().max())
    assert float((first2 - first1).abs().max()) <= LOGIT_TOL * scale
    _streams(pcfg, pparams, prompts, one, two)
    reng = RScheduler(rcfg, **ENGINE, **rkw)
    reng.load(rparams)
    rreqs = [reng.submit(p, g) for p, g in zip(prompts, gens)]
    reng.run()
    _streams(pcfg, pparams, prompts,
             [np.asarray(r.tokens, np.int32) for r in rreqs], two)


def test_head_replicas_line_up_with_nested_nodes():
    """``head_replicas`` gives every leaf of a marked node an entry, a
    nested one (a split SSM mixer's in_proj/out_proj) too, so its leaves
    line up with the gradients' one for one."""
    t = torch.zeros(2)
    grads = {"layers": [
        {"mixer": {"k": {"w": t, "b": t}, "v": {"w": t}, "q": {"w": t}}},
        {"mixer": {"in_proj": {"w": t, "b": t}, "out_proj": {"w": t},
                   "A_log": t}}]}
    marks = {("layers", 0, "mixer", "k"): ("kv", 2, 4),
             ("layers", 0, "mixer", "v"): ("kv", 2, 4),
             ("layers", 0, "mixer", "q"): "n",
             ("layers", 1, "mixer"): ("ssm",)}
    for rank, head in enumerate((0, 0, 1, 1)):
        got = tree_leaves(tp_lib.head_replicas(grads, marks, rank))
        assert len(got) == len(tree_leaves(grads)) == 8
        assert got == [head] * 3 + [None] * 5


# ---------------------------------------------------------------------------
# the vocabulary-parallel table of a tied model
# ---------------------------------------------------------------------------

def test_tied_table_split_rows_and_logits():
    """Reduced granite (tied) on ``repro``'s weights at tp 2: each rank's
    embedded rows bit for bit tp 1's; the prefill's last logits and the
    first decode step's (the same token fed everywhere: ``repro``'s
    argmax) within LOGIT_TOL of max|logit| of tp 1's and of ``repro``'s."""
    rcfg = rget_config("granite-3-8b", reduced=True)
    cfg = get_config("granite-3-8b", reduced=True)
    assert cfg.tie_embeddings
    tree = _np(RLM(rcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int64)
    max_len = 12
    rlm = RLM(rcfg)
    rparams = jax.tree.map(jnp.asarray, tree)
    rcache, rlog = rlm.prefill(rparams, {"tokens": jnp.asarray(
        tokens, jnp.int32)}, max_len)
    nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1)).astype(np.int64)
    rstep, _ = rlm.decode_step(rparams, rcache, jnp.asarray(
        nxt[:, None], jnp.int32))
    ranks = run_ranks(2, tied_vocab_rank, "granite-3-8b", {}, tree, tokens,
                      nxt, max_len)
    model = LM(cfg, "cpu")
    params = params_from_numpy(tree, cfg, "cpu")
    toks = torch.as_tensor(tokens)
    with torch.no_grad():
        rows = layers.embed_apply(params["embed"], toks, cfg)
        cache, logits = model.prefill(params, {"tokens": toks}, max_len)
        step, _ = model.decode_step(params, cache,
                                    torch.as_tensor(nxt[:, None]))
    wants = {"prefill": (logits[:, -1].float(), np.asarray(
                 rlog[:, -1], np.float32)),
             "decode": (step[:, 0].float(), np.asarray(rstep[:, 0],
                                                       np.float32))}
    ranks = [{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in got.items()} for got in ranks]
    for got in ranks:
        assert got["table"] == "vocab"
        assert got["table_rows"] == cfg.padded_vocab() // 2
        # f32 from the rank: exact for any bf16 row
        assert torch.equal(got["rows"], rows.float())
        for key, (one, rep) in wants.items():
            for want in (one, torch.from_numpy(rep)):
                scale = float(want.abs().max())
                assert float((got[key] - want).abs().max()) <= \
                    LOGIT_TOL * scale, key
    assert torch.equal(ranks[0]["decode"], ranks[1]["decode"])


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_scores_fall_with_the_heads():
    """Rank 0 of a reduced prefill cell (4 query heads, 2 K/V heads) at
    tp 4 scores 1/4 of tp 1's (one query head a rank, the K/V head
    replicated on two), and its table is a quarter of the vocabulary."""
    shape = ShapeConfig("prefill_tiny", 64, 2, "prefill")
    out = {}
    for tp in (1, 4):
        mesh = dryrun.parse_mesh(f"1x{tp}")
        _, cell = dryrun.trace_cell("ternary-paper", "prefill_tiny",
                                    mesh=mesh, reduced=True, shape=shape)
        out[tp] = cell
    soft = {tp: c.trace.plain.by_op["_softmax"][0] for tp, c in out.items()}
    assert soft[1] > 0 and soft[4] * 4 == soft[1]
    model = {g.name: g for g in out[4].groups}["model"]
    assert model.calls > 0
    cfg = get_config("ternary-paper", reduced=True)
    assert tp_lib.attention_split(cfg, 4) == "replicate"
