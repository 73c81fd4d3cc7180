"""The port's cost walker (``repro_torch.launch.hlo_cost``), the
counterpart of ``tests/test_hlo_cost.py``: a model's cost is its layers'
sum (no trip count to recover), a remat'd backward counts the recomputed
forward, a gather charges rows and not the table, the matmul class is
``FlopCounterMode``'s count, and a reduced model's three steps cost the
same on ``meta`` tensors as on real CPU tensors under the same dispatch.
The kernel reading charges a packed dispatch by its plan, and a ``meta``
tensor takes the card's lowering without launching anything."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib
from repro_torch.launch import dryrun, hlo_cost, serve, steps
from repro_torch.models import LM

from torch_cpu_threads import one_torch_thread  # noqa: F401

MESH1 = dryrun.parse_mesh("1x1")
TRAIN = ShapeConfig("train", 32, 4, "train")
PREFILL = ShapeConfig("prefill", 32, 4, "prefill")
DECODE = ShapeConfig("decode", 48, 4, "decode")
# a reduced model's widths (128) pack under this minimum
MIN_DIM = dict(ternary_min_dim=64)


def _meta(tree):
    """``tree`` with every tensor (container fields too) an empty ``meta``
    tensor of its shape and dtype."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f: _meta(getattr(tree, f)) for f in tree._leaves
            if getattr(tree, f) is not None})
    return tree


def _costs(arch, shape, device="meta", params=None, **over):
    cfg = get_config(arch, reduced=True, **over)
    step, args, _ = dryrun.rank_step(cfg, shape, MESH1, params=params,
                                     device=device)
    return hlo_cost.trace(step, *args)


@pytest.mark.parametrize("shape", [TRAIN, PREFILL, DECODE],
                         ids=lambda s: s.kind)
def test_a_model_costs_its_layers_sum(shape):
    """L layers cost the stack without layers plus L times one layer's
    ops: C(3) - C(1) == 2 (C(2) - C(1)), FLOPs and bytes, both readings
    (the port's Python loop runs every layer; ``repro``'s walker needs
    the scan's trip count for this)."""
    c = {n: _costs("granite-3-8b", shape, num_layers=n, grad_accum=1)
         for n in (1, 2, 3)}
    for reading in ("plain", "kernel"):
        one, two, three = (getattr(c[n], reading) for n in (1, 2, 3))
        assert two.flops > one.flops > 0
        assert three.flops - one.flops == 2 * (two.flops - one.flops)
        assert three.bytes - one.bytes == 2 * (two.bytes - one.bytes)


def _dot_flops(n, dim):
    return n * 2 * dim ** 3


def test_remat_backward_counts_the_recomputed_forward():
    """A checkpointed block's backward runs its forward again: 10 blocks
    of one (64, 64) product cost forward 10 + recompute 10 + backward 20
    products, against 30 without the checkpoint."""
    x = torch.empty((64, 64), device="meta", requires_grad=True)
    ws = [torch.empty((64, 64), device="meta", requires_grad=True)
          for _ in range(10)]

    def blk(h, w):
        return torch.tanh(h @ w)

    def loss(remat):
        h = x
        for w in ws:
            h = (torch_checkpoint.checkpoint(blk, h, w, use_reentrant=False)
                 if remat else blk(h, w))
        return torch.autograd.grad((h ** 2).sum(), [x] + ws)

    plain = hlo_cost.matmul_flops(hlo_cost.analyze(lambda: loss(False)))
    remat = hlo_cost.matmul_flops(hlo_cost.analyze(lambda: loss(True)))
    assert plain == _dot_flops(30, 64)
    assert remat == _dot_flops(40, 64)


@pytest.mark.parametrize("lookup", ["index", "embedding", "index_select"])
def test_gather_bytes_not_full_table(lookup):
    """Embedding-style gathers charge the rows they move (twice), not
    the table."""
    table = torch.empty((50000, 512), device="meta")
    idx = torch.zeros((64,), dtype=torch.long, device="meta")
    fn = {"index": lambda t, i: t[i],
          "embedding": lambda t, i: F.embedding(i, t),
          "index_select": lambda t, i: t.index_select(0, i)}[lookup]
    c = hlo_cost.analyze(fn, table, idx)
    assert c.bytes == 2 * 64 * 512 * 4
    assert c.bytes < 50000 * 512 * 4 / 10


def test_views_and_allocations_are_free_and_region_writes_charge_the_region():
    cache = torch.zeros((8, 4096, 64), device="meta")
    tok = torch.empty((8, 64), device="meta")

    def step(c, t):
        c.view(8, 64, 64, 64).permute(0, 2, 1, 3)[:, :4].unsqueeze(
            0).expand(2, -1, -1, -1, -1).transpose(0, 1)
        torch.empty((1 << 20,), device="meta")
        c[:, 7] = t                     # one position of every row
        c.narrow(1, 100, 2).copy_(c.narrow(1, 0, 2))
        return c

    got = hlo_cost.analyze(step, cache, tok)
    # the indexed write: 2 x one (8, 64) f32 row set; the copy 2 x 4 KB
    assert got.bytes == 2 * 8 * 64 * 4 + 2 * (8 * 2 * 64 * 4)
    assert got.flops == 0


def test_flop_counter_equals_the_matmul_class():
    """``FlopCounterMode``'s total over a reduced model's train step (the
    library's own count) equals the walker's matmul class, and the
    trace's own ``flop_counter`` (the same formulas) too."""
    cfg = get_config("granite-3-8b", reduced=True, grad_accum=1)
    step, args, _ = dryrun.rank_step(cfg, TRAIN, MESH1)
    t = hlo_cost.trace(step, *args)
    lib = hlo_cost.flop_counter(step, *args)
    assert lib == hlo_cost.matmul_flops(t.plain) == t.flop_counter > 0
    # the walker's elementwise and reductions come on top
    assert t.plain.flops > lib


@pytest.mark.parametrize("shape,packed", [
    (TRAIN, False), (PREFILL, False), (DECODE, False), (PREFILL, True),
    (DECODE, True)], ids=["train", "prefill", "decode", "prefill-packed",
                          "decode-packed"])
def test_meta_and_cpu_tensors_cost_the_same(shape, packed):
    """A reduced model's three steps on real CPU tensors (random weights,
    packed ones for serving) and on ``meta`` copies of the same tree give
    equal costs — both readings, op by op — and equal storage bytes,
    under the same dispatch (``fused_mlp="off"``: a meta MLP would take
    the card's fused row, a CPU one the chain). QAT trains latent
    weights."""
    over = dict(grad_accum=2, fused_mlp="off", quantization="ternary",
                **MIN_DIM)
    cfg = get_config("granite-3-8b", reduced=True, **over)
    if packed:
        cfg, params = serve.build_params(cfg, 0, "cpu", packed=True)
        over["quantization"] = "ternary_packed"
    else:
        params = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    real = _costs("granite-3-8b", shape, "cpu", params, **over)
    meta = _costs("granite-3-8b", shape, "meta", _meta(params), **over)
    for reading in ("plain", "kernel"):
        a, b = getattr(real, reading), getattr(meta, reading)
        assert a.by_op == b.by_op
        assert (a.flops, a.bytes) == (b.flops, b.bytes)
    assert (real.argument_bytes, real.peak_bytes, real.output_bytes) == (
        meta.argument_bytes, meta.peak_bytes, meta.output_bytes)
    if packed:
        kernels = [k for k in meta.kernel.by_op if k.startswith("ternary")]
        assert kernels == ["ternary_gemm[dense2bit/dense]"]
        assert "ternary_gemm[dense2bit/dense]" not in meta.plain.by_op


def test_a_meta_mlp_takes_the_cards_fused_row_and_launches_nothing():
    """On ``meta`` a packed MLP dispatches B4's row (``fused_mlp``) as on
    the card, computes through the plain version, launches nothing, and
    the kernel reading charges its plan's roofline; on the CPU the same
    MLP is three ``ternary_gemm`` dispatches."""
    cfg = get_config("granite-3-8b", reduced=True,
                     quantization="ternary_packed", **MIN_DIM)
    before = gemm_lib.ternary_gemm_cuda.launches
    t = _costs("granite-3-8b", PREFILL, quantization="ternary_packed",
               **MIN_DIM)
    assert gemm_lib.ternary_gemm_cuda.launches == before
    fused = t.kernel.by_op["fused_mlp[pallas]"]
    layers = cfg.num_layers
    rows = PREFILL.global_batch * PREFILL.seq_len
    x = torch.empty((rows, cfg.d_model), dtype=torch.bfloat16, device="meta")
    mlp = steps.model_shardings(LM(cfg, "meta"), cfg,
                                MESH1)[0]["layers"][0]["ffn"]
    plan = ops.fused_mlp_plan(mlp["in"]["w_packed"], mlp["out"]["w_packed"],
                              mlp["gate"]["w_packed"], m=x.shape[0])
    r = plan.roofline()
    assert fused == [layers * r["flops"], layers * r["bytes"]]
    assert "fused_mlp[pallas]" not in t.plain.by_op
    cpu = _costs("granite-3-8b", PREFILL, "cpu",
                 serve.build_params(get_config(
                     "granite-3-8b", reduced=True, quantization="ternary",
                     **MIN_DIM), 0, "cpu", packed=True)[1],
                 quantization="ternary_packed", **MIN_DIM)
    assert "fused_mlp[pallas]" not in cpu.kernel.by_op
    assert t.kernel.by_op["ternary_gemm[dense2bit/dense]"][0] < \
        cpu.kernel.by_op["ternary_gemm[dense2bit/dense]"][0]


def test_packed_shapes_keep_the_expected_density():
    """The dry run's packed containers carry what TWN ternarization of
    random N(0, s^2) weights keeps (so a plan keys the sparsity bucket of
    a packed random model), and a real pack lands near it."""
    cfg = get_config("granite-3-8b", reduced=True, quantization="ternary",
                     **MIN_DIM)
    d = steps.twn_density(cfg.ternary_threshold)
    assert abs(d - 0.5767) < 1e-3
    _, real = serve.build_params(cfg, 0, "cpu", packed=True)
    meta = steps.packed_shapes(_meta(LM(cfg, "cpu").init(
        torch.Generator().manual_seed(0))), cfg)
    got = real["layers"][0]["mixer"]["q"]["w_packed"]
    want = meta["layers"][0]["mixer"]["q"]["w_packed"]
    assert want.shape == got.shape and want.packed.shape == got.packed.shape
    assert abs(want.occupancy() - got.occupancy()) < 0.02
