"""The dry run: one rank of every (architecture x input shape x mesh)
cell traced on ``meta`` tensors, with its per-rank FLOPs, device-memory
and collective bytes, memory and the bound of its step on H100 nodes
(the port's counterpart of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell for 256 or 512 placeholder TPU
devices under GSPMD. The port has no single-controller compiler: a mesh
is one process a rank (``distributed.tp``), so a cell traces what rank 0
of the port's own placement runs, allocated nowhere and run nowhere:

* the parameters are ``steps.model_shardings``' (packed containers for a
  ``ternary_packed`` config), sharded by ``tp.shard_params(..., rank=0,
  cfg=)`` for a model of ``tp.local_config`` — the head rule (C15),
  ``moe_split`` and ``ssm_split`` (C18) apply as in serving and training;
  every data rank keeps the whole of its shard and AdamW's moments (C16);
* the batch is the rank's share of ``steps.input_specs`` under
  ``sharding.batch_sharding``;
* collectives go through ``RecordingGroup``, a stand-in for
  ``tp.Group`` that counts ``calls`` and ``bytes`` as the real one does,
  returns its input (an all-gather: a tensor of the gathered shape), and
  charges the walker by ``repro``'s ring rule;
* ``train`` cells run ``steps.make_train_step`` (value and grad over
  ``cfg.grad_accum`` microbatches, the clip, AdamW) with the data group's
  f32 mean all-reduce; ``prefill`` cells ``make_prefill_step``;
  ``decode`` cells ``make_decode_step`` over the rank's slice of the dense
  cache (its local KV heads, its batch rows), as ``repro``'s decode step
  uses the dense cache, every row at the cache's last position.

``hlo_cost.trace`` charges every op of the step (its module docstring has
the rules). The record keeps ``repro``'s keys, so ``benchmarks/
roofline.py --out-dir`` reads the port's records: ``hlo_flops_per_chip``,
``hlo_bytes_per_chip`` and ``collective_bytes_per_chip`` hold the plain
reading (the names kept for those readers), ``kernel_flops_per_chip`` and
``kernel_bytes_per_chip`` the reading with each kernel dispatch charged
by its plan, ``flop_counter`` takes the place of ``xla_cost_analysis``
(``FlopCounterMode``'s total) and ``trace_s`` that of ``lower_s`` /
``compile_s``. ``memory`` holds the rank's arguments (parameters,
optimizer state, batch, cache), its outputs, the most bytes of storage
live at once during the step (``peak_bytes``), the rest of it over the
arguments (``temp_size_in_bytes``) and whether the peak fits a card
(``fits``): the card's peak, each kernel dispatch holding its output and
not its plain version's temporaries (those are in ``plain_peak_bytes``).

Times come from the H100 SXM's data sheet, in one place: ``PEAK_FLOPS``
and ``HBM_BW`` from ``kernels.autotune``, ``NVLINK_BW`` (NVLink 4, each
way a card), ``IB_BW`` (one 400 Gb/s NDR port a card), ``NODE_CARDS`` and
``HBM_BYTES``. A collective's bytes move at NVLink's rate when its
group's ranks lie in one node and at InfiniBand's otherwise, ranks laid
row-major on nodes of ``NODE_CARDS`` (``make_production_mesh``): on the
16 x 16 production mesh the model group of 16 spans two nodes, so its
all-reduces run at InfiniBand's rate; ``--mesh 32x8`` keeps it in one.

Usage (no card needed)::

  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod] \\
      [--quant ternary_packed] [--mesh 32x8] [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.distributed import tp as tp_lib
from repro_torch.kernels.autotune import HBM_BW, PEAK_FLOPS
from repro_torch.launch import hlo_cost
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import LM
from repro_torch.obs import clock as obs_clock

__all__ = ["run_cell", "model_flops", "rank_step", "RecordingGroup",
           "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "IB_BW", "NODE_CARDS",
           "HBM_BYTES", "main"]

# --- the H100 SXM's data sheet (PEAK_FLOPS, HBM_BW: kernels.autotune) ---
NVLINK_BW = 450e9          # bytes/s a card, each way (NVLink 4)
IB_BW = 50e9               # bytes/s a card (one 400 Gb/s NDR port)
NODE_CARDS = 8             # cards a node, joined by NVLink
HBM_BYTES = 80 * 2 ** 30   # device memory a card


class RecordingGroup(tp_lib.Group):
    """A stand-in for one rank's ``tp.Group`` in a traced step: the same
    ``all_reduce``, ``all_reduce_flat`` and ``all_gather``, counting
    ``calls`` and ``bytes`` as ``Group._run`` does and charging
    ``hlo_cost`` by ``repro``'s ring rule (``link_bytes``: an all-reduce 2
    × its operand, an all-gather its result), moving nothing.
    ``ranks`` are the group's global ranks; ``link`` is ``"nvlink"`` when
    they lie in one node of ``NODE_CARDS``, else ``"infiniband"``, and
    ``bandwidth`` its rate."""

    def __init__(self, name: str, rank: int, ranks: List[int]):
        super().__init__(rank, len(ranks), None, None, "record")
        self.name, self.ranks = name, list(ranks)
        one_node = len({r // NODE_CARDS for r in ranks}) == 1
        self.link = "nvlink" if one_node else "infiniband"
        self.bandwidth = NVLINK_BW if one_node else IB_BW
        self.link_bytes = 0.0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self._run(t, lambda: None)
        self.link_bytes += 2.0 * t.numel() * t.element_size()
        hlo_cost.note_collective("all-reduce", t, t)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self._run(t, lambda: None)
        out = torch.cat(outs, dim=dim)
        self.link_bytes += out.numel() * out.element_size()
        hlo_cost.note_collective("all-gather", t, out)
        return out

    def seconds_modelled(self) -> float:
        return self.link_bytes / self.bandwidth

    def summary(self) -> Dict[str, Any]:
        return {"size": self.size, "calls": self.calls, "bytes": self.bytes,
                "link_bytes": self.link_bytes, "link": self.link,
                "t_s": self.seconds_modelled()}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic 'useful' FLOPs per step: 6*N_active*D train, 2*N_active*D
    inference (D = tokens processed in the step)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/seq


def _rank_batch(cfg: ModelConfig, shape: ShapeConfig, mesh,
                device="meta") -> Dict[str, torch.Tensor]:
    """Rank 0's share of the cell's batch: the rows of dimension 0 that
    ``sharding.batch_sharding`` splits over the data axes."""
    specs = steps_lib.input_specs(cfg, shape)
    placed = sharding.batch_sharding(
        {k: torch.empty(s, dtype=d, device="meta")
         for k, (s, d) in specs.items()}, mesh)
    dp = mesh.size // mesh.tp
    out = {}
    for k, (s, d) in specs.items():
        rows = s[0] // dp if placed[k] else s[0]
        out[k] = torch.zeros((rows,) + tuple(s[1:]), dtype=d, device=device)
    return out


def _groups(mesh) -> Tuple[Optional[RecordingGroup],
                           Optional[RecordingGroup]]:
    """Rank 0's (data, model) recording groups, None where an axis is
    one rank: the model group is ranks 0..tp-1, the data group every
    tp-th rank (``model`` innermost)."""
    tp = mesh.tp
    dp = mesh.size // tp
    model = RecordingGroup("model", 0, list(range(tp))) if tp > 1 else None
    data = RecordingGroup("data", 0, [i * tp for i in range(dp)]) \
        if dp > 1 else None
    return data, model


def _own_storage(tree):
    """``tree`` with every ``meta`` tensor (container fields too) a fresh
    one of its shape: a rank's slice of a whole ``meta`` tensor is a view
    of the whole storage, which would count as the rank's bytes."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta") \
            if tree.is_meta else tree
    if isinstance(tree, dict):
        return {k: _own_storage(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_own_storage(v) for v in tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _own_storage(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


def rank_step(cfg: ModelConfig, shape: ShapeConfig, mesh, params=None,
              device="meta"):
    """(step function, its arguments, the groups) of rank 0 of ``mesh``
    for the cell (module docstring). ``params`` (a whole tree on
    ``device``) replaces the ``meta`` shapes of ``steps.model_shardings``;
    the batch and the cache are zeros on ``device``."""
    tp = mesh.tp
    train = shape.kind == "train"
    latent = train or cfg.quantization == "ternary"
    full = LM(cfg, "meta")
    if params is None:
        params, _ = steps_lib.model_shardings(full, cfg, mesh)
    sharded = _own_storage(tp_lib.shard_params(
        params, full.param_specs(params), mesh, rank=0, cfg=cfg,
        latent=latent))
    data, model_group = _groups(mesh)
    model = LM(tp_lib.local_config(cfg, tp), device)
    model.comm = model_group
    batch = _rank_batch(cfg, shape, mesh, device)
    groups = [g for g in (data, model_group) if g is not None]
    if train:
        marks = {}
        if tp > 1:
            sharded, marks = tp_lib.strip_marks(sharded)
        step, opt_init = steps_lib.make_train_step(
            model, cfg, data_group=data, marks=marks)
        return step, (sharded, opt_init(sharded), batch), groups
    if shape.kind == "prefill":
        step = steps_lib.make_prefill_step(model, cfg, shape.seq_len)
        return step, (sharded, batch), groups
    rows = batch["tokens"].shape[0]
    cache = model.init_cache(rows, shape.seq_len)
    # every row at the cache's last position, a (B,) vector as the
    # engine's slots keep (a scalar position would index on the host)
    cache["pos"] = torch.full((rows,), shape.seq_len - 1, dtype=torch.int32,
                              device=device)
    if cfg.is_encdec:
        cache["enc_out"] = torch.zeros((rows, cfg.frontend_seq, cfg.d_model),
                                       dtype=torch.bfloat16, device=device)
    step = steps_lib.make_decode_step(model, cfg)
    return step, (sharded, cache, batch["tokens"]), groups


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.sizes)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             quant: str = "", overrides: Optional[Dict[str, Any]] = None,
             mesh=None, reduced: bool = False,
             shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """One cell's record (module docstring). ``shape`` (a ``ShapeConfig``
    of the caller's) replaces ``SHAPES[shape_name]``."""
    shape = shape or SHAPES[shape_name]
    kw = dict(overrides or {})
    if quant:
        kw["quantization"] = quant
    cfg = get_config(arch, reduced=reduced, **kw)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "quant": quant or cfg.quantization,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
    }
    ok, reason = cfg.supports_shape(shape_name)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        rec["mesh"] = _mesh_name(mesh)
    chips = mesh.size
    t0 = obs_clock.now()
    step, args, groups = rank_step(cfg, shape, mesh)
    tr = hlo_cost.trace(step, *args)
    t_trace = obs_clock.now() - t0

    coll = dict(tr.plain.collective_bytes)
    coll["total"] = tr.plain.total_collective()
    mf = model_flops(cfg, shape)
    t_comp = tr.plain.flops / PEAK_FLOPS
    t_mem = tr.plain.bytes / HBM_BW
    t_coll = sum(g.seconds_modelled() for g in groups)
    dominant = max((("compute", t_comp), ("memory", t_mem),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    temp = tr.peak_bytes - tr.argument_bytes
    rec.update(
        status="ok",
        chips=chips,
        trace_s=round(t_trace, 1),
        hlo_flops_per_chip=tr.plain.flops,
        hlo_bytes_per_chip=tr.plain.bytes,
        collective_bytes_per_chip=coll,
        kernel_flops_per_chip=tr.kernel.flops,
        kernel_bytes_per_chip=tr.kernel.bytes,
        kernel_t_compute_s=tr.kernel.flops / PEAK_FLOPS,
        kernel_t_memory_s=tr.kernel.bytes / HBM_BW,
        flop_counter={"flops": tr.flop_counter},
        collectives={g.name: g.summary() for g in groups},
        memory={"argument_size_in_bytes": tr.argument_bytes,
                "output_size_in_bytes": tr.output_bytes,
                "alias_size_in_bytes": tr.alias_bytes,
                "temp_size_in_bytes": temp,
                "peak_bytes": tr.peak_bytes,
                "plain_peak_bytes": tr.plain_peak_bytes,
                "fits": tr.peak_bytes <= HBM_BYTES},
        t_compute_s=t_comp,
        t_memory_s=t_mem,
        t_collective_s=t_coll,
        dominant=dominant,
        model_flops_total=mf,
        model_flops_per_chip=mf / chips,
        useful_flops_ratio=((mf / chips) / tr.plain.flops
                            if tr.plain.flops else None),
        params_total=cfg.param_count(),
        params_active=cfg.active_param_count(),
    )
    return rec


def parse_mesh(arg: str):
    """``"DxM"`` -> a ``("data", "model")`` mesh, ``"PxDxM"`` -> ``("pod",
    "data", "model")``, over ``"meta"`` devices."""
    dims = tuple(int(x) for x in arg.split("x"))
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh expects DxM or PxDxM, got {arg!r}")
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    n = 1
    for d in dims:
        n *= d
    return tp_lib.Mesh(names, dims, ("meta",) * n)


def _override(key: str, value: str):
    f = ModelConfig.__dataclass_fields__[key]
    typ = f.type if isinstance(f.type, type) else {
        "int": int, "float": float, "bool": bool, "str": str}[f.type]
    return (value.lower() in ("1", "true")) if typ is bool else typ(value)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--quant", default="")
    ap.add_argument("--out", default=os.path.join("experiments",
                                                  "dryrun_torch"))
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--mesh", default="",
                    help="'DxM' or 'PxDxM' mesh instead of production")
    args = ap.parse_args(argv)

    mesh = parse_mesh(args.mesh) if args.mesh else None
    archs = [a for a in list_archs() if a != "ternary-paper"] \
        if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    overrides: Dict[str, Any] = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _override(k, v)

    os.makedirs(args.out, exist_ok=True)
    mesh_tag = _mesh_name(mesh) if mesh is not None else (
        "2x16x16" if args.multi_pod else "16x16")
    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}_{shape}_{mesh_tag}"
            if args.quant:
                tag += f"_{args.quant}"
            if overrides:
                tag += "_" + "_".join(f"{k}-{v}" for k, v in overrides.items())
            path = os.path.join(args.out, tag + ".json")
            try:
                rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                               quant=args.quant, overrides=overrides,
                               mesh=mesh)
            except Exception as e:  # noqa: BLE001 — recorded, exit 1
                rec = {"arch": arch, "shape": shape, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            print(f"{tag}: {rec['status']} "
                  + (f"dom={rec.get('dominant')} "
                     f"t=({rec.get('t_compute_s', 0):.2e},"
                     f"{rec.get('t_memory_s', 0):.2e},"
                     f"{rec.get('t_collective_s', 0):.2e})s "
                     f"peak={rec['memory']['peak_bytes'] / 2 ** 30:.1f}GiB "
                     f"trace={rec.get('trace_s')}s"
                     if rec["status"] == "ok"
                     else rec.get("reason", rec.get("error", ""))),
                  flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
