"""Rank functions for the tensor-parallel family tests and the sharded
training state's (``cfg.fsdp``), run on CPU ranks over gloo by ``test_torch_gloo_ranks.run_ranks`` (each spawned process
imports this module — torch and numpy, no JAX — and nothing of the
calling test file)."""
import numpy as np
import torch


def _block(a, n, rank, axis):
    return torch.from_numpy(np.ascontiguousarray(
        np.split(a, n, axis=axis)[rank]))


def _host(t):
    return t.detach().cpu().numpy()


def family_rank_checks(group, rank, y, z, scale, g_out, w_bank, g_bank):
    """This rank's side of two checks, as numpy:

    * the SSM gated norm of its d_inner slice of y, z and the scale
      (``ssm._gated_norm`` with the group: one f32 all-reduce of the sum
      of squares) and its gradients under its slice of ``g_out``
      (``norm``, ``gy``, ``gz``, ``gscale``);
    * ``quantize.ste_ternarize_rows`` of its row block of an (E, K, N)
      expert bank (``ste_y``) and the gradient under its rows of
      ``g_bank`` (``ste_g``)."""
    from repro_torch.core import quantize
    from repro_torch.models import ssm

    n = group.size
    ys, zs, ss = (_block(a, n, rank, -1).requires_grad_()
                  for a in (y, z, scale))
    out = ssm._gated_norm(ys, zs, ss, 1e-5, group)
    gy, gz, gs = torch.autograd.grad(out, [ys, zs, ss],
                                     _block(g_out, n, rank, -1))
    res = {"norm": _host(out), "gy": _host(gy), "gz": _host(gz),
           "gscale": _host(gs)}
    wb = _block(w_bank, n, rank, -2).requires_grad_()
    yb = quantize.ste_ternarize_rows(wb, 0.7, group)
    (gb,) = torch.autograd.grad(yb, [wb], _block(g_bank, n, rank, -2))
    res["ste_y"], res["ste_g"] = _host(yb), _host(gb)
    return res


def routes_rank(group, rank, cfg, params, tokens):
    """Prefill ``tokens`` on this rank's shards of ``params`` inside the
    group, recording every MoE layer's capacity pick: (the picks, the
    last position's logits), as numpy."""
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.models import LM, moe
    from repro_torch.models.transformer import param_specs

    mesh = {"model": group.size}
    shards = tp_lib.shard_params(params, param_specs(cfg, params), mesh,
                                 rank=rank, cfg=cfg)
    model = LM(tp_lib.local_config(cfg, group.size, rank), "cpu")
    model.comm = group
    with torch.no_grad(), moe.recorded_routes() as log:
        _, logits = model.prefill(shards, {"tokens": torch.as_tensor(
            tokens)}, tokens.shape[1] + 1)
    return [t.numpy() for t in log], _host(logits.float())


def decode_comm_rank(group, rank, cfg, params, rows, cache_len):
    """One decode step of ``rows`` rows over a ``cache_len`` dense cache on
    this rank's shards of ``params`` inside the group: (the data
    collectives' calls, the bytes this rank put in)."""
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.models import LM
    from repro_torch.models.transformer import param_specs

    mesh = {"model": group.size}
    shards = tp_lib.shard_params(params, param_specs(cfg, params), mesh,
                                 rank=rank, cfg=cfg)
    model = LM(tp_lib.local_config(cfg, group.size, rank), "cpu")
    model.comm = group
    cache = model.init_cache(rows, cache_len)
    cache["pos"] = torch.full((rows,), cache_len - 1, dtype=torch.int32)
    tokens = torch.zeros((rows, 1), dtype=torch.int32)
    with torch.no_grad():
        model.decode_step(shards, cache, tokens)
    return group.calls, group.bytes


def _rows(batch, rank, n):
    return {k: torch.as_tensor(np.split(v, n)[rank]) for k, v in
            batch.items()}


def fsdp_grads_rank(group, rank, cfgs, params, batch):
    """For each config of ``cfgs``, the data group's mean of the
    gradients of this rank's rows of ``batch`` (block ``rank`` of
    dimension 0), before the clip: on the whole params through
    ``steps.mean_all_reduce``, and on this rank's data slices
    (``LM.shards``: each reduce-scattered, then gathered back), as numpy
    trees [(whole, sharded)]."""
    return [_fsdp_grads(group, rank, cfg, params, batch) for cfg in cfgs]


def _fsdp_grads(group, rank, cfg, params, batch):
    from repro_torch.distributed import fsdp
    from repro_torch.launch import steps
    from repro_torch.models import LM
    from repro_torch.models.transformer import param_specs
    from repro_torch.optim.optimizers import tree_map

    mine = _rows(batch, rank, group.size)
    model = LM(cfg, "cpu")
    _, g = steps.value_and_grad(model, cfg, params, mine)
    whole = steps.mean_all_reduce(g, group)
    marks = fsdp.data_marks(params, param_specs(cfg, params),
                            {"data": group.size, "model": 1}, True)
    model.shards = fsdp.Shards(marks, group)
    _, g = steps.value_and_grad(
        model, cfg, fsdp.shard_data(params, marks, rank, group.size), mine)
    sharded = fsdp.gather_data(steps.mean_all_reduce(g, group, marks),
                               marks, group)
    return (tree_map(lambda t: t.numpy(), whole),
            tree_map(lambda t: t.numpy(), sharded))


def fsdp_train_comm_rank(group, rank, cfg, params, batch):
    """One fsdp train step (``steps.make_train_step`` on this rank's data
    slices and rows of ``batch``) over the group: (the data collectives'
    calls, the bytes this rank put in)."""
    from repro_torch.distributed import fsdp
    from repro_torch.launch import steps
    from repro_torch.models import LM
    from repro_torch.models.transformer import param_specs

    marks = fsdp.data_marks(params, param_specs(cfg, params),
                            {"data": group.size, "model": 1}, True)
    model = LM(cfg, "cpu")
    model.shards = fsdp.Shards(marks, group)
    step, opt_init = steps.make_train_step(model, cfg, data_group=group)
    shards = fsdp.shard_data(params, marks, rank, group.size)
    step(shards, opt_init(shards), _rows(batch, rank, group.size))
    return group.calls, group.bytes
