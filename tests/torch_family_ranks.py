"""Rank functions for the tensor-parallel family tests, run on CPU ranks
over gloo by ``test_torch_gloo_ranks.run_ranks`` (each spawned process
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
    model = LM(tp_lib.local_config(cfg, group.size), "cpu")
    model.comm = group
    with torch.no_grad(), moe.recorded_routes() as log:
        _, logits = model.prefill(shards, {"tokens": torch.as_tensor(
            tokens)}, tokens.shape[1] + 1)
    return [t.numpy() for t in log], _host(logits.float())
