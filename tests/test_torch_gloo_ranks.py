"""Run a function on n CPU ranks over gloo, one process a rank, for tests
of the port's collectives: ``run_ranks(n, fn, *args)`` starts n processes
(multiprocessing's spawn, so each imports this module — torch and numpy,
no JAX — and nothing of the calling test file), each joins a
``distributed.tp.Group`` through a ``FileStore`` in a fresh temporary
directory with a timeout, calls ``fn(group, rank, *args)`` with one
intra-op thread, and sends back its result; the results come back in
rank order. A rank that raises, or a run past ``timeout_s``, fails the
caller. The rank functions live here; the tests at the end hold the
runner itself."""
import multiprocessing as mp
import os
import shutil
import tempfile
import traceback

import numpy as np
import pytest
import torch

TIMEOUT_S = 120.0


def _rank_main(store, rank, n, fn, args, queue):
    torch.set_num_threads(1)
    try:
        from repro_torch.distributed import tp as tp_lib
        group = tp_lib.Group.join(store, rank, n, "gloo", TIMEOUT_S)
        queue.put((rank, True, fn(group, rank, *args)))
    except Exception:      # noqa: BLE001 — reported to the caller
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(n, fn, *args, timeout_s=TIMEOUT_S):
    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="torch_gloo_ranks_")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        os.path.join(workdir, "store"), r, n, fn, args, queue))
        for r in range(n)]
    try:
        for p in procs:
            p.start()
        out = {}
        for _ in range(n):
            rank, ok, res = queue.get(timeout=timeout_s)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{res}")
            out[rank] = res
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# rank functions (importable by the spawned processes)
# ---------------------------------------------------------------------------

def compressed_rank(group, rank, grads, errs, factor):
    """``compression.compressed_all_reduce`` of this rank's numpy leaves:
    (synced, new error, the group's data bytes) as numpy."""
    from repro_torch.distributed import compression
    g = {k: torch.tensor(v[rank]) for k, v in grads.items()}
    e = {k: torch.tensor(v[rank]) for k, v in errs.items()}
    synced, new_err = compression.compressed_all_reduce(g, e, group, factor)
    return ({k: v.float().numpy() for k, v in synced.items()},
            {k: v.numpy() for k, v in new_err.items()}, group.bytes)


def tp_rank_checks(group, rank, x, w_rows, w_cols, w, g, leaves, split,
                   device="cpu"):
    """This rank's side of three tensor-parallel checks, as numpy:

    * Megatron's f/g pair and the gather: x whole through f, its
      product with this rank's column block of ``w_cols`` gathered
      (``cols``), and its rank's column block of x times this rank's row
      block of ``w_rows`` summed by g (``rows``), under the loss
      sum(cols^2) + sum(sin(rows)): the forwards, x's gradient and the
      weight blocks' gradients, and g without a gradient (``rows_nograd``);
    * ``quantize.ste_ternarize_rows`` of this rank's row block of ``w``:
      the forward (``ste_y``) and the gradient under g's rows (``ste_g``);
    * ``optim.global_norm`` of this rank's slices of ``leaves`` (split
      leaves cut along their last axis, the rest whole): ``norm``.

    Every tensor lies on ``device`` (the ranks may share one card)."""
    from repro_torch.core import quantize
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.optim import global_norm

    def block(a, axis):
        return torch.from_numpy(np.ascontiguousarray(
            np.split(a, group.size, axis=axis)[rank])).to(device)

    def host(t):
        return t.detach().cpu().numpy()

    out = {}
    xt = torch.from_numpy(x).to(device).requires_grad_()
    wr = block(w_rows, 0).requires_grad_()
    wc = block(w_cols, 1).requires_grad_()
    k = x.shape[-1] // group.size
    xin = tp_lib.copy_to_group(xt, group)
    cols = tp_lib.gather_from_group(xin @ wc, group, -1)
    rows = tp_lib.reduce_from_group(xin[:, rank * k:(rank + 1) * k] @ wr,
                                    group)
    ((cols * cols).sum() + rows.sin().sum()).backward()
    out["cols"], out["rows"] = host(cols), host(rows)
    out["gx"], out["gwr"], out["gwc"] = (host(xt.grad), host(wr.grad),
                                         host(wc.grad))
    with torch.no_grad():
        out["rows_nograd"] = host(tp_lib.reduce_from_group(
            xt[:, rank * k:(rank + 1) * k] @ wr, group))

    wt = block(w, -2).requires_grad_()
    y = quantize.ste_ternarize_rows(wt, 0.7, group)
    (gw,) = torch.autograd.grad(y, [wt], block(g, -2))
    out["ste_y"], out["ste_g"] = host(y), host(gw)

    tree = [block(a, -1) if s else torch.from_numpy(a).to(device)
            for a, s in zip(leaves, split)]
    out["norm"] = float(global_norm(tree, list(split), group))
    return out


def _echo_rank(group, rank, base):
    """(rank, group size, the group's sum of rank + base)."""
    t = torch.tensor([float(rank + base)])
    return rank, group.size, float(group.all_reduce(t)[0])


def _fail_on_rank_one(group, rank):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def test_run_ranks_returns_each_rank_result_in_rank_order():
    got = run_ranks(3, _echo_rank, 10)
    assert got == [(r, 3, 33.0) for r in range(3)]


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(AssertionError, match="rank 1 failed(.|\n)*rank one"):
        run_ranks(2, _fail_on_rank_one, timeout_s=60)
