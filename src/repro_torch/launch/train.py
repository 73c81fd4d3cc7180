"""Training entry point of the port (``repro.launch.train``): synthetic data,
ternary QAT (the straight-through ternarization of every projection with
min dim >= ``ternary_min_dim``), AdamW with a warmup-cosine schedule and
global-norm clipping, periodic checkpoints in ``repro``'s format, and
restart from the newest intact checkpoint under ``TrainSupervisor``, with
the straggler watchdog.

On one device, or on a ``--data-parallel`` x ``--model-parallel`` mesh of
ranks, one process a rank (``DistTrainer``): the leader (rank 0, this
process) spawns ranks 1..n-1, each on ``cuda:r`` modulo the cards there
are (``launch.mesh.make_local_mesh``'s placement) or on the CPU, and
drives them with the leader/follower protocol of ``serving.engine``:
each init, restore, step and gather is a control message the followers
repeat. A rank takes its rows of the global batch (``SyntheticLM.
sharded_batch``); the gradients are averaged in f32 over its data group,
or, with ``--compress-grads``, cross it as ternary codes plus a scale
with error feedback (``make_compressed_dp_step``; ``repro``'s refusal:
it needs --data-parallel > 1 and --model-parallel 1); tensor-parallel
ranks (every family) hold Megatron-style shards (``distributed.tp``).
Where ``cfg.fsdp`` is set (``--set fsdp=true`` for a config without it)
and the data group has more than one rank, each rank keeps only its
slice of every parameter ``repro`` places on the data axes and of its
AdamW moments (``distributed.fsdp``): the model gathers a block's slices
as it runs it and the gradients are reduce-scattered into the slices, so
the update runs on the slices. ``--compress-grads`` keeps whole state,
as ``repro``'s shard_map trainer replicates it. Otherwise the update is
replicated, so the ranks of a data group hold the same bits.
Checkpoints stay in ``repro``'s layout: rank 0 gathers the shards (over
the data group, then the model group) before it saves, so a mesh's
checkpoint restores in one process and the reverse.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch ternary-paper \\
      --steps 200 --batch 8 --seq 512 --ckpt-dir CKPT
  ... --device cpu --reduced --set ternary_min_dim=64   # plain PyTorch path
  ... --device cpu --reduced --data-parallel 2 --model-parallel 2
  ... --device cpu --reduced --data-parallel 2 --compress-grads

The last line of standard output is ``repro``'s JSON summary: ``steps``
(run in this invocation), ``first_loss``, ``last_loss``, ``mean_step_s``
(host clock, first step excluded) and ``stragglers``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import shutil
import subprocess
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.checkpoint.convert import (opt_state_from_numpy,
                                            opt_state_to_numpy,
                                            params_from_numpy,
                                            params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import compression
from repro_torch.distributed import fsdp as fsdp_lib
from repro_torch.distributed import tp as tp_lib
from repro_torch.distributed.fault_tolerance import (StragglerWatchdog,
                                                     TrainSupervisor)
from repro_torch.launch import steps as steps_lib
from repro_torch.models import LM
from repro_torch.models.transformer import layer_period
from repro_torch.obs import clock as obs_clock
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine
from repro_torch.optim.optimizers import tree_leaves

log = logging.getLogger("repro_torch.train")

_FIELD_TYPES = {"int": int, "float": float, "str": str}


def build(cfg: ModelConfig, batch: int, seq: int, lr: float = 3e-4,
          total_steps: int = 1000, device="cuda"):
    """(model, data, train_step, init_state(seed) -> {"params", "opt"}) on
    ``device``, with ``repro``'s schedule: warmup over min(100, steps/10 +
    1) steps, cosine to a tenth of ``lr`` at ``total_steps``."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    data = SyntheticLM(cfg, batch, seq)
    lr_fn = warmup_cosine(lr, min(100, total_steps // 10 + 1), total_steps)
    train_step, opt_init = steps_lib.make_train_step(model, cfg, lr_fn)

    def init_state(seed: int) -> Dict[str, Any]:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        return {"params": params, "opt": opt_init(params)}

    return model, data, train_step, init_state


def make_supervisor(cfg: ModelConfig, *, batch: int, seq: int, lr: float,
                    steps: int, ckpt_dir: str, ckpt_every: int,
                    seed: int = 0, device="cuda", log_every: int = 10):
    """(TrainSupervisor, per-step host seconds): the training loop of
    ``main``, checkpointing ``{"params", "opt"}`` in ``repro``'s layout and
    restoring from it."""
    dev = resolve_device(device)
    _, data, train_step, init_state = build(cfg, batch, seq, lr, steps, dev)

    def to_checkpoint(state):
        return {"params": params_to_numpy(state["params"], cfg),
                "opt": opt_state_to_numpy(state["opt"], cfg)}

    def make_state(resume_step: Optional[int]):
        if resume_step is None:
            return 0, init_state(seed)
        step, flat = ckpt_lib.restore(ckpt_dir, resume_step)
        tree = ckpt_lib.unflatten(flat)
        log.info("restored step %d from %s", step, ckpt_dir)
        return step, {"params": params_from_numpy(tree["params"], cfg, dev),
                      "opt": opt_state_from_numpy(tree["opt"], cfg, dev)}

    t_hist = []

    def step_fn(step: int, state):
        t0 = obs_clock.now()
        batch_t = data.sharded_batch(step, device=dev)
        params, opt, metrics = train_step(state["params"], state["opt"],
                                          batch_t)
        metrics = {k: float(v) for k, v in metrics.items()}   # syncs
        dt = obs_clock.now() - t0
        t_hist.append(dt)
        if step % log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step, metrics["loss"], dt)
        return {"params": params, "opt": opt}, metrics

    sup = TrainSupervisor(ckpt_dir, make_state, step_fn,
                          ckpt_every=ckpt_every, watchdog=StragglerWatchdog(),
                          to_checkpoint=to_checkpoint)
    return sup, t_hist


# ---------------------------------------------------------------------------
# The distributed trainer
# ---------------------------------------------------------------------------

def make_compressed_dp_step(model: LM, cfg: ModelConfig, group, lr_fn,
                            threshold_factor: float = 0.7):
    """The pure data-parallel step with TernGrad-style gradient sync
    (``repro``'s ``make_compressed_dp_step``), as one rank of ``group``
    (a ``distributed.tp.Group``; None is one rank): local gradients of
    the rank's rows (no accumulation, as ``repro``'s), synced by
    ``compression.compressed_all_reduce`` with error feedback, clipped at
    global norm 1.0, ``lr_fn(step + 1)``, AdamW. Returns (step(params,
    opt_state, err, batch) -> (params, opt_state, err, metrics),
    opt_init); ``loss`` is the group's mean, the other metrics the
    rank's own. A leaf is ``repro``'s (the layers of one ``block{j}``
    ternarize together: ``compression.leaf_groups``)."""
    opt_init, opt_update = adamw(state_dtype=cfg.opt_state_dtype)
    period = layer_period(cfg)

    def step(params, opt_state, err, batch):
        metrics, grads = steps_lib.value_and_grad(model, cfg, params, batch,
                                                  accum=1)
        synced, err = compression.compressed_all_reduce(
            grads, err, group, threshold_factor, period)
        synced, gnorm = clip_by_global_norm(synced, 1.0)
        lr = lr_fn(opt_state["step"] + 1)
        params, opt_state = opt_update(synced, opt_state, params, lr)
        loss = metrics["loss"] if group is None \
            else steps_lib.mean_loss(metrics, group)
        return params, opt_state, err, dict(metrics, grad_norm=gnorm, lr=lr,
                                            loss=loss)

    return step, opt_init


def _backend(devices: Sequence[str]) -> str:
    return tp_lib.Mesh(("ranks",), (len(devices),), tuple(devices)).backend


def checksum(t: torch.Tensor) -> int:
    """A 64-bit checksum of a tensor's bits: each element's bits (as an
    integer) times an odd weight of its position, summed modulo 2^64, on
    the tensor's device. Equal tensors give equal sums; a changed bit
    changes it."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.element_size() == 4:
        bits = flat.view(torch.int32)
    elif flat.element_size() == 2:
        bits = flat.view(torch.int16)
    else:
        bits = flat.view(torch.int64) if flat.element_size() == 8 \
            else flat.to(torch.int64)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    chunk = 1 << 24
    for at in range(0, bits.numel(), chunk):
        part = bits[at:at + chunk].to(torch.int64)
        pos = torch.arange(at, at + part.numel(), dtype=torch.int64,
                           device=flat.device)
        total += (part * (pos * 2654435761 % 2147483647 * 2 + 1)).sum()
    return int(total)


class _Rank:
    """One rank of a ``DistTrainer``: its groups (``world`` over every
    rank, for control messages; ``data`` over the ranks of its model
    coordinate; ``model`` over the ranks of its data coordinate, its
    tensor-parallel group), and, after a ``build`` message, its model,
    shards, optimizer state and step."""

    def __init__(self, job: Dict[str, Any], rank: int):
        dp, tp = job["dp"], job["tp"]
        self.rank, self.dp, self.tp = rank, dp, tp
        self.d, self.m = divmod(rank, tp)
        devices = job["devices"]
        self.device = torch.device(devices[rank])
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.mesh = tp_lib.Mesh(("data", "model"), (dp, tp), tuple(devices),
                                timeout_s=job["timeout_s"])
        store, timeout = job["store"], job["timeout_s"]
        self.world = tp_lib.Group.join(f"{store}_world", rank, dp * tp,
                                       "gloo", timeout)
        data_devs = [devices[i * tp + self.m] for i in range(dp)]
        self.data = tp_lib.Group.join(
            f"{store}_data{self.m}", self.d, dp, _backend(data_devs),
            timeout) if dp > 1 else None
        model_devs = devices[self.d * tp:(self.d + 1) * tp]
        self.model_group = tp_lib.Group.join(
            f"{store}_model{self.d}", self.m, tp, _backend(model_devs),
            timeout) if tp > 1 else None
        self.params = self.opt = self.err = None
        self.shards: Optional[fsdp_lib.Shards] = None
        self.peak = self.step_peak = 0

    def groups(self) -> Dict[str, tp_lib.Group]:
        return {n: g for n, g in (("data", self.data),
                                  ("model", self.model_group))
                if g is not None}

    # -- messages ---------------------------------------------------------
    def run(self, msg: Dict[str, Any]):
        return getattr(self, "op_" + msg["op"])(**{
            k: v for k, v in msg.items() if k != "op"})

    def op_build(self, cfg, batch, seq, lr, total_steps, compress, timed):
        self.cfg, self.compress = cfg, compress
        # the old model's state goes, and with it its cached blocks (ranks
        # sharing a card would otherwise hold each other's memory); the
        # peak memory a report reads is this model's
        self.params = self.opt = self.err = None
        self.peak = self.step_peak = 0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        for g in self.groups().values():
            g.timed = timed
        dev = self.device
        self.full_model = LM(cfg, dev)
        self.model = LM(tp_lib.local_config(cfg, self.tp, self.m), dev)
        self.model.comm = self.model_group
        self.data_src = SyntheticLM(cfg, batch, seq)
        self.marks: Dict[tuple, str] = {}
        self.shards = None
        if self.tp > 1 or self.sharded(cfg, compress):
            shapes, _ = steps_lib.model_shardings(self.full_model, cfg,
                                                  self.mesh)
        if self.tp > 1:
            _, self.marks = tp_lib.strip_marks(tp_lib.shard_params(
                shapes, self.full_model.param_specs(), self.mesh,
                rank=self.m, cfg=cfg, latent=True))
        if self.sharded(cfg, compress):
            self.shards = fsdp_lib.Shards(fsdp_lib.data_marks(
                shapes, self.full_model.param_specs(), self.mesh, True),
                self.data)
        self.model.shards = self.shards
        lr_fn = warmup_cosine(lr, min(100, total_steps // 10 + 1),
                              total_steps)
        if compress:
            self.step_fn, self.opt_init = make_compressed_dp_step(
                self.model, cfg, self.data, lr_fn)
        else:
            self.step_fn, self.opt_init = steps_lib.make_train_step(
                self.model, cfg, lr_fn, data_group=self.data,
                marks=self.marks)
        self.params = self.opt = self.err = None

    def sharded(self, cfg, compress: bool) -> bool:
        """Whether this mesh splits the state over its data group: fsdp
        set, more than one data rank, and not the compressed trainer."""
        return cfg.fsdp and self.dp > 1 and not compress

    def _shard(self, tree):
        """The rank's slices of a whole tree shaped like the params: over
        the model group, then over the data group."""
        tree = tp_lib.shard_tree(tree, self.marks, self.m, self.tp)
        if self.shards is None:
            return tree
        return fsdp_lib.shard_data(tree, self.shards.marks, self.d, self.dp)

    def _gather(self, tree):
        """``_shard``'s inverse (every rank of the mesh takes part)."""
        if self.shards is not None:
            tree = fsdp_lib.gather_data(tree, self.shards.marks, self.data)
        return tp_lib.gather_tree(tree, self.marks, self.model_group)

    def op_init(self, seed):
        full = self.full_model.init(
            torch.Generator(device=self.device).manual_seed(seed))
        self.params = self._shard(full)
        del full
        self.opt = self.opt_init(self.params)
        self.err = compression.init_error_state(self.params) \
            if self.compress else None

    def op_restore(self, ckpt_dir, step):
        cfg, dev = self.cfg, self.device
        got, flat = ckpt_lib.restore(ckpt_dir, step)
        tree = ckpt_lib.unflatten(flat)
        del flat
        self.params = self._shard(params_from_numpy(tree["params"], cfg,
                                                    dev))
        opt = opt_state_from_numpy(tree["opt"], cfg, dev)
        self.opt = dict(opt, m=self._shard(opt["m"]),
                        v=self._shard(opt["v"]))
        self.err = None
        if self.compress:
            self.err = (params_from_numpy(tree["err"], cfg, dev)
                        if "err" in tree
                        else compression.init_error_state(self.params))
        return got

    def op_step(self, step):
        batch = self.data_src.sharded_batch(step, self.mesh, self.device,
                                            rank=self.rank)
        before = {n: (g.calls, g.bytes, g.seconds)
                  for n, g in self.groups().items()}
        if self.device.type == "cuda":
            # the step's own peak, kept apart from the build's
            self.peak = max(self.peak,
                            torch.cuda.max_memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.compress:
            self.params, self.opt, self.err, metrics = self.step_fn(
                self.params, self.opt, self.err, batch)
        else:
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch)
        out = {k: float(v) for k, v in metrics.items()}
        if self.device.type == "cuda":
            self.step_peak = max(self.step_peak,
                                 torch.cuda.max_memory_allocated(self.device))
        self.last_comm = {
            name: {"calls": g.calls - before[name][0],
                   "bytes": g.bytes - before[name][1],
                   "seconds": g.seconds - before[name][2]}
            for name, g in self.groups().items()}
        return out

    def op_eval(self, step):
        """The data group's mean loss of the current weights on ``step``'s
        batch (no gradient, no update)."""
        batch = self.data_src.sharded_batch(step, self.mesh, self.device,
                                            rank=self.rank)
        params = tp_lib.attach_marks(self.params, self.marks) \
            if self.marks else self.params
        with torch.no_grad():
            loss, _ = self.model.loss(params, batch)
        if self.data is not None:
            loss = steps_lib.mean_loss({"loss": loss}, self.data)
        return float(loss)

    def op_state(self, params_only=False):
        """The whole state from the ranks' shards, gathered over the data
        group and then the model group (every rank takes part): {"params",
        "opt"} (+ "err"), or {"params"}, on this rank's device."""
        state = {"params": self._gather(self.params)}
        if params_only:
            return state
        state["opt"] = dict(self.opt, m=self._gather(self.opt["m"]),
                            v=self._gather(self.opt["v"]))
        if self.err is not None:
            state["err"] = self.err
        return state

    def op_report(self, grads_step=None):
        """Every rank's (data, model) coordinates, per-leaf checksums of
        its params, m and v (gathered over the data group where the rank
        holds data shards), the bytes of its own params, m and v
        (``state_bytes``), its peak device memory since the build and in
        its largest step and, with ``grads_step``, checksums of the
        gradients of that step's rows (no update) with the leaves' split
        mask and each leaf's replicated K/V head (``heads``, None for the
        others), and (not compressed) of the data group's mean of them before
        the clip (``grads_synced``: gathered over the data group, each
        rank's slices over the model group); gathered on every rank."""
        def sums(tree):
            return [checksum(t) for t in tree_leaves(tree)]

        def data_whole(tree):
            return tree if self.shards is None else fsdp_lib.gather_data(
                tree, self.shards.marks, self.data)
        cuda = self.device.type == "cuda"
        rep = {"rank": self.rank, "d": self.d, "m": self.m,
               "peak_bytes": (max(self.peak, torch.cuda.max_memory_allocated(
                   self.device)) if cuda else None),
               "step_peak_bytes": self.step_peak if cuda else None,
               "state_bytes": fsdp_lib.state_bytes(self.params, self.opt),
               "sharded": self.shards is not None,
               "params": sums(data_whole(self.params)),
               "m_state": sums(data_whole(self.opt["m"])),
               "v_state": sums(data_whole(self.opt["v"])),
               "step": int(self.opt["step"])}
        if grads_step is not None:
            batch = self.data_src.sharded_batch(
                grads_step, self.mesh, self.device, rank=self.rank)
            _, grads = steps_lib.value_and_grad(self.model, self.cfg,
                                                self.params, batch,
                                                self.marks)
            rep["grads"] = sums(grads)
            rep["split"] = [bool(torch.as_tensor(x).any()) for x in
                            tree_leaves(tp_lib.split_mask(grads,
                                                          self.marks))]
            rep["heads"] = tree_leaves(tp_lib.head_replicas(
                grads, self.marks, self.m))
            if not self.compress:
                synced = grads if self.data is None \
                    else steps_lib.mean_all_reduce(
                        grads, self.data,
                        None if self.shards is None else self.shards.marks)
                rep["grads_synced"] = sums(data_whole(synced))
        return self.world.gather_objects(rep)


def _rank_main(job_path: str, rank: int) -> None:
    """A follower rank's process: join the groups, then repeat the
    leader's messages until it sends ``stop``."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job["threads"])
    me = _Rank(job, rank)
    while True:
        msg = me.world.recv()
        if msg["op"] == "stop":
            break
        me.run(msg)


class DistTrainer:
    """The leader of a ``data_parallel`` x ``model_parallel`` mesh of
    training ranks (module docstring). Rank r sits at (data, model) =
    divmod(r, model_parallel) on ``devices[r]`` (default: ``cuda:r``
    modulo the cards, or the CPU for ``device="cpu"``); NCCL where the
    ranks of a group have a card each, gloo otherwise. Every collective
    times out after ``timeout_s``. Call ``close()`` (or use it as a
    context manager) to stop the followers."""

    def __init__(self, cfg: ModelConfig, *, data_parallel: int,
                 model_parallel: int, batch: int, seq: int, lr: float,
                 total_steps: int, compress: bool = False, device="cuda",
                 devices: Optional[Sequence[str]] = None,
                 timeout_s: float = 600.0, timed: bool = False):
        dp, tp = data_parallel, model_parallel
        if compress and (dp <= 1 or tp > 1):
            raise SystemExit("--compress-grads needs a pure data-parallel "
                             "mesh: --data-parallel > 1 --model-parallel 1")
        if devices is None:
            dev = resolve_device(device)
            cards = torch.cuda.device_count() if dev.type == "cuda" else 0
            devices = [f"cuda:{r % cards}" if cards else "cpu"
                       for r in range(dp * tp)]
        if len(devices) != dp * tp:
            raise ValueError(f"mesh (data={dp}, model={tp}) needs "
                             f"{dp * tp} devices, got {len(devices)}")
        for d in devices:
            resolve_device(d)
        self.cfg, self.dp, self.tp = cfg, dp, tp
        self.compress = compress
        # CPU ranks run one intra-op thread each: n pools of a thread a
        # core spin on each other's cores (a step ~20x slower); the
        # leader's count comes back at close()
        self._threads = torch.get_num_threads()
        if any(str(d) == "cpu" for d in devices):
            torch.set_num_threads(1)
        self.workdir = tempfile.mkdtemp(prefix="repro_torch_train_")
        job = {"dp": dp, "tp": tp, "devices": [str(d) for d in devices],
               "store": os.path.join(self.workdir, "store"),
               "timeout_s": timeout_s, "threads": torch.get_num_threads()}
        job_path = os.path.join(self.workdir, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump(job, f)
        self.procs = tp_lib.spawn_ranks("repro_torch.launch.train",
                                        "_rank_main", job_path,
                                        range(1, dp * tp))
        self.me = None
        try:
            self.me = _Rank(job, 0)
            self.build(cfg, batch=batch, seq=seq, lr=lr,
                       total_steps=total_steps, timed=timed)
        except BaseException:
            self.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, op: str, **kw):
        msg = dict(kw, op=op)
        self.me.world.send(msg)
        return self.me.run(msg)

    def build(self, cfg: ModelConfig, *, batch: int, seq: int, lr: float,
              total_steps: int, timed: bool = False,
              compress: Optional[bool] = None) -> None:
        """(Re)build every rank's model, data and step for ``cfg`` (and
        ``compress``, default unchanged; the mesh and its processes
        stay); ``init`` or ``restore`` follows."""
        if compress is not None:
            if compress and (self.dp <= 1 or self.tp > 1):
                raise SystemExit("--compress-grads needs a pure "
                                 "data-parallel mesh")
            self.compress = compress
        self.cfg = cfg
        self._call("build", cfg=cfg, batch=batch, seq=seq, lr=lr,
                   total_steps=total_steps, compress=self.compress,
                   timed=timed)

    def init(self, seed: int) -> None:
        """Every rank draws the whole model from ``seed`` and keeps its
        shards; fresh AdamW (and error) state."""
        self._call("init", seed=seed)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Every rank reads the checkpoint of ``step`` (default: the
        newest) and keeps its shards; returns the step."""
        if step is None:
            step = ckpt_lib.latest_step(ckpt_dir)
        return self._call("restore", ckpt_dir=ckpt_dir, step=step)

    def step(self, step: int) -> Dict[str, float]:
        """One train step of every rank on its rows of ``step``'s batch;
        the leader's metrics (``loss`` the data group's mean)."""
        return self._call("step", step=step)

    def eval_loss(self, step: int) -> float:
        """The loss of the ranks' current weights on ``step``'s batch (a
        held-out step for an evaluation), averaged over the data group."""
        return self._call("eval", step=step)

    @property
    def last_comm(self) -> Dict[str, Dict[str, float]]:
        """The leader's collectives in the last step, by group (``data``:
        the gradient sync; ``model``: the tensor-parallel collectives):
        calls, bytes it put in, and host seconds when built ``timed``."""
        return self.me.last_comm

    def state(self, params_only: bool = False) -> Dict[str, Any]:
        """The whole training state on the leader's device, its shards
        gathered: {"params", "opt"} (+ "err", the leader's error state,
        with compression), or only {"params"}."""
        return self._call("state", params_only=params_only)

    def checkpoint_tree(self) -> Dict[str, Any]:
        """``state()`` in ``repro``'s checkpoint layout."""
        st = self.state()
        tree = {"params": params_to_numpy(st["params"], self.cfg),
                "opt": opt_state_to_numpy(st["opt"], self.cfg)}
        if "err" in st:
            tree["err"] = params_to_numpy(st["err"], self.cfg)
        return tree

    def report(self, grads_step: Optional[int] = None) -> List[Dict]:
        """Every rank's report (``_Rank.op_report``), in rank order."""
        return self._call("report", grads_step=grads_step)

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the followers (killing any that do not stop) and remove
        the work directory."""
        if self.me is not None:
            try:
                self.me.world.send({"op": "stop"})
            except Exception:          # a follower already gone
                pass
            self.me = None
        for p in self.procs:
            try:
                p.wait(timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(5.0)
        self.procs = []
        shutil.rmtree(self.workdir, ignore_errors=True)
        torch.set_num_threads(self._threads)


def check_replicas(reports: List[Dict]) -> Dict[str, int]:
    """Raise unless the ranks of every data group hold the same bits
    (equal checksums of every param, m and v leaf between ranks of one
    model coordinate; where the ranks hold data shards, of the state
    gathered over the data group, ``op_report``'s) and, where ``reports``
    carry gradients, unless the tensor-parallel ranks of a replica got the
    same gradients for every replicated (unsplit) leaf, and the ranks that
    hold one K/V head (``heads``) the same for its columns. Returns the
    counts compared."""
    steps = {r["step"] for r in reports}
    if len(steps) != 1:
        raise AssertionError(f"the ranks are at steps {sorted(steps)}")
    by_m: Dict[int, List[Dict]] = {}
    for r in reports:
        by_m.setdefault(r["m"], []).append(r)
    leaves = 0
    for group in by_m.values():
        for r in group[1:]:
            for key in ("params", "m_state", "v_state"):
                if r[key] != group[0][key]:
                    bad = [i for i, (a, b) in enumerate(zip(r[key],
                                                            group[0][key]))
                           if a != b]
                    raise AssertionError(
                        f"data-parallel ranks {group[0]['rank']} and "
                        f"{r['rank']} differ in {key} leaves {bad[:8]}")
                leaves += len(r[key])
    replicated = heads = 0
    if "grads" in reports[0]:
        by_d: Dict[int, List[Dict]] = {}
        for r in reports:
            by_d.setdefault(r["d"], []).append(r)
        for group in by_d.values():
            ref = group[0]
            for r in group[1:]:
                for i, split in enumerate(ref["split"]):
                    if split:
                        continue
                    replicated += 1
                    if r["grads"][i] != ref["grads"][i]:
                        raise AssertionError(
                            f"tensor-parallel ranks {ref['rank']} and "
                            f"{r['rank']} got other gradients for "
                            f"replicated leaf {i}")
            if "heads" in ref and len(ref["heads"]) != len(ref["grads"]):
                raise AssertionError(
                    f"{len(ref['heads'])} K/V head entries for "
                    f"{len(ref['grads'])} gradient leaves")
            for i, head in enumerate(ref.get("heads", ())):
                if head is None:
                    continue
                by_head: Dict[int, Dict] = {}
                for r in group:
                    first = by_head.setdefault(r["heads"][i], r)
                    if first is r:
                        continue
                    heads += 1
                    if r["grads"][i] != first["grads"][i]:
                        raise AssertionError(
                            f"tensor-parallel ranks {first['rank']} and "
                            f"{r['rank']} hold K/V head {r['heads'][i]} "
                            f"and got other gradients for its leaf {i}")
    return {"leaves_compared": leaves, "replicated_grads_compared":
            replicated, "head_grads_compared": heads}


def make_dist_supervisor(cfg: ModelConfig, *, data_parallel: int,
                         model_parallel: int, batch: int, seq: int,
                         lr: float, steps: int, ckpt_dir: str,
                         ckpt_every: int, seed: int = 0, device="cuda",
                         compress: bool = False, log_every: int = 10,
                         devices: Optional[Sequence[str]] = None,
                         timeout_s: float = 600.0, timed: bool = False,
                         trainer: Optional[DistTrainer] = None):
    """(TrainSupervisor, per-step host seconds, DistTrainer): ``main``'s
    loop on a mesh. The supervisor's state is the trainer's (it lives in
    the ranks): a fresh start or a restore is sent to every rank, so each
    restart brings them all back to the checkpoint's step; checkpoints
    hold the gathered state in ``repro``'s layout. An existing
    ``trainer`` of that mesh is rebuilt for ``cfg`` instead of spawning
    one. Close the trainer when done."""
    if trainer is None:
        trainer = DistTrainer(cfg, data_parallel=data_parallel,
                              model_parallel=model_parallel, batch=batch,
                              seq=seq, lr=lr, total_steps=steps,
                              compress=compress, device=device,
                              devices=devices, timeout_s=timeout_s,
                              timed=timed)
    else:
        trainer.build(cfg, batch=batch, seq=seq, lr=lr, total_steps=steps,
                      timed=timed)

    def make_state(resume_step: Optional[int]):
        if resume_step is None:
            trainer.init(seed)
            return 0, trainer
        step = trainer.restore(ckpt_dir, resume_step)
        log.info("restored step %d from %s on %d ranks", step, ckpt_dir,
                 data_parallel * model_parallel)
        return step, trainer

    t_hist: List[float] = []

    def step_fn(step: int, state):
        t0 = obs_clock.now()
        metrics = trainer.step(step)
        dt = obs_clock.now() - t0
        t_hist.append(dt)
        if step % log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step, metrics["loss"], dt)
        return state, metrics

    sup = TrainSupervisor(ckpt_dir, make_state, step_fn,
                          ckpt_every=ckpt_every, watchdog=StragglerWatchdog(),
                          to_checkpoint=lambda _: trainer.checkpoint_tree())
    return sup, t_hist, trainer


def _overrides(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        typ = ModelConfig.__dataclass_fields__[k].type
        out[k] = (v.lower() in ("1", "true")) if typ == "bool" \
            else _FIELD_TYPES[typ](v)
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ternary-paper")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="sync gradients as ternary codes + scales with "
                         "error feedback (TernGrad-style data-parallel "
                         "trainer; needs --data-parallel > 1 and "
                         "--model-parallel 1)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="a ModelConfig field override, k=v")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    dp, mp = args.data_parallel, args.model_parallel
    if args.compress_grads and (dp <= 1 or mp > 1):
        raise SystemExit("--compress-grads needs a pure data-parallel "
                         "mesh: --data-parallel > 1 --model-parallel 1")
    cfg = get_config(args.arch, reduced=args.reduced,
                     **_overrides(args.set))
    common = dict(batch=args.batch, seq=args.seq, lr=args.lr,
                  steps=args.steps, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, seed=args.seed,
                  device=args.device, log_every=args.log_every)
    if dp * mp > 1:
        sup, t_hist, trainer = make_dist_supervisor(
            cfg, data_parallel=dp, model_parallel=mp,
            compress=args.compress_grads, **common)
        try:
            _, history = sup.run(args.steps)
        finally:
            trainer.close()
    else:
        sup, t_hist = make_supervisor(cfg, **common)
        _, history = sup.run(args.steps)
    losses = [m["loss"] for _, m in history]
    summary = {
        "steps": len(history),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "mean_step_s": float(np.mean(t_hist[1:])) if len(t_hist) > 1
        else None,
        "stragglers": sup.watchdog.straggler_steps,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
