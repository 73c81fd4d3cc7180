"""The dry run's cost walker: FLOPs, device-memory bytes and collective
bytes of one eager call, counted op by op (the port's counterpart of
``repro.launch.hlo_cost``, whose name it keeps).

``repro`` lowers a step to XLA and walks the optimized HLO, because XLA's
own cost analysis counts a ``lax.scan`` body once and every layer of its
models is a scan. The port runs its layers as a Python loop, so there is
no trip count to recover: ``trace(fn, *args)`` runs the call under a
``TorchDispatchMode`` and charges every aten op it dispatches, every layer
included. On ``meta`` tensors nothing is allocated and nothing runs, so a
full-size step of any architecture traces on a CPU.

Cost rules, one per case:

* a matmul-like op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, under
  ``by_op["dot"]``) costs 2 · result elements · the contracted size; the
  other ops ``FlopCounterMode`` counts (``_scaled_dot_product_*``,
  ``convolution`` and their backwards) cost its count, which is the same
  product in their terms;
* elementwise ops cost their result's element count
  (``ELEMENTWISE_1FLOP``), transcendentals ``repro``'s weights a result
  element (``ELEMENTWISE_XFLOP``); reductions (``REDUCTIONS``, softmax
  weighted as its exponential, max, sum and division) their operand's
  element count;
* bytes: in eager PyTorch every op is a launch boundary, so each op
  charges its operands' and its result's bytes (``repro`` charges them at
  XLA's fusion boundaries, ROADMAP C19);
* views cost nothing (``view``, ``reshape``, ``expand``, ``permute``,
  ``slice``, ``as_strided``, ``t``, ``transpose``: every op whose schema
  returns an alias of an input, and ``_unsafe_view``, a view that says
  otherwise), and nor do allocations (``ALLOCATIONS``:
  ``empty*`` and ``zeros`` as allocations only); fills (``FILLS``) charge
  the bytes they write;
* ``embedding``, ``index_select``, ``gather`` and indexing by tensors
  charge the rows they move, twice (read and write), not the table
  (``repro``'s ``test_gather_bytes_not_full_table`` rule);
* in-place writes into a region (``index_put_``, ``copy_`` into a slice,
  ``scatter``, ``index_add``: ``REGION_WRITES``) charge the written
  region twice, not the tensor written into;
* collectives are charged by the group that runs them
  (``note_collective``; ``launch.dryrun``'s recording group) by
  ``repro``'s ring rule: an all-reduce 2 × its operand, an all-gather its
  result, a reduce-scatter its operand, into ``collective_bytes``, and their operand and result bytes
  into ``bytes``.

Two readings come out of one trace. ``plain`` charges every op, the
plain PyTorch path (``repro``'s default). ``kernel`` charges each eager
``ternary_gemm`` / ``fused_mlp`` dispatch on a kernel row by its plan
(``GemmPlan.roofline()`` / ``FusedMlpPlan.roofline()``: packed bytes and
the plan's FLOPs) in place of the ops its lowering runs — ``repro``'s
``kernel_dequant`` flag, hooked where ``ops.kernel_probe`` hooks
(``ops.dispatch_hook``). A dispatch that dispatches others (the
``"chain"`` row) is charged by them; a ``ref`` row keeps its ops, which
are what the card runs.

The trace also keeps the bytes of storage live at each op: the call's
arguments, then each storage an op creates until it dies (a finalizer on
the storage; views share their base's), and the most of them at once:
``peak_bytes`` the card's, where a kernel dispatch holds its output and
not its plain version's temporaries (its own workspace, such as B4's
partial sums, is not counted), ``plain_peak_bytes`` with them.
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Costs", "Trace", "trace", "analyze", "flop_counter",
           "matmul_flops", "note_collective", "leaf_tensors",
           "ELEMENTWISE_1FLOP", "ELEMENTWISE_XFLOP", "COLLECTIVES",
           "REDUCTIONS", "ALLOCATIONS", "FILLS", "GATHERS", "REGION_WRITES",
           "MATMULS"]

MATMULS = {"mm", "bmm", "addmm", "baddbmm"}
ELEMENTWISE_1FLOP = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_not", "__and__", "__or__",
    "__xor__", "__lshift__", "__rshift__", "bitwise_left_shift",
    "bitwise_right_shift", "floor", "ceil", "round", "trunc", "sign",
    "clamp", "clamp_min", "clamp_max", "remainder", "fmod", "relu",
    "reciprocal", "square", "threshold_backward", "lerp", "addcmul",
    "addcdiv",
}
ELEMENTWISE_XFLOP = {
    "exp": 4, "log": 4, "rsqrt": 2, "sqrt": 2, "tanh": 6, "sigmoid": 6,
    "pow": 6, "cos": 6, "sin": 6, "expm1": 4, "log1p": 4, "atan2": 8,
    "erf": 6, "silu": 7, "silu_backward": 8, "sigmoid_backward": 2,
    "tanh_backward": 2, "softplus": 8, "gelu": 8, "exp2": 4,
}
# per operand element; softmax: its exponential (4), max, sum, division
REDUCTIONS = {
    "sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1,
    "argmax": 1, "argmin": 1, "prod": 1, "any": 1, "all": 1, "var": 2,
    "var_mean": 2, "norm": 2, "linalg_vector_norm": 2, "logsumexp": 6,
    "cumsum": 1, "sort": 1, "topk": 1, "_softmax": 7, "_log_softmax": 7,
    "_softmax_backward_data": 3, "_log_softmax_backward_data": 3,
    "count_nonzero": 1,
}
COLLECTIVES = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"}
ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "zeros", "zeros_like", "new_zeros"}
FILLS = {"full", "full_like", "new_full", "ones", "ones_like", "new_ones",
         "fill", "zero", "arange", "scalar_tensor", "rand", "randn",
         "rand_like", "randn_like", "randint", "normal", "uniform",
         "bernoulli"}
GATHERS = {"embedding", "index_select", "gather", "index"}
REGION_WRITES = {"index_put", "_index_put_impl", "copy", "scatter",
                 "scatter_add", "scatter_reduce", "index_add", "index_copy",
                 "index_fill", "masked_scatter", "slice_scatter",
                 "select_scatter"}
# bookkeeping ops with no device work
_FREE = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "set",
         "resize", "record_stream", "_unsafe_view", "_reshape_alias"}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # per-op [flops, bytes]
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def bump(self, opcode: str, flops: float, byt: float):
        e = self.by_op.setdefault(opcode, [0.0, 0.0])
        e[0] += flops
        e[1] += byt

    def add(self, other: "Costs", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) \
                + v * mult
        for k, (fl, by) in other.by_op.items():
            e = self.by_op.setdefault(k, [0.0, 0.0])
            e[0] += fl * mult
            e[1] += by * mult

    def total_collective(self) -> float:
        return sum(self.collective_bytes.values())

    def top_bytes(self, n: int = 12) -> List[Tuple[str, float, float]]:
        rows = [(k, v[1], v[0]) for k, v in self.by_op.items()]
        rows.sort(key=lambda r: -r[1])
        return rows[:n]

    def charge(self, opcode: str, flops: float, byt: float):
        self.flops += flops
        self.bytes += byt
        self.bump(opcode, flops, byt)


def matmul_flops(costs: Costs) -> float:
    """The FLOPs of the matmul-like class (what ``FlopCounterMode``
    counts)."""
    from torch.utils.flop_counter import flop_registry
    names = {"dot"} | {p.__name__ for p in flop_registry
                       if hasattr(p, "__name__")}
    return sum(v[0] for k, v in costs.by_op.items() if k in names)


@dataclasses.dataclass
class Trace:
    """One call's readings: ``plain`` and ``kernel`` (module docstring),
    ``flop_counter`` (the call's FLOPs by ``FlopCounterMode``'s formulas,
    ``flop_counter``), ``plain_peak_bytes`` (the peak with the plain
    versions' temporaries inside kernel dispatches),
    the arguments' bytes, the most bytes of storage live at once
    (``peak_bytes``, arguments included), the result's bytes and the part
    of them that are arguments' storage (``alias_bytes``: in-place
    writes), and the call's result."""

    plain: Costs
    kernel: Costs
    flop_counter: float
    argument_bytes: int
    peak_bytes: int
    plain_peak_bytes: int
    output_bytes: int
    alias_bytes: int
    result: Any = None


def leaf_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, lists, tuples and ternary-weight
    containers (their tensor fields)."""
    out: List[torch.Tensor] = []
    _collect(tree, out)
    return out


def _collect(x, out: List[torch.Tensor]) -> None:
    # a module function, not a closure: a recursive closure is a
    # reference cycle, which would keep every tensor it saw until the
    # garbage collector ran
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _collect(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _collect(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _collect(getattr(x, f.name), out)


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _base_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _contracted(name: str, args) -> int:
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return a.shape[-1]


class _Storages:
    """Bytes of storage live: the arguments', then each new storage's until
    its finalizer runs. A storage made inside a kernel row's dispatch (the
    plain version's temporaries: decoded weights and the like) counts
    toward the plain path's bytes only, unless it is the dispatch's
    output (``promote``), which the kernel allocates too."""

    def __init__(self, args):
        self.live: Dict[int, Tuple[int, bool]] = {}
        for t in leaf_tensors(args):
            st = t.untyped_storage()
            self.live[st._cdata] = (st.nbytes(), True)
        self.args = {k: n for k, (n, _) in self.live.items()}
        self.cur = self.peak = sum(self.args.values())
        self.cur_plain = self.peak_plain = self.cur

    def _free(self, key: int):
        hit = self.live.pop(key, None)
        if hit is not None:
            n, kernel = hit
            self.cur_plain -= n
            if kernel:
                self.cur -= n

    def note(self, out, inner: bool = False):
        for t in leaf_tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = (n, not inner)
            self.cur_plain += n
            self.peak_plain = max(self.peak_plain, self.cur_plain)
            if not inner:
                self.cur += n
                self.peak = max(self.peak, self.cur)
            weakref.finalize(st, self._free, key)

    def promote(self, out):
        """Count ``out``'s storages on the card's side too."""
        for t in leaf_tensors(out):
            key = t.untyped_storage()._cdata
            hit = self.live.get(key)
            if hit is not None and not hit[1]:
                self.live[key] = (hit[0], True)
                self.cur += hit[0]
                self.peak = max(self.peak, self.cur)


class _Frame:
    def __init__(self, plan):
        self.plan = plan
        self.inner = Costs()
        self.children = False
        # a kernel row: its lowering's ops are the plain version's
        self.kernel_row = plan.impl not in ("ref", "chain")


class _Walker(TorchDispatchMode):
    """The dispatch mode: charges each op (module docstring) and keeps the
    storages' bytes. On ``meta`` tensors an op's output shapes are
    memoized by (op, argument shapes, strides, dtypes and scalars): the
    port's layers repeat the same ops, and a meta kernel costs far more
    host time than a lookup."""

    def __init__(self, storages: _Storages):
        super().__init__()
        self.plain, self.kernel = Costs(), Costs()
        self.frames: List[_Frame] = []
        self.storages = storages
        self.flop_counter = 0.0
        self._memo: Dict[tuple, Any] = {}

    # -- charging ------------------------------------------------------
    def _kernel_target(self) -> Costs:
        return self.frames[-1].inner if self.frames else self.kernel

    def charge(self, key: str, flops: float, byt: float):
        self.plain.charge(key, flops, byt)
        self._kernel_target().charge(key, flops, byt)

    def collective(self, kind: str, link_bytes: float, hbm_bytes: float):
        for c in (self.plain, self._kernel_target()):
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) \
                + link_bytes
            c.charge(kind, 0.0, hbm_bytes)

    # -- dispatches (ops.dispatch_hook) ----------------------------------
    def enter(self, plan):
        if self.frames:
            self.frames[-1].children = True
        self.frames.append(_Frame(plan))

    def exit(self):
        fr = self.frames.pop()
        target = self._kernel_target()
        if fr.children or fr.plan.impl in ("ref", "chain"):
            target.add(fr.inner)
            return
        r = fr.plan.roofline()
        name = (f"fused_mlp[{fr.plan.impl}]" if hasattr(fr.plan, "ff")
                else f"ternary_gemm[{fr.plan.format}/{fr.plan.impl}]")
        target.charge(name, float(r["flops"]), float(r["bytes"]))

    # -- ops -----------------------------------------------------------
    def _run(self, func, kind, writes, args, kwargs):
        """``func``'s output, from the memo where every tensor argument is
        ``meta`` and the op makes fresh outputs."""
        if kind in ("view", "free") or writes:
            return func(*args, **kwargs)
        key = _memo_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        hit = self._memo.get(key)
        if hit is not None:
            return _rebuild(hit)
        out = func(*args, **kwargs)
        spec = _out_spec(out)
        if spec is not None:
            self._memo[key] = spec
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, kind, writes = _op_info(func)
        out = self._run(func, kind, writes, args, kwargs)
        if kind in ("view", "free"):
            return out
        self.storages.note(out, bool(self.frames)
                           and self.frames[-1].kernel_row)
        if kind == "alloc":
            return out
        ins: List[torch.Tensor] = []
        _flat(args, ins)
        if kwargs:
            _flat(tuple(kwargs.values()), ins)
        outs: List[torch.Tensor] = []
        _flat(out, outs)
        in_b = float(sum(t.numel() * t.element_size()
                         for t in {id(t): t for t in ins}.values()))
        out_b = float(sum(t.numel() * t.element_size() for t in outs))
        if kind == "dot":
            flops = 2.0 * float(outs[0].numel()) * _contracted(name, args)
            self.flop_counter += flops
            self.charge("dot", flops, in_b + out_b)
        elif kind == "registry":
            flops = float(_flop_registry()[func.overloadpacket](
                *args, **kwargs, out_val=out))
            self.flop_counter += flops
            self.charge(name, flops, in_b + out_b)
        elif kind == "gather":
            self.charge(name, 0.0, 2.0 * out_b)
        elif kind == "region":
            self.charge(name, 0.0, 2.0 * _region_bytes(name, args, outs))
        elif kind == "fill":
            self.charge(name, 0.0, out_b)
        else:
            res_e = float(sum(t.numel() for t in outs))
            if kind == "ew":
                flops = res_e * ELEMENTWISE_XFLOP.get(name, 1)
            elif kind == "reduce":
                flops = float(ins[0].numel() if ins else 0) \
                    * REDUCTIONS[name]
            else:
                flops = 0.0
            self.charge(name, flops, in_b + out_b)
        return out


@functools.cache
def _op_info(func) -> Tuple[str, str, bool]:
    """(base name, cost class, whether it writes its input in place) of
    an aten overload; an in-place op is charged by its class and never
    memoized."""
    name = _base_name(func)
    writes = any(r.alias_info is not None and r.alias_info.is_write
                 for r in func._schema.returns)
    if name in _FREE:
        kind = "free"
    elif _is_view(func):
        kind = "view"
    elif name in ALLOCATIONS:
        kind = "alloc"
    elif name in MATMULS:
        kind = "dot"
    elif func.overloadpacket in _flop_registry():
        kind = "registry"
    elif name in GATHERS:
        kind = "gather"
    elif name in REGION_WRITES:
        kind = "region"
    elif name in FILLS:
        kind = "fill"
    elif name in ELEMENTWISE_1FLOP or name in ELEMENTWISE_XFLOP:
        kind = "ew"
    elif name in REDUCTIONS:
        kind = "reduce"
    else:
        kind = "other"
    return name, kind, writes


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _flat(x, out: List[torch.Tensor]) -> None:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)


def _key_of(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _NoKey
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return ("seq",) + tuple(_key_of(y) for y in x)
    if isinstance(x, _SCALARS):
        return (type(x), x)        # 2 and 2.0 make other dtypes
    raise _NoKey


class _NoKey(Exception):
    pass


def _memo_key(func, args, kwargs) -> Optional[tuple]:
    try:
        return (func, _key_of(args),
                _key_of(tuple(sorted(kwargs.items()))) if kwargs else ())
    except _NoKey:
        return None


def _out_spec(out):
    """What ``_rebuild`` needs of a ``meta`` output (None: not kept)."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype) if out.is_meta else None
    if isinstance(out, (tuple, list)) and out and all(
            isinstance(t, torch.Tensor) and t.is_meta for t in out):
        return (type(out),) + tuple((t.shape, t.stride(), t.dtype)
                                    for t in out)
    return None


def _rebuild(spec):
    if isinstance(spec[0], type):
        return spec[0](torch.empty_strided(s, st, dtype=d, device="meta")
                       for s, st, d in spec[1:])
    s, st, d = spec
    return torch.empty_strided(s, st, dtype=d, device="meta")


def _region_bytes(name: str, args, outs) -> float:
    """The bytes a region write writes: ``copy_``'s destination (a view:
    its region), ``index_put``'s values, a scatter's or an index add's
    source (or its index, for a scalar value)."""
    if name == "copy":
        return _nbytes(args[0])
    if name in ("index_put", "_index_put_impl", "masked_scatter",
                "slice_scatter", "select_scatter"):
        src = args[2] if name in ("index_put", "_index_put_impl") \
            else args[1]
        return _nbytes(src)
    tensors = [a for a in args[2:] if isinstance(a, torch.Tensor)]
    src = tensors[-1] if tensors else outs[0]
    if src.dim() == 0 and len(tensors) > 0:
        src = tensors[0]
    return float(src.numel() * outs[0].element_size())


@functools.cache
def _flop_registry():
    """``FlopCounterMode``'s formulas for the ops it counts, less the
    matmuls the walker counts itself (the same product)."""
    from torch.utils.flop_counter import flop_registry
    return {k: v for k, v in flop_registry.items()
            if getattr(k, "__name__", "") not in MATMULS}


# the walker of the trace running in this context
_ACTIVE: contextvars.ContextVar[Optional[_Walker]] = contextvars.ContextVar(
    "repro_torch_hlo_cost_walker", default=None)


def note_collective(kind: str, operand: torch.Tensor,
                    result: torch.Tensor) -> None:
    """Charge one collective to the trace running, by ``repro``'s ring
    rule (module docstring): a group calls it for each all-reduce
    (``kind="all-reduce"``), all-gather or reduce-scatter it runs. No
    trace: nothing."""
    if kind not in COLLECTIVES:
        raise ValueError(f"kind must be one of {sorted(COLLECTIVES)}")
    walker = _ACTIVE.get()
    if walker is None:
        return
    if kind == "all-reduce":
        link = 2.0 * _nbytes(operand)
    elif kind == "all-gather":
        link = _nbytes(result)
    else:
        link = _nbytes(operand)
    walker.collective(kind, link, _nbytes(operand) + _nbytes(result))


def trace(fn: Callable, *args, **kw) -> Trace:
    """Run ``fn(*args, **kw)`` once under the walker and
    ``ops.dispatch_hook``: both readings, the flop counter's count and
    the storage bytes (``Trace``)."""
    from repro_torch.kernels import ops
    storages = _Storages((args, kw))
    walker = _Walker(storages)

    class _Hook:
        def __init__(self, plan):
            self.plan = plan

        def __enter__(self):
            walker.enter(self.plan)
            return storages.promote

        def __exit__(self, *exc):
            walker.exit()
            return False

    token = _ACTIVE.set(walker)
    try:
        with walker, ops.dispatch_hook(_Hook):
            result = fn(*args, **kw)
    finally:
        _ACTIVE.reset(token)
    out_keys: Dict[int, int] = {}
    for t in leaf_tensors(result):
        st = t.untyped_storage()
        out_keys[st._cdata] = st.nbytes()
    alias = sum(n for k, n in out_keys.items() if k in storages.args)
    return Trace(plain=walker.plain, kernel=walker.kernel,
                 flop_counter=walker.flop_counter,
                 argument_bytes=sum(storages.args.values()),
                 peak_bytes=storages.peak,
                 plain_peak_bytes=storages.peak_plain,
                 output_bytes=sum(out_keys.values()), alias_bytes=alias,
                 result=result)


def analyze(fn: Callable, *args, kernel_dequant: bool = False,
            **kw) -> Costs:
    """The costs of ``fn(*args, **kw)``: the plain reading, or with
    ``kernel_dequant`` each kernel dispatch charged by its plan (module
    docstring)."""
    t = trace(fn, *args, **kw)
    return t.kernel if kernel_dequant else t.plain


def flop_counter(fn: Callable, *args, **kw) -> float:
    """``FlopCounterMode``'s total over ``fn(*args, **kw)``: the library's
    own count, as ``xla_cost`` reads XLA's for ``repro``. A ``Trace``'s
    ``flop_counter`` sums the same per-op formulas (its registry) over the
    ops the walker sees, without a second mode on every op."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kw)
    return float(counter.get_total_flops())
