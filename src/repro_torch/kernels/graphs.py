"""Launch counts that stay true under CUDA-graph replay, and the capture of
one step into a graph.

Each kernel wrapper adds one to its counter (``fn.launches``, B3's
``launches_db``) where it launches its kernel from Python. A captured graph
launches the same kernels again on every replay without running the
wrappers, so ``CapturedStep`` notes what the wrappers counted while the
step was captured, leaves the warm-up and the capture itself out of the
counts, and adds the noted launches on every replay.

An engine captures several steps (the decode step and one chunked-prefill
window a width); they share one memory pool (``pool``, from
``torch.cuda.graph_pool_handle()``). That is safe only because the graphs
never run concurrently and an output of one graph is read before any other
graph of the pool replays: a graph captured later may place its
temporaries in memory that holds an earlier graph's outputs, and the
reverse. An output kept across another replay must be cloned first.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

__all__ = ["launch_counters", "read_launches", "CapturedStep",
           "cuda_graph_capture"]

# eager calls before the capture: the first one runs every first-call setup
# (builds, kernel attributes, cached limits, cuBLAS workspaces), the second
# one runs on what the first left behind
WARMUP_STEPS = 2


def launch_counters() -> Dict[str, Tuple[Callable, str]]:
    """Kernel name -> (wrapper, attribute holding its launch count)."""
    # imported here: the paging package imports the models, which import
    # the kernels
    from repro_torch.kernels import flash_attention as flash_lib
    from repro_torch.kernels import fused_mlp as fused_lib
    from repro_torch.kernels import ternary_gemm as gemm_lib
    from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib
    from repro_torch.paging import kernels as paged_lib
    return {"ternary_gemm": (gemm_lib.ternary_gemm_cuda, "launches"),
            "flash_attention": (flash_lib.flash_attention_cuda, "launches"),
            "fused_mlp": (fused_lib.fused_mlp_cuda, "launches"),
            "paged_decode_attention": (
                paged_lib.paged_decode_attention_cuda, "launches"),
            "ternary_gemm_skip": (gemm_lib.ternary_gemm_skip_cuda,
                                  "launches"),
            "ternary_gemm_skip_db": (gemm_lib.ternary_gemm_skip_cuda,
                                     "launches_db"),
            "ternary_gemm_bitplane": (
                bitplane_lib.ternary_gemm_bitplane_cuda, "launches")}


def read_launches() -> Dict[str, int]:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def _add_launches(delta: Dict[str, int]) -> None:
    for name, (fn, attr) in launch_counters().items():
        setattr(fn, attr, getattr(fn, attr) + delta[name])


def cuda_graph_capture(step: Callable[[], None],
                       pool=None) -> Callable[[], None]:
    """Run ``step`` ``WARMUP_STEPS`` times eagerly on a side stream, then
    capture one more call into a CUDA graph whose outputs come from the
    memory pool ``pool`` (a fresh private one when None). Returns the
    graph's ``replay``, which launches on the caller's current stream.
    ``step`` is called last for the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        step()
    return graph.replay


class CapturedStep:
    """``step`` captured once by ``capture`` (``cuda_graph_capture`` unless
    a test gives a stand-in that calls ``step`` and returns a replay);
    ``replay()`` runs it and counts the launches the captured call made."""

    def __init__(self, step: Callable[[], None],
                 capture: Callable = cuda_graph_capture):
        before = read_launches()
        per_call = []

        def counted():
            start = read_launches()
            step()
            end = read_launches()
            per_call.append({k: end[k] - start[k] for k in end})

        self._replay = capture(counted)
        # the last call is the captured one; the warm-up and the capture
        # stay out of the counts
        self.launches_per_replay = per_call[-1]
        _add_launches({k: before[k] - v for k, v in read_launches().items()})

    def replay(self) -> None:
        self._replay()
        _add_launches(self.launches_per_replay)
