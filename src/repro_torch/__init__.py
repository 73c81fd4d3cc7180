"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module names (``configs``, ``core``,
``kernels``, ``models``, ``serving``, ``obs``, ``data``, ``launch``,
``checkpoint``, ``optim``, ``distributed``) so each counterpart is easy to
find. It imports ``torch`` and numpy only: nothing of JAX and nothing of
``repro``.

So far the port serves the packed dense ``ternary-paper`` decoder over the
dense and the paged KV cache, runs the paper's sparse-GEMM surface
(``pack(w, "dense2bit" | "tiled" | "bitplane" | "base3")`` then
``ternary_gemm(x, wc)`` through the kernel registry), and trains the
decoder with ternary QAT under checkpoint/restart supervision
(``launch.train``), on hand-written CUDA kernels under ``kernels/csrc/``.
Entry points run on ``device="cuda"`` unless the caller asks for
``"cpu"``, where every kernel wrapper takes its plain PyTorch version
instead.

The top-level names below are those ``repro`` exports; they load lazily.
"""
import importlib

__all__ = ["TernaryWeight", "Dense2Bit", "Tiled", "Bitplane", "Base3", "pack",
           "ternary_gemm", "ternary_gemm_plan"]

_LAZY = {
    "TernaryWeight": "repro_torch.core.weights",
    "Dense2Bit": "repro_torch.core.weights",
    "Tiled": "repro_torch.core.weights",
    "Bitplane": "repro_torch.core.weights",
    "Base3": "repro_torch.core.weights",
    "pack": "repro_torch.core.weights",
    "ternary_gemm": "repro_torch.kernels.ops",
    "ternary_gemm_plan": "repro_torch.kernels.ops",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
