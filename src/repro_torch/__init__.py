"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module names (``configs``, ``core``,
``kernels``, ``models``, ``serving``, ``obs``, ``data``, ``launch``,
``checkpoint``) so each counterpart is easy to find. It imports ``torch``
and numpy only: nothing of JAX and nothing of ``repro``.

So far the port serves the packed dense ``ternary-paper`` decoder through two
hand-written CUDA kernels (``kernels/csrc/ternary_gemm.cu`` and
``kernels/csrc/fused_mlp.cu``). Entry points run on ``device="cuda"``
unless the caller asks for ``"cpu"``, where every kernel wrapper takes its
plain PyTorch version instead.
"""
