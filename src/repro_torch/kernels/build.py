"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, and load them with ``ctypes``.

Nothing here runs at import: a library is compiled the first time a kernel
wrapper asks for it (or when ``build()`` is called up front, as
``chip_smoke.py`` does), into ``kernels/_build/`` beside this file, a
directory ``.gitignore`` lists. A library's file name carries a hash of its
sources and flags, so an edited source rebuilds and an unchanged one is
reused. ``build()`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {"ternary_gemm": "ternary_gemm.cu",
           "ternary_gemm_skip": "ternary_gemm_skip.cu",
           "ternary_gemm_bitplane": "ternary_gemm_bitplane.cu",
           "fused_mlp": "fused_mlp.cu",
           "paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu"}
HEADERS = ("ternary_tiles.cuh", "tma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name],) + HEADERS:
        h.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that have no current
    library yet, in parallel. Returns seconds spent per name (0.0 when the
    library was already built). Raises ``RuntimeError`` with the compiler's
    output when a build fails. ``nvcc``'s register/shared-memory report is
    kept in ``_build/<name>.log``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(_lib_path(name)))
