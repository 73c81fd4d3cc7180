"""The port stands alone: no module under ``src/repro_torch/``, not
``chip_smoke.py`` and not ``scripts/torch_kernel_ab.py`` imports ``jax``
or anything of ``repro``, itself or through a script of the repo it
imports by name; every module
imports on a machine without a GPU, nvcc or triton."""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "scripts" / "torch_kernel_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")
# where a top-level import can name a script of the repo, not a package
LOCAL_DIRS = (ROOT, ROOT / "scripts")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _forbidden_imports(path: pathlib.Path, dirs=LOCAL_DIRS, seen=None):
    """The forbidden roots ``path`` imports, itself or through a script of
    ``dirs`` that it imports by name (followed transitively)."""
    seen = set() if seen is None else seen
    seen.add(path)
    bad = set()
    for root in _imported_roots(path):
        if root in FORBIDDEN:
            bad.add(root)
        for d in dirs:
            local = d / f"{root}.py"
            if local.is_file() and local not in seen:
                bad |= _forbidden_imports(local, dirs, seen)
    return bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = sorted(_forbidden_imports(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_checks_cover_the_paging_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    assert {"paging/__init__.py", "paging/kernels.py", "paging/pages.py",
            "paging/prefix.py", "paging/quant.py"} <= names


def test_the_checks_cover_the_sparse_format_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    assert {"core/formats.py", "core/weights.py", "kernels/ref.py",
            "kernels/ternary_gemm_bitplane.py"} <= names


def test_the_checks_cover_the_training_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES
             if PORT in p.parents}
    assert {"core/quantize.py", "kernels/flash_attention.py",
            "optim/optimizers.py", "optim/schedules.py", "launch/steps.py",
            "launch/train.py", "checkpoint/checkpoint.py",
            "checkpoint/convert.py", "distributed/fault_tolerance.py",
            "obs/metrics.py", "data/pipeline.py"} <= names


def test_the_ast_check_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom repro.core import formats\n"
                 "import jax.numpy as jnp\nfrom repro_torch import core\n")
    assert sorted(set(_imported_roots(p)) & set(FORBIDDEN)) == ["jax",
                                                                "repro"]


def test_the_ast_check_follows_imports_of_local_scripts(tmp_path):
    (tmp_path / "helper.py").write_text("import sys\nfrom repro.obs "
                                        "import trace\n")
    (tmp_path / "relay.py").write_text("import helper\n")
    main = tmp_path / "main.py"
    main.write_text("import json\nimport relay\n")
    assert sorted(_forbidden_imports(main, dirs=(tmp_path,))) == ["repro"]
    # the file's own imports alone would pass
    assert not set(_imported_roots(main)) & set(FORBIDDEN)


def test_a_repo_script_that_reads_the_reference_is_caught():
    """scripts/trace_report.py reads traces through ``repro``: a file of
    the port that imported it would be caught."""
    assert "repro" in _forbidden_imports(ROOT / "scripts" /
                                         "trace_report.py")


@pytest.mark.parametrize("path", [p for p in FILES if PORT in p.parents],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_module_imports_without_a_gpu(path):
    rel = path.relative_to(ROOT / "src").with_suffix("")
    name = ".".join(p for p in rel.parts if p != "__init__")
    importlib.import_module(name)


def test_the_checks_cover_the_obs_and_graph_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES
             if PORT in p.parents}
    assert {"obs/__init__.py", "obs/clock.py", "obs/metrics.py",
            "obs/trace.py", "kernels/graphs.py",
            "serving/engine.py"} <= names


def test_the_checks_cover_the_scheduling_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES
             if PORT in p.parents}
    assert {"serving/sched/__init__.py", "serving/sched/config.py",
            "serving/sched/slo.py", "serving/sched/chunker.py",
            "serving/traffic.py", "serving/queue.py"} <= names


def test_the_checks_cover_the_spec_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES
             if PORT in p.parents}
    assert {"spec/__init__.py", "spec/draft.py", "spec/verify.py",
            "spec/rollback.py"} <= names


def test_the_checks_cover_the_fault_and_tcsc_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES
             if PORT in p.parents}
    assert {"serving/faults.py", "serving/engine.py", "paging/pages.py",
            "launch/serve.py", "core/formats.py", "core/quantize.py",
            "kernels/ref.py"} <= names


def test_the_checks_cover_the_tuner():
    names = {p.relative_to(PORT).as_posix() for p in FILES
             if PORT in p.parents}
    assert {"kernels/autotune.py", "kernels/__init__.py",
            "kernels/ops.py"} <= names


def test_the_checks_cover_the_distributed_trainer_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES
             if PORT in p.parents}
    assert {"distributed/compression.py", "distributed/sharding.py",
            "distributed/tp.py", "launch/train.py", "launch/steps.py",
            "data/pipeline.py", "optim/optimizers.py"} <= names
