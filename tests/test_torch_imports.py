"""The port stands alone: no module under ``src/repro_torch/``, not
``chip_smoke.py``, not the port's examples (``examples_torch/``) and not
its scripts (``scripts/torch_*.py``) imports ``jax`` or anything of
``repro``, itself or through a script of the repo it imports by name;
``chip_smoke.py`` names no script that does (run as a child process or
loaded by path); every module imports on a machine without a GPU, nvcc or
triton."""
import ast
import importlib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py")) + EXAMPLES)
# where a script named in code (a string ending in ".py") may lie: the
# repository's root, and each of these when the file names it too
SCRIPT_DIRS = ("scripts", "examples_torch", "examples")
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


def test_the_checks_cover_the_dryrun_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES
             if PORT in p.parents}
    assert {"launch/dryrun.py", "launch/hlo_cost.py", "launch/mesh.py",
            "launch/steps.py", "launch/__init__.py"} <= names


def test_the_checks_cover_the_entry_points():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "scripts/torch_kernel_ab.py",
            "scripts/torch_trace_report.py", "scripts/torch_hillclimb.py",
            "examples_torch/quickstart.py",
            "examples_torch/quantize_and_pack.py",
            "examples_torch/train_ternary_lm.py",
            "examples_torch/serve_batched.py"} <= names


def _docstrings(tree):
    return {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


def _named_scripts(path: pathlib.Path, root: pathlib.Path = ROOT):
    """{name: the repository's files it may mean} for every script that
    ``path``'s code names (a string constant ending in ".py", docstrings
    aside): ``name`` under the root, or under a directory of SCRIPT_DIRS
    that the code names too (``ROOT / "scripts" / "x.py"``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    skip = _docstrings(tree)
    consts = {n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)
              and id(n) not in skip}
    dirs = [root] + [root / d for d in SCRIPT_DIRS if d in consts]
    return {name: [d / name for d in dirs if (d / name).is_file()]
            for name in consts
            if name.endswith(".py") and len(name) > 3 and "/" not in name}


def _child_modules(path: pathlib.Path):
    """The forbidden roots among the string arguments of ``path``'s child
    processes (``subprocess.*`` and ``os.system`` / ``exec*`` /
    ``spawn*`` calls): a ``-m repro...`` module or ``-c`` code that
    imports one."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        owner = getattr(getattr(f, "value", None), "id", "")
        attr = getattr(f, "attr", "")
        if not ((owner == "subprocess" and attr in (
                "run", "Popen", "call", "check_call", "check_output"))
                or (owner == "os" and (attr == "system" or attr.startswith(
                    ("exec", "spawn"))))):
            continue
        for arg in ast.walk(node):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                for word in re.findall(r"[A-Za-z_][\w.]*", arg.value):
                    if word.split(".")[0] in FORBIDDEN:
                        bad.add(word.split(".")[0])
    return bad


def _reference_scripts(path: pathlib.Path, root: pathlib.Path = ROOT):
    return sorted(str(f.relative_to(root))
                  for files in _named_scripts(path, root).values()
                  for f in files if _forbidden_imports(f))


def test_chip_smoke_runs_no_script_that_reads_the_reference():
    """No child process of chip_smoke.py and no script it loads imports
    ``repro`` or ``jax``: it names the port's trace reader and itself, and
    no script of the reference."""
    path = ROOT / "chip_smoke.py"
    named = _named_scripts(path)
    assert "torch_trace_report.py" in named
    assert "trace_report.py" not in named
    assert _reference_scripts(path) == []
    assert _child_modules(path) == set()


@pytest.mark.parametrize("code", [
    "import subprocess, sys\nfrom pathlib import Path\nROOT = Path('.')\n"
    "subprocess.run([sys.executable, str(ROOT / 'scripts' / "
    "'trace_report.py'), 'run.json', '--json'])\n",
    "import subprocess, sys\n"
    "subprocess.run([sys.executable, '-m', 'repro.launch.serve'])\n",
    "import os\nos.system('python -c \"import jax\"')\n"])
def test_the_child_process_check_catches_a_reference_script(tmp_path, code):
    """The form chip_smoke.py's trace check took before it read traces
    with the port's reader, a reference module run with ``-m`` and ``-c``
    code importing ``jax``."""
    p = tmp_path / "smoke.py"
    p.write_text(code)
    assert (_reference_scripts(p) == ["scripts/trace_report.py"]
            or _child_modules(p))
