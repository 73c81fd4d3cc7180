"""The port's hillclimb driver (``scripts/torch_hillclimb.py``): one dry-run
cell cut to two layers (``--set num_layers=2``) on the production mesh
writes ``experiments/perf_torch/<arch>_<shape>_<tag>.json`` with the keys
of ``scripts/hillclimb.py``'s record (read from that script's source), its
``useful_ratio`` from ``dryrun.model_flops``; ``--kernel-model`` on a
``ternary_packed`` decode cell charges fewer bytes than the plain reading
(the 2-bit words in place of decoded weights); ``--autotune-gemm`` records
the tuner's picks for the arch's four projection shapes; a cell the
config does not support exits with its reason."""
import ast
import json
import sys
from pathlib import Path

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import autotune
from repro_torch.launch import dryrun

from torch_cpu_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
try:
    import torch_hillclimb
finally:
    sys.path.pop(0)

CELL = ["--arch", "granite-3-8b", "--shape", "decode_32k",
        "--set", "num_layers=2"]


def repro_record_keys():
    """The keys ``scripts/hillclimb.py`` writes: its ``rec = {...}``
    literal and every ``rec["..."] = ...`` after it."""
    tree = ast.parse((ROOT / "scripts" / "hillclimb.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id == "rec" \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(tgt, ast.Subscript) and isinstance(
                    tgt.value, ast.Name) and tgt.value.id == "rec":
                keys.add(tgt.slice.value)
    return keys


def _run(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rec = torch_hillclimb.main(argv)
    tag = argv[argv.index("--tag") + 1]
    path = tmp_path / "experiments" / "perf_torch" / \
        f"granite-3-8b_decode_32k_{tag}.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    return rec


def test_a_cell_writes_repros_record(tmp_path, monkeypatch):
    keys = repro_record_keys()
    assert {"t_compute_s", "hbm_gb", "compile_s", "autotune_gemm",
            "kernel_model", "top_bytes_by_op"} <= keys
    rec = _run(CELL + ["--tag", "base", "--top", "5"], tmp_path,
               monkeypatch)
    assert set(rec) == keys
    assert rec["overrides"] == {"num_layers": "2"}
    assert rec["kernel_model"] is False and rec["autotune_gemm"] is None
    assert len(rec["top_bytes_by_op"]) == 5
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["hbm_gb"] > 0 and rec["flops_per_chip"] > 0
    cfg = get_config("granite-3-8b", num_layers=2)
    mf = dryrun.model_flops(cfg, SHAPES["decode_32k"])
    assert rec["useful_ratio"] == pytest.approx(
        mf / 256 / rec["flops_per_chip"], rel=1e-12)
    assert rec["t_compute_s"] == pytest.approx(
        rec["flops_per_chip"] / dryrun.PEAK_FLOPS, rel=1e-12)
    assert rec["t_memory_s"] == pytest.approx(
        rec["bytes_per_chip"] / dryrun.HBM_BW, rel=1e-12)


def test_the_kernel_model_charges_the_packed_words(tmp_path, monkeypatch):
    packed = CELL + ["--set", "quantization=ternary_packed"]
    plain = _run(packed + ["--tag", "plain"], tmp_path, monkeypatch)
    kern = _run(packed + ["--tag", "kern", "--kernel-model"], tmp_path,
                monkeypatch)
    assert kern["kernel_model"] is True
    assert 0 < kern["bytes_per_chip"] < plain["bytes_per_chip"]
    ops = {row[0] for row in kern["top_bytes_by_op"]}
    assert any(op.startswith("ternary_gemm[") for op in ops)
    assert kern["t_collective_s"] == plain["t_collective_s"] > 0


def test_autotune_gemm_records_four_picks(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    monkeypatch.setattr(autotune, "_GLOBAL", None)
    rec = _run(CELL + ["--tag", "tuned", "--autotune-gemm"], tmp_path,
               monkeypatch)
    cfg = get_config("granite-3-8b")
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    picks = rec["autotune_gemm"]
    assert set(picks) == {f"{d}x{ff}", f"{ff}x{d}", f"{d}x{d}", f"{d}x{v}"}
    tuner = autotune.get_tuner()
    for key, tile in picks.items():
        k, n = (int(x) for x in key.split("x"))
        assert tile == tuner.lookup(128, k, n, sparsity=0.25).as_list()
    assert (tmp_path / "tune.json").is_file()


def test_an_unsupported_cell_exits_with_its_reason(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="quadratic"):
        torch_hillclimb.main(["--arch", "granite-3-8b", "--shape",
                              "long_500k", "--tag", "t"])
    assert not (tmp_path / "experiments").exists()
