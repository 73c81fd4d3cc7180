"""The port's trace reader (``scripts/torch_trace_report.py``) against
``repro``'s (``scripts/trace_report.py``): on a traced serving run of a
reduced packed ``ternary-paper`` through the port's engine and the same
run through ``repro``'s, the two readers give the same report (``report``,
``main --json`` and the text form) on each trace, and ``main`` returns 0.
On a trace that ``validate_events`` rejects, or a file that is no trace,
the port's ``main`` returns nonzero."""
import json
import sys
from pathlib import Path

import pytest

from torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_obs import _traced_runs

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
try:
    import torch_trace_report
    import trace_report
finally:
    sys.path.pop(0)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    runs = _traced_runs("dense", tmp_path_factory.mktemp("traces"))
    return {name: str(path) for name, (_, _, path) in runs.items()}


@pytest.mark.parametrize("engine", ["port", "repro"])
def test_the_port_reader_reports_as_repros(traces, engine, capsys):
    path = traces[engine]
    rep = torch_trace_report.report(path)
    assert rep == trace_report.report(path)
    assert rep["step_breakdown"]["decode_step"]["n"] > 0
    assert rep["ttft_waterfall"] and rep["measured_vs_modeled"]
    for argv in ([path, "--json"], [path, "--top", "3"]):
        assert torch_trace_report.main(argv) == 0
        got = capsys.readouterr().out
        assert trace_report.main(argv) == 0
        assert got == capsys.readouterr().out
    torch_trace_report.main([path, "--json"])
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(rep))


@pytest.mark.parametrize("fault", ["negative_duration", "not_a_trace"])
def test_main_fails_on_a_rejected_trace(traces, tmp_path, fault, capsys):
    doc = json.loads(Path(traces["port"]).read_text())
    if fault == "negative_duration":
        span = next(e for e in doc["traceEvents"] if e["ph"] == "X")
        span["dur"] = -1
    else:
        doc = {"events": doc["traceEvents"]}
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert torch_trace_report.main([str(bad), "--json"]) != 0
    assert str(bad) in capsys.readouterr().err
