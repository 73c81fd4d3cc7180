"""The static-batch server (``serve.BatchedServer``, ``run_static``) and the
serving CLI's ``--static/--batch/--max-len/--eos-id/--paged-attn`` held
against ``repro``'s: streams equal to ``repro``'s ``run_static`` and to the
port's continuous engine (``repro``'s ``tests/test_serving.py::
test_slot_reuse_token_exact_vs_static``: slot reuse under churn must not
corrupt a live request), a ragged final batch, the metrics keys, and
``--static``'s refusals with ``repro``'s messages.

float32 on a reduced packed ``ternary-paper`` (2 layers), so greedy
streams are equal, not near.
"""
import json

import numpy as np
import pytest

from repro.launch import serve as rserve
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.serving import ContinuousScheduler

from test_torch_model import _packed_pair

ARGS = ["--reduced", "--packed", "--ternary-min-dim", "64", "--requests",
        "5", "--prompt-len", "8", "--gen-lens", "2,5", "--device", "cpu"]


@pytest.fixture(scope="module")
def pair():
    return _packed_pair("float32", num_layers=2)


@pytest.mark.parametrize("requests,batch", [(6, 3), (7, 3)])
def test_run_static_matches_repro_and_the_engine(pair, requests, batch):
    """6 requests fill two batches of 3; 7 leave a ragged final batch of
    1, padded and trimmed. The continuous engine runs 2 slots with one
    long request pinned while short ones cycle through the other."""
    rcfg, rparams, pcfg, pparams = pair
    prompts, _, _ = serve.build_workload(pcfg, requests, 8, (2,), seed=1)
    gens = [12, 2, 2, 2, 2, 3, 4][:requests]
    max_len = 8 + 12 + 1
    rserver = rserve.BatchedServer(rcfg, max_len)
    rserver.load(rparams)
    routs, rmet = rserve.run_static(rserver, prompts, gens, batch)
    server = serve.BatchedServer(pcfg, max_len, "cpu")
    server.load(pparams)
    souts, smet = serve.run_static(server, prompts, gens, batch)
    engine = ContinuousScheduler(pcfg, max_slots=2, max_len=max_len,
                                 device="cpu")
    engine.load(pparams)
    couts, _ = serve.run_continuous(engine, prompts, gens)
    assert len(souts) == len(routs) == requests
    for r, s, c, g in zip(routs, souts, couts, gens):
        assert len(s) == g
        np.testing.assert_array_equal(s, r)
        np.testing.assert_array_equal(c, r)
    assert list(smet) == list(rmet)
    for key in ("engine", "batch", "submitted", "drained",
                "generated_tokens", "decode_steps"):
        assert smet[key] == rmet[key], key


def test_generate_pads_nothing_itself(pair):
    """generate() takes the rows it is given: a 2-row batch gives the two
    rows' tokens of a 3-row batch holding them."""
    _, _, pcfg, pparams = pair
    prompts, _, _ = serve.build_workload(pcfg, 3, 8, (2,), seed=2)
    server = serve.BatchedServer(pcfg, 16, "cpu")
    server.load(pparams)
    three = server.generate(prompts, 5)
    two = server.generate(prompts[:2], 5)
    assert three.shape == (3, 5) and three.dtype == np.int32
    np.testing.assert_array_equal(two, three[:2])


def test_cli_static_batch_and_max_len(capsys):
    metrics = serve.main(ARGS + ["--static", "--batch", "2",
                                 "--max-len", "24"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == metrics
    assert metrics["engine"] == "static" and metrics["batch"] == 2
    assert metrics["drained"] == metrics["submitted"] == 5
    assert metrics["decode_steps"] == sum(
        max(g) for g in np.array_split(
            serve.build_workload(get_config("ternary-paper", reduced=True),
                                 5, 8, (2, 5))[1], [2, 4]))


def test_cli_continuous_flags(capsys):
    """--max-len sizes the pool, --eos-id ends a request on that token
    (its stream then stops right after it), --paged-attn jax serves the
    paged cache through the gather row, every budget met."""
    dense = serve.main(ARGS + ["--max-len", "24"])
    assert dense["max_len"] == 24
    paged = serve.main(ARGS + ["--max-len", "24", "--cache", "paged",
                               "--page-size", "4", "--paged-attn", "jax"])
    assert paged["generated_tokens"] == dense["generated_tokens"]
    cfg = get_config("ternary-paper", reduced=True, ternary_min_dim=64)
    prompts, gens, _ = serve.build_workload(cfg, 5, 8, (2, 5))
    cfg, params = serve.build_params(cfg, 0, "cpu", True)
    engine = ContinuousScheduler(cfg, max_slots=4, max_len=24, device="cpu")
    engine.load(params)
    outs, _ = serve.run_continuous(engine, prompts, gens)
    eos = int(outs[0][0])
    stopped = serve.main(ARGS + ["--max-len", "24", "--eos-id", str(eos)])
    want = sum(len(o[:list(o).index(eos) + 1]) if eos in o else len(o)
               for o in outs)
    assert stopped["generated_tokens"] == want < dense["generated_tokens"]
    capsys.readouterr()


@pytest.mark.parametrize("extra", [["--chunked-prefill"],
                                   ["--traffic", "poisson"],
                                   ["--trace", "unused.json"]])
def test_cli_static_refusals_match_repro(extra):
    argv = ["--reduced", "--requests", "2", "--prompt-len", "8",
            "--gen-lens", "2", "--static"] + extra
    with pytest.raises(SystemExit) as want:
        rserve.main(argv)
    with pytest.raises(SystemExit) as got:
        serve.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "drop --static" in str(got.value)
