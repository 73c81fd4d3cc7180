"""The serving side of the port's MoE, SSM and hybrid families, held
against ``repro`` on the same weights (``test_torch_families._pair``:
reduced widths, 2 layers, packed):

* the continuous engine's streams against ``repro``'s: mamba2 and mixtral
  over the dense cache, jamba and mamba2 over the paged pool, and jamba
  under page pressure (preempt and replay rebuild the SSM rows by
  prefill), with equal decode steps, preemptions and deferrals; every
  cache row is written in place (the captured decode step's static
  buffers);
* SSM rows inside the paged pool: the copy on write leaves them alone,
  ``nbytes`` counts them;
* the refusals, with ``repro``'s messages;
* ``serve --arch`` on a family config, and its ``--packed`` warning.

Token streams and counters: exact.
"""
import json

import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.launch import serve as rserve
from repro.serving import ContinuousScheduler as RScheduler
from repro.serving import SchedConfig as RSchedConfig
from repro.spec import SpecConfig as RSpecConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.paging import PagePool
from repro_torch.paging.pages import tree_nbytes
from repro_torch.serving import ContinuousScheduler, SchedConfig
from repro_torch.spec import SpecConfig

from test_torch_families import _pair, _tokens


def _pool_ptrs(eng):
    return [t.data_ptr() for layer in eng.pool.layers
            for t in layer.values() if isinstance(t, torch.Tensor)]


ENGINE_CASES = {
    "mamba2_dense": ("mamba2-130m", {}),
    "mixtral_dense": ("mixtral-8x22b", {}),
    "jamba_paged": ("jamba-v0.1-52b", dict(cache="paged", page_size=8)),
    "mamba2_paged": ("mamba2-130m", dict(cache="paged", page_size=8)),
    "jamba_paged_pressure": ("jamba-v0.1-52b",
                             dict(cache="paged", page_size=8, n_pages=7)),
}
# the pressure case's budgets outgrow 6 usable pages with two slots live
GENS = {"jamba_paged_pressure": [14, 12, 3, 2, 5]}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_streams_equal_repros(case):
    arch, kw = ENGINE_CASES[case]
    rcfg, rparams, pcfg, pparams = _pair(arch, packed=True)
    prompts = _tokens(rcfg, b=5, s=16, seed=4)
    gens = GENS.get(case, [9, 2, 3, 2, 5])
    reng = RScheduler(rcfg, max_slots=2, max_len=32, **kw)
    reng.load(rparams)
    routs, rm = rserve.run_continuous(reng, prompts, gens)
    peng = ContinuousScheduler(pcfg, max_slots=2, max_len=32, device="cpu",
                               **kw)
    peng.load(pparams)
    ptrs = _pool_ptrs(peng)
    pouts, pm = serve.run_continuous(peng, prompts, gens)
    for i, (a, b) in enumerate(zip(routs, pouts)):
        np.testing.assert_array_equal(b, a, err_msg=f"{case} request {i}")
    assert pm["decode_steps"] == rm["decode_steps"]
    for key in ("preemptions", "deferrals"):
        assert pm["cache"].get(key) == rm["cache"].get(key), key
    if case == "jamba_paged_pressure":
        assert pm["cache"]["preemptions"] > 0
    assert _pool_ptrs(peng) == ptrs          # the rows are written in place


def test_paged_pool_keeps_ssm_rows():
    """SSM layers hold (slots, ...) rows beside the page tensors: the copy
    on write leaves them alone and nbytes counts them."""
    _, _, pcfg, _ = _pair("jamba-v0.1-52b")
    model = LM(pcfg, "cpu")
    pool = PagePool(model, 3, 24, page_size=8)
    kinds = [k for k, _ in model.kinds]
    ssm_rows = [pool.layers[i] for i, k in enumerate(kinds) if k == "ssm"]
    assert ssm_rows and set(ssm_rows[0]) == {"state", "conv"}
    assert ssm_rows[0]["state"].shape[0] == 3
    for row in ssm_rows:
        for t in row.values():
            t.normal_()
    before = [{k: t.clone() for k, t in row.items()} for row in ssm_rows]
    pool._copy_page(1, 2)
    for row, old in zip(ssm_rows, before):
        assert all(torch.equal(row[k], old[k]) for k in row)
    assert pool.nbytes == tree_nbytes(pool.layers) + pool.table.nbytes
    assert tree_nbytes(ssm_rows) > 0


def test_refusals_match_repros():
    """The engine refuses encoder-decoder and VLM configs (the static
    server and the LM take them), and chunked prefill and speculative
    decoding on a stack with SSM layers, with repro's messages."""
    def msg(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    for arch in ("seamless-m4t-large-v2", "internvl2-76b"):
        rcfg = rget_config(arch, reduced=True)
        pcfg = get_config(arch, reduced=True)
        assert msg(lambda: ContinuousScheduler(
            pcfg, max_slots=1, max_len=16, device="cpu")) == msg(
            lambda: RScheduler(rcfg, max_slots=1, max_len=16))
        assert LM(pcfg, "cpu").cfg is pcfg
    for arch in ("mamba2-130m", "jamba-v0.1-52b"):
        rcfg = rget_config(arch, reduced=True)
        pcfg = get_config(arch, reduced=True)
        for rkw, pkw in (
                (dict(sched=RSchedConfig(chunk_tokens=8)),
                 dict(sched=SchedConfig(chunk_tokens=8))),
                (dict(spec=RSpecConfig(k=2)), dict(spec=SpecConfig(k=2)))):
            want = msg(lambda: RScheduler(rcfg, max_slots=1, max_len=16,
                                          **rkw))
            assert "SSM" in want
            assert msg(lambda: ContinuousScheduler(
                pcfg, max_slots=1, max_len=16, device="cpu", **pkw)) == want


def test_serve_cli_serves_a_family_config(capsys):
    m = serve.main(["--device", "cpu", "--arch", "mamba2-130m", "--reduced",
                    "--requests", "3", "--slots", "2", "--prompt-len", "8",
                    "--gen-lens", "2,4", "--cache", "paged",
                    "--page-size", "8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["drained"] == m["drained"] == 3
    serve.main(["--device", "cpu", "--arch", "mixtral-8x22b", "--reduced",
                "--packed", "--requests", "2", "--slots", "2",
                "--prompt-len", "8", "--gen-lens", "2"])
    assert "--packed converted nothing" in capsys.readouterr().err
