"""The port's serving entry points on the CPU: the engine drains mixed
workloads, the CLI serves a reduced packed model, and every entry point
that defaults to the card raises when no card is present (and the caller
did not ask for the CPU)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.paging import PagePool
from repro_torch.serving import ContinuousScheduler, RequestQueue, SlotPool


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")


def _engine(slots=3, max_len=32, num_layers=2):
    cfg = get_config("ternary-paper", reduced=True, num_layers=num_layers,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, seed=0, device="cpu", packed=True)
    assert cfg.quantization == "ternary_packed"
    eng = ContinuousScheduler(cfg, max_slots=slots, max_len=max_len,
                              device="cpu")
    eng.load(params)
    return eng


def test_engine_drains_mixed_workload():
    eng = _engine()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 512, size=(8, 12)).astype(np.int32)
    gens = [int(g) for g in rng.integers(1, 9, size=8)]
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    m = eng.run()
    assert m["submitted"] == m["drained"] == 8
    assert m["generated_tokens"] == sum(gens)
    assert [len(r.tokens) for r in reqs] == gens
    assert all(r.state == "done" and r.slot is None for r in reqs)
    assert m["decode_steps"] < m["generated_tokens"]
    assert eng.pool.all_free


def test_engine_rejects_oversized_requests():
    eng = _engine(max_len=16)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(10, np.int32), 7)
    with pytest.raises(ValueError):
        RequestQueue().submit(np.zeros(0, np.int32), 1)


def test_slot_pool_free_list_is_lifo():
    model = LM(get_config("ternary-paper", reduced=True, num_layers=1),
               "cpu")
    pool = SlotPool(model, 3, 8)
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (0, 1) and pool.n_free == 1
    pool.free(a)
    assert pool.alloc() == a
    with pytest.raises(ValueError):
        pool.free(2)


def test_serve_cli_on_cpu(capsys):
    m = serve.main(["--device", "cpu", "--reduced", "--packed",
                    "--ternary-min-dim", "64", "--requests", "5",
                    "--slots", "2", "--prompt-len", "8",
                    "--gen-lens", "2,5"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["drained"] == m["drained"] == 5
    assert out["engine"] == "continuous"


def test_only_ternary_paper_is_registered():
    """Since the families slice the registry holds repro's eleven configs
    (tests/test_torch_configs.py holds them against repro's); a name it
    does not hold still raises."""
    assert get_config("ternary_paper").name == "ternary-paper"
    assert get_config("mamba2_130m").name == "mamba2-130m"
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("entry", ["resolve_device", "LM", "engine",
                                   "serve", "bridge", "paged_engine",
                                   "page_pool", "paged_serve"])
def test_default_device_entry_points_raise_without_gpu(no_cuda, entry):
    cfg = get_config("ternary-paper", reduced=True, num_layers=1)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "LM": lambda: LM(cfg),
        "engine": lambda: ContinuousScheduler(cfg, max_slots=1, max_len=8),
        "serve": lambda: serve.main(["--reduced", "--requests", "1"]),
        "bridge": lambda: params_from_numpy({}, cfg),
        "paged_engine": lambda: ContinuousScheduler(cfg, max_slots=1,
                                                    max_len=8, cache="paged"),
        "page_pool": lambda: PagePool(LM(cfg), 1, 8),
        "paged_serve": lambda: serve.main(["--reduced", "--requests", "1",
                                           "--cache", "paged"]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
