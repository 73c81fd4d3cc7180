"""Idle rank processes started ahead (``tp.keep_spares``) on the CPU: a
tensor-parallel engine's follower and a training rank taken from them
serve and train as freshly started ranks do, each one taken is started
anew, and ``keep_spares(0)`` leaves none running."""
import pytest

from repro_torch.configs import get_config
from repro_torch.distributed import tp as tp_lib

from test_torch_dist_train import SEED, KW, _trainer
from test_torch_model import _packed_pair
from test_torch_tp import LOGIT_TOL, _mesh, _serve_port, _streams, _workload
from torch_cpu_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def spare():
    tp_lib.keep_spares(1)
    try:
        yield tp_lib._SPARES[0]
    finally:
        tp_lib.keep_spares(0)


def _taken(spare):
    """The spare ran a job to its end (an idle one is killed: a negative
    code) and another waits in its place."""
    assert spare.poll() == 0
    assert len(tp_lib._SPARES) == 1 and tp_lib._SPARES[0] is not spare


def test_engine_follower_from_a_spare(spare):
    _, _, pcfg, pparams = _packed_pair("bfloat16", num_layers=2)
    prompts, gens = _workload(pcfg.vocab_size)
    one, first1, _ = _serve_port(pcfg, pparams, prompts, gens)
    two, first2, metrics = _serve_port(pcfg, pparams, prompts, gens,
                                       mesh=_mesh())
    _taken(spare)
    assert metrics["mesh"]["tp"] == 2 and [len(t) for t in two] == gens
    scale = float(first1.abs().max())
    assert float((first2 - first1).abs().max()) <= LOGIT_TOL * scale
    _streams(pcfg, pparams, prompts, one, two)


def test_training_rank_from_a_spare(spare):
    cfg = get_config("ternary-paper", reduced=True, **KW)
    got = []
    for _ in range(2):          # from the spare, then a fresh Python
        tr = _trainer(cfg, 1, 2)
        try:
            tr.init(SEED)
            got.append(tr.step(0))
        finally:
            tr.close()
        if not got[1:]:
            _taken(spare)
            tp_lib.keep_spares(0)
    assert got[0] == got[1]


def test_keep_spares_zero_ends_them():
    tp_lib.keep_spares(2)
    procs = list(tp_lib._SPARES)
    assert len(procs) == 2
    tp_lib.keep_spares(0)
    assert tp_lib._SPARES == [] and all(p.poll() is not None
                                        for p in procs)
