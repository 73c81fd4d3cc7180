"""Ternary gradient compression against ``repro``: ``ternarize_gradient``
leaf by leaf, and ``compressed_all_reduce`` over 2 and 4 CPU ranks (gloo,
one process a rank, ``test_torch_gloo_ranks``) against ``compressed_psum``
under ``jax.vmap(..., axis_name="data")`` over the same stacked per-rank
gradients and error states, built from numpy (no forced devices and no
``shard_map``).

Tolerances: the codes are equal except where |g + err| lies within f32
rounding of Δ (Δ is a mean over the whole leaf that XLA and torch sum in
different orders); those elements are counted and must be under 1 in
10^4. Scales, synced values and error states within 1e-5 relative of
their magnitude off those elements. Every rank gets the same bits, and
the codes cross the wire as bf16 (2 bytes an element)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as rcomp

from repro_torch.distributed import compression

from torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_gloo_ranks import compressed_rank, run_ranks

SHAPES = {"w": (48, 40), "b": (40,), "table": (33, 16), "s": ()}
TIE_ULPS = 4
MAX_TIE_SHARE = 1e-4


def _leaves(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((n,) + s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _ties(gf, delta):
    """Where |g + err| lies within TIE_ULPS f32 ulps of Δ."""
    return np.abs(np.abs(gf) - delta) <= TIE_ULPS * np.spacing(
        np.float32(np.abs(delta)))


@pytest.mark.parametrize("factor", [0.7, 0.5])
@pytest.mark.parametrize("key", list(SHAPES))
def test_ternarize_gradient_matches_repro(key, factor):
    g = np.array(_leaves(1, 1)[key][0])
    e = np.array(_leaves(1, 2, 0.1)[key][0])
    rt, rs, re = rcomp.ternarize_gradient(jnp.asarray(g), jnp.asarray(e),
                                          factor)
    pt, ps, pe = compression.ternarize_gradient(torch.from_numpy(g),
                                                torch.from_numpy(e), factor)
    assert pt.dtype == torch.bfloat16 and rt.dtype == jnp.bfloat16
    gf = g + e
    ties = _ties(gf, factor * np.abs(gf).mean())
    codes_r = np.asarray(rt, np.float32)
    codes_p = pt.float().numpy()
    assert np.all((codes_r == codes_p) | ties)
    np.testing.assert_allclose(float(ps), float(rs), rtol=1e-5)
    off = ~ties
    np.testing.assert_allclose(pe.numpy()[off], np.asarray(re)[off],
                               rtol=1e-5, atol=1e-5 * np.abs(gf).max())


def test_init_error_state_matches_repro():
    params = {"w": torch.ones(3, 2), "i": torch.zeros(4, dtype=torch.int32),
              "h": torch.ones(5, dtype=torch.bfloat16)}
    ref = rcomp.init_error_state({"w": jnp.ones((3, 2)),
                                  "i": jnp.zeros(4, jnp.int32),
                                  "h": jnp.ones(5, jnp.bfloat16)})
    got = compression.init_error_state(params)
    for k in params:
        assert tuple(got[k].shape) == ref[k].shape
        assert got[k].dtype == torch.float32 and ref[k].dtype == jnp.float32
        assert not got[k].any()


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def reduced(request):
    """n ranks' compressed_all_reduce and repro's vmapped compressed_psum
    on the same stacked leaves."""
    n = request.param
    grads, errs = _leaves(n, 10 + n), _leaves(n, 20 + n, 0.05)
    got = run_ranks(n, compressed_rank, grads, errs, 0.7)
    ref_s, ref_e = jax.vmap(
        lambda g, e: rcomp.compressed_psum(g, e, "data", 0.7),
        axis_name="data")(jax.tree.map(jnp.asarray, grads),
                          jax.tree.map(jnp.asarray, errs))
    return n, grads, errs, got, ref_s, ref_e


def test_compressed_all_reduce_matches_compressed_psum(reduced):
    n, grads, errs, got, ref_s, ref_e = reduced
    ties_total = size_total = 0
    for key in SHAPES:
        gf = grads[key] + errs[key]                    # (n, ...)
        axes = tuple(range(1, gf.ndim))
        delta = 0.7 * np.abs(gf).mean(axis=axes, keepdims=True) \
            if axes else 0.7 * np.abs(gf)
        ties = _ties(gf, delta)
        # the codes each rank sent: from its own ternarization
        codes = np.stack([compression.ternarize_gradient(
            torch.tensor(grads[key][r]), torch.tensor(errs[key][r])
        )[0].float().numpy() for r in range(n)])
        rcodes = np.stack([np.asarray(rcomp.ternarize_gradient(
            jnp.asarray(grads[key][r]), jnp.asarray(errs[key][r]))[0],
            np.float32) for r in range(n)])
        assert np.all((codes == rcodes) | ties)
        ties_total += int((codes != rcodes).sum())
        size_total += codes.size
        any_tie = ties.any(axis=0)
        want = np.asarray(ref_s[key], np.float32)       # (n, ...) equal rows
        scale = max(float(np.abs(want).max()), 1e-30)
        for r in range(n):
            synced, new_err, _ = got[r]
            # every rank the same bits
            np.testing.assert_array_equal(synced[key], got[0][0][key])
            np.testing.assert_allclose(
                synced[key][~any_tie], want[r][~any_tie], rtol=1e-5,
                atol=1e-5 * scale)
            np.testing.assert_allclose(
                new_err[key][~ties[r]],
                np.asarray(ref_e[key][r])[~ties[r]], rtol=1e-5,
                atol=1e-5 * float(np.abs(gf).max()))
    assert ties_total <= MAX_TIE_SHARE * size_total


def test_codes_cross_the_wire_as_bf16(reduced):
    n, grads, _, got, _, _ = reduced
    params = {k: torch.tensor(v[0]) for k, v in grads.items()}
    wire = compression.wire_bytes(params, True)
    numel = sum(v[0].size for v in grads.values())
    assert wire == 2 * numel + 4 * len(grads)
    assert compression.wire_bytes(params, False) == 4 * numel
    # one bf16 all-reduce of every code and one f32 of the scales a rank
    assert all(b == wire for _, _, b in got)


def test_a_sum_of_codes_is_exact_in_bf16():
    """n ranks' codes summed in bf16 are the integers: up to 256 ranks."""
    for n in (2, 4, 64, 256):
        t = torch.ones(8, dtype=torch.bfloat16)
        acc = torch.zeros(8, dtype=torch.bfloat16)
        for _ in range(n):
            acc = acc + t
        assert float(acc[0]) == n


def test_one_rank_is_the_local_ternarization():
    g = {k: torch.tensor(v[0]) for k, v in _leaves(1, 3).items()}
    e = compression.init_error_state(g)
    synced, err = compression.compressed_all_reduce(g, e, None)
    for k in g:
        t, s, ne = compression.ternarize_gradient(g[k], e[k])
        assert torch.equal(synced[k], (t.float() * s).to(g[k].dtype))
        assert torch.equal(err[k], ne)
