"""The encoder-decoder (``seamless-m4t-large-v2``) and VLM
(``internvl2-76b``) families in the port, held against ``repro`` on the
same weights (``repro``'s init with every bias and norm parameter drawn at
random, so the biases in the packed containers count, carried over
through numpy by ``params_from_numpy``), at reduced widths, 2 decoder
layers (and 2 encoder layers), in float32:

* ``SyntheticLM`` batches (tokens, targets and the frontend rows)
  byte-equal to ``repro``'s;
* ``params_to_numpy`` inverts ``params_from_numpy`` exactly, latent and
  packed (``enc_block``, ``enc_norm``, ``cross``, ``norm_cross``), and a
  packed tree survives a checkpoint bitwise;
* forward, loss, prefill and three decode steps' logits equal to
  ``repro``'s: latent, QAT and packed (both packages on the plain ``ref``
  GEMM row), and the encoder under ``attn_impl="pallas"`` (B6's plain
  version, ``causal=False``) against ``repro``'s Pallas kernel in
  interpret mode;
* decode matches forward inside the port (``repro``'s
  ``test_decode_matches_forward``, its tolerances);
* ``run_static`` streams equal ``repro``'s on the same workload and
  frontend rows, a ragged last batch included;
* ``serve --static`` and ``train`` for both families (the card by
  default, ``--device cpu`` here), and the continuous engine's refusal;
* ROADMAP C14: ``repro``'s default ``max_len`` leaves out a VLM's vision
  rows, so its prefill rolls the cache and its streams change; the
  port's default holds them, and its attention raises at ``repro``'s.

Tolerances: logits within 1e-4 of max|logit| (the same float32 sums in
another order), 1e-3 under QAT (a weight on the ternarization threshold's
edge rounds the other way); decode against forward 2e-3 / 2e-2, as
``repro``'s own test.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data import SyntheticLM as RSyntheticLM
from repro.launch import serve as rserve
from repro.models import LM as RLM
from repro.models import layers as rlayers
from repro.serving import ContinuousScheduler as RScheduler
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.models import LM
from repro_torch.serving import ContinuousScheduler

from test_torch_model import repro_tree_to_numpy
from test_torch_packed_ckpt import _equal
from torch_cpu_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
QAT_TOL = 1e-3
ARCHS = ["seamless-m4t-large-v2", "internvl2-76b"]
MODES = {"latent": {},
         "qat": dict(quantization="ternary", ternary_min_dim=64),
         "packed": dict(quantization="ternary", ternary_min_dim=64,
                        ternary_kernel="xla")}


def _randomize(tree, rng):
    """Every linear bias, norm scale and norm bias of a ``repro`` tree
    drawn at random (init leaves them 0 and 1)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("b", "bias"):
                v = jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
            elif k == "scale":
                v = jnp.asarray(1 + rng.standard_normal(v.shape) * 0.1,
                                v.dtype)
            else:
                v = _randomize(v, rng)
            out[k] = v
        return out
    return tree


@functools.lru_cache(maxsize=None)
def _pair(arch, mode="latent", **over):
    """(repro cfg, repro params, port cfg, port params), the same weights."""
    kw = dict(dtype="float32", cache_dtype="float32", num_layers=2,
              **MODES[mode], **over)
    rcfg = rget_config(arch, reduced=True, **kw)
    pcfg = get_config(arch, reduced=True, **kw)
    rparams = _randomize(RLM(rcfg).init(jax.random.PRNGKey(0)),
                         np.random.default_rng(1))
    if mode == "packed":
        rparams = rlayers.pack_params(rparams, rcfg)
        rcfg = dataclasses.replace(rcfg, quantization="ternary_packed")
        pcfg = dataclasses.replace(pcfg, quantization="ternary_packed")
    return rcfg, rparams, pcfg, params_from_numpy(
        repro_tree_to_numpy(rparams), pcfg, "cpu")


def _close(got, ref, tol=TOL):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


def _batches(cfg, b=2, seq=24, step=0):
    """The same SyntheticLM batch for both packages: (jnp dict, torch
    dict)."""
    arrs = SyntheticLM(cfg, b, seq).global_batch(step)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


# ---------------------------------------------------------------------------
# data and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [8, 24, 40])
def test_synthetic_batches_equal_repros(arch, seq):
    """Text in the tail (at least 16 tokens), the frontend rows drawn from
    the same generator after the tokens: every array byte-equal."""
    rcfg = rget_config(arch, reduced=True)
    pcfg = get_config(arch, reduced=True)
    rdata, pdata = RSyntheticLM(rcfg, 3, seq, seed=4), SyntheticLM(
        pcfg, 3, seq, seed=4)
    assert (pdata.n_front, pdata.text_len) == (rdata.n_front, rdata.text_len)
    for step in (0, 5):
        got, want = pdata.global_batch(step), rdata.global_batch(step)
        assert set(got) == set(want)
        key = "enc_embeds" if pcfg.is_encdec else "vision_embeds"
        assert got[key].shape == (3, pcfg.frontend_seq, pcfg.d_model)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["latent", "packed"])
def test_params_round_trip_exactly(arch, mode):
    _, rparams, pcfg, pparams = _pair(arch, mode)
    if pcfg.is_encdec:
        assert len(pparams["enc_layers"]) == pcfg.enc_layers == 2
        assert {"norm_cross", "cross"} <= set(pparams["layers"][0])
    back = params_to_numpy(pparams, pcfg)
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        repro_tree_to_numpy(rparams))[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        got, ref = np.asarray(leaf), np.asarray(want[path])
        assert got.dtype == ref.dtype, path
        np.testing.assert_array_equal(got, ref)
    assert _equal(params_from_numpy(back, pcfg, "cpu"), pparams, nnz=False)


def test_packed_encdec_checkpoint_round_trips(tmp_path):
    """The packed seamless tree (encoder and cross linears packed, each
    bias inside its container) saves and restores bitwise."""
    _, _, pcfg, pparams = _pair("seamless-m4t-large-v2", "packed")
    wc = pparams["enc_layers"][1]["mixer"]["q"]["w_packed"]
    assert wc.bias is not None
    assert "w_packed" in pparams["layers"][0]["cross"]["k"]
    ckpt.save(str(tmp_path), 2, {"params": pparams})
    _, back = ckpt.restore(str(tmp_path), target={"params": pparams})
    assert _equal(back["params"], pparams)
    with pytest.raises(ValueError, match="encoder"):
        params_to_numpy(dict(pparams, enc_layers=pparams["enc_layers"][:1]),
                        pcfg)


# ---------------------------------------------------------------------------
# the model against repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_prefill_decode_match_repro(arch, mode):
    rcfg, rparams, pcfg, pparams = _pair(arch, mode)
    tol = QAT_TOL if mode == "qat" else TOL
    rlm, plm = RLM(rcfg), LM(pcfg, "cpu")
    rb, pb = _batches(pcfg)
    rx, rn, _ = rlm.forward(rparams, rb)
    px, pn, _ = plm.forward(pparams, pb)
    assert pn == rn == (pcfg.frontend_seq if pcfg.family == "vlm" else 0)
    _close(plm._logits(pparams, px), rlm._logits(rparams, rx), tol)
    (rloss, rmet), (ploss, pmet) = rlm.loss(rparams, rb), plm.loss(pparams,
                                                                   pb)
    for k in ("loss", "ce"):
        _close(pmet[k], rmet[k], tol)
    rb.pop("targets")
    pb.pop("targets")
    rb["tokens"], pb["tokens"] = rb["tokens"][:, :8], pb["tokens"][:, :8]
    max_len = 8 + 4 + (pcfg.frontend_seq if pcfg.family == "vlm" else 0)
    rc, rl = rlm.prefill(rparams, rb, max_len, cache_dtype=jnp.float32)
    pc, pl = plm.prefill(pparams, pb, max_len, cache_dtype=torch.float32)
    _close(pl, rl, tol)
    if pcfg.is_encdec:
        _close(pc["enc_out"], rc["enc_out"], tol)
    rdecode = jax.jit(rlm.decode_step)
    nxt = np.asarray(jnp.argmax(rl[:, -1], -1), np.int32)[:, None]
    for _ in range(3):
        rl, rc = rdecode(rparams, rc, jnp.asarray(nxt))
        pl, pc = plm.decode_step(pparams, pc, torch.from_numpy(nxt))
        _close(pl, rl, tol)
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1), np.int32)[:, None]
    assert int(pc["pos"]) == int(rc["pos"]) == max_len - 1


def test_encoder_under_pallas_matches_repros_kernel():
    """attn_impl="pallas": the encoder's non-causal attention through B6
    (its plain version on the CPU) against repro's Pallas flash kernel in
    interpret mode, causal=False over (B*H, S_enc, hd); the decoder's
    causal forward takes B6 as well."""
    rcfg, rparams, pcfg, pparams = _pair("seamless-m4t-large-v2",
                                         attn_impl="pallas",
                                         frontend_seq=32)
    rb, pb = _batches(pcfg, seq=48)
    renc = RLM(rcfg)._run_encoder(rparams, rb["enc_embeds"])
    penc = LM(pcfg, "cpu")._run_encoder(pparams, pb["enc_embeds"])
    _close(penc, renc)
    rx, _, _ = RLM(rcfg).forward(rparams, rb)
    px, _, _ = LM(pcfg, "cpu").forward(pparams, pb)
    _close(px, rx)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill(16 tokens) + one-token decode steps == the full forward's
    logits (repro's tests/test_models_smoke.py check, its tolerances), the
    cross-attention and the vision rows' cache positions included."""
    cfg = get_config(arch, reduced=True, dtype="float32")
    m = LM(cfg, "cpu")
    params = m.init(torch.Generator().manual_seed(0))
    _, batch = _batches(cfg, seq=48)
    del batch["targets"]
    s = batch["tokens"].shape[1]
    with torch.no_grad():
        x, n_front, _ = m.forward(params, batch)
        full = m._logits(params, x)[:, n_front:]
        s0 = 16
        max_len = s + (cfg.frontend_seq if cfg.family == "vlm" else 0)
        pre = dict(batch, tokens=batch["tokens"][:, :s0])
        cache, logits = m.prefill(params, pre, max_len,
                                  cache_dtype=torch.float32)
        np.testing.assert_allclose(logits[:, -1].numpy(),
                                   full[:, s0 - 1].numpy(), rtol=2e-3,
                                   atol=2e-3)
        for t in range(s0, s):
            logits, cache = m.decode_step(params, cache,
                                          batch["tokens"][:, t:t + 1])
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       full[:, t].numpy(), rtol=2e-2,
                                       atol=2e-2, err_msg=f"step {t}")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_run_static_streams_equal_repros(arch):
    """5 requests at batch 2: the last batch holds one request, padded with
    a copy of its prompt and frontend rows, and trimmed."""
    rcfg, rparams, pcfg, pparams = _pair(arch, "packed")
    prompts, gens, extras = serve.build_workload(pcfg, 5, 24, (2, 5),
                                                 seed=3)
    rprompts, rgens, rextras = rserve.build_workload(rcfg, 5, 24, (2, 5),
                                                     seed=3)
    np.testing.assert_array_equal(prompts, rprompts)
    assert gens == rgens and set(extras) == set(rextras) and extras
    for k in extras:
        assert extras[k].tobytes() == rextras[k].tobytes()
    max_len = prompts.shape[1] + max(gens) + 1 + (
        pcfg.frontend_seq if pcfg.family == "vlm" else 0)
    rserver = rserve.BatchedServer(rcfg, max_len)
    rserver.load(rparams)
    routs, rmet = rserve.run_static(rserver, prompts, gens, 2, extras)
    server = serve.BatchedServer(pcfg, max_len, "cpu")
    server.load(pparams)
    outs, met = serve.run_static(server, prompts, gens, 2, extras)
    for got, want in zip(outs, routs):
        np.testing.assert_array_equal(got, want)
    for key in ("submitted", "drained", "generated_tokens", "decode_steps"):
        assert met[key] == rmet[key], key


def test_engine_refuses_like_repro():
    for arch in ARCHS:
        with pytest.raises(ValueError) as rerr:
            RScheduler(rget_config(arch, reduced=True), max_slots=2,
                       max_len=16)
        with pytest.raises(ValueError) as perr:
            ContinuousScheduler(get_config(arch, reduced=True), max_slots=2,
                                max_len=16, device="cpu")
        assert str(perr.value) == str(rerr.value)


SERVE = ["--reduced", "--packed", "--ternary-min-dim", "64", "--requests",
         "3", "--batch", "2", "--prompt-len", "12", "--gen-lens", "2,3"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_static(arch, capsys):
    """``serve --static`` drains both families (a VLM's default max_len
    holds its vision rows); without --static the engine refuses them, as
    repro's does; the card is the default device."""
    args = ["--arch", arch] + SERVE
    m = serve.main(args + ["--static", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == m and m["drained"] == 3 and m["engine"] == "static"
    assert m["generated_tokens"] in range(6, 10)
    with pytest.raises(ValueError, match="static BatchedServer"):
        serve.main(args + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(args + ["--static"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli(arch, tmp_path):
    """Three QAT steps with the frontends, checkpointed and restored into
    the same run (steps 2 and 3 after a restart at 2)."""
    args = ["--arch", arch, "--reduced", "--set", "ternary_min_dim=64",
            "--set", "quantization=ternary", "--set", "grad_accum=2",
            "--set", "dtype=float32", "--batch", "4", "--seq", "24",
            "--lr", "3e-3", "--ckpt-every", "2", "--log-every", "100",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = train.main(args + ["--steps", "2"])
    again = train.main(args + ["--steps", "3"])
    assert first["steps"] == 2 and again["steps"] == 1
    assert np.isfinite([first["first_loss"], again["last_loss"]]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(args[:-2] + ["--steps", "1"])


# ---------------------------------------------------------------------------
# ROADMAP C14: repro's default max_len leaves out a VLM's vision rows
# ---------------------------------------------------------------------------

def test_c14_default_max_len_and_vision_rows():
    """Reduced internvl2 (8 vision rows), 2 requests of 4 text tokens,
    budgets 4, static batch 2. repro's default max_len (prompt + budget +
    1 = 9) is shorter than the 12 prefilled rows: its prefill keeps the
    last 9 in a rolled cache though the model has no window, and its
    streams differ from a max_len that fits (64). Both packages give the
    same streams at 64; the port's attention raises at 9, and the port's
    serve default adds the vision rows."""
    rcfg, rparams, pcfg, pparams = _pair("internvl2-76b", "packed")
    prompts, gens, extras = serve.build_workload(pcfg, 2, 4, [4])
    assert prompts.shape == (2, 4) and extras["vision_embeds"].shape[1] == 8
    default = 4 + max(gens) + 1

    def rrun(max_len):
        server = rserve.BatchedServer(rcfg, max_len)
        server.load(rparams)
        return rserve.run_static(server, prompts, gens, 2, extras)[0]

    server = serve.BatchedServer(pcfg, 64, "cpu")
    server.load(pparams)
    fits = serve.run_static(server, prompts, gens, 2, extras)[0]
    rfits, rrolled = rrun(64), rrun(default)
    for a, b in zip(fits, rfits):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(rfits, rrolled))
    short = serve.BatchedServer(pcfg, default, "cpu")
    short.load(pparams)
    with pytest.raises(ValueError, match="exceeds the cache"):
        serve.run_static(short, prompts, gens, 2, extras)
    m = serve.main(["--arch", "internvl2-76b", "--reduced", "--requests",
                    "2", "--batch", "2", "--prompt-len", "4", "--gen-lens",
                    "4", "--static", "--device", "cpu"])
    assert m["generated_tokens"] == 8
