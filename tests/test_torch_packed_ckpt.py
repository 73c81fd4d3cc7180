"""Packed checkpoints (``TernaryWeight`` trees) in the port:

* a packed tree, MoE banks and SSM projections included, saves leaf-wise
  (``.../w_packed/packed``, ``scale``; words as ``repro``'s uint32; the
  format and static fields in the manifest) and restores bitwise, with a
  target and without one;
* a packed tree that ``repro.checkpoint.save`` wrote (no static fields on
  disk) restores in the port into a skeleton drawn from the config (its
  static fields, the logical shapes among them, come from there) and
  through ``params_from_numpy``, and gives ``repro``'s logits;
* ``params_to_numpy`` writes ``repro``'s period (jamba's 8) with packed
  banks, and ``params_from_numpy`` inverts it bitwise.

Tolerances: trees bitwise; float32 logits within 1e-4 of max|logit| (the
same sums in another order).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.configs import get_config as rget_config
from repro.models import LM as RLM
from repro.models import layers as rlayers
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.core.weights import Dense2Bit, TernaryWeight
from repro_torch.models import LM
from repro_torch.models.layers import pack_params

TOL = 1e-4
KW = dict(dtype="float32", cache_dtype="float32", quantization="ternary",
          ternary_min_dim=64)


def _equal(a, b, nnz=True) -> bool:
    """Trees bitwise; ``nnz=False`` skips the containers' pack-time nonzero
    count, which ``repro``'s layout does not carry."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k], nnz) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y, nnz)
                                        for x, y in zip(a, b))
    if isinstance(a, TernaryWeight):
        return (type(a) is type(b) and a.shape == b.shape
                and (a.nnz == b.nnz or not nnz) and all(
                    (getattr(a, f) is None and getattr(b, f) is None)
                    or torch.equal(getattr(a, f), getattr(b, f))
                    for f in a._leaves))
    return a.dtype == b.dtype and torch.equal(a, b)


def _packed(arch, seed=0, **overrides):
    cfg = get_config(arch, reduced=True, **dict(KW, **overrides))
    params = LM(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    return cfg, pack_params(params, cfg)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "jamba-v0.1-52b"])
def test_packed_tree_round_trips_bitwise(arch, tmp_path):
    cfg, params = _packed(arch, num_layers=2, **(
        dict(attn_period=2, attn_offset=1) if arch.startswith("jamba")
        else {}))
    moe = next(lay["ffn"] for lay in params["layers"]
               if "router" in lay.get("ffn", {}))
    assert isinstance(moe["w_in"], Dense2Bit) and moe["w_in"].packed.ndim == 3
    path = ckpt.save(str(tmp_path), 7, {"params": params})
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    key = next(k for k in manifest["containers"] if k.endswith("ffn/w_in"))
    assert manifest["containers"][key]["format"] == "dense2bit"
    assert manifest["containers"][key]["shape"] == list(moe["w_in"].shape)
    assert manifest["leaves"][key + "/packed"]["dtype"] == "uint32"
    assert key + "/bias" not in manifest["leaves"]
    step, got = ckpt.restore(str(tmp_path), target={"params": params})
    assert step == 7 and _equal(params, got["params"])
    _, flat = ckpt.restore(str(tmp_path))
    assert _equal(moe["w_in"], flat[key])


def _repro_packed(arch, **overrides):
    rcfg = rget_config(arch, reduced=True, **dict(KW, **overrides))
    rparams = rlayers.pack_params(RLM(rcfg).init(jax.random.PRNGKey(0)),
                                  rcfg)
    pcfg = get_config(arch, reduced=True, **dict(KW, **overrides))
    return (dataclasses.replace(rcfg, quantization="ternary_packed"), rparams,
            dataclasses.replace(pcfg, quantization="ternary_packed"))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "jamba-v0.1-52b",
                                  "mamba2-130m"])
def test_repro_saved_packed_checkpoint_restores(arch, tmp_path):
    over = (dict(num_layers=2, attn_period=2, attn_offset=1)
            if arch.startswith("jamba") else dict(num_layers=2))
    rcfg, rparams, pcfg = _repro_packed(arch, **over)
    rckpt.save(str(tmp_path), 3, rparams)
    _, tree = ckpt.restore(str(tmp_path), target=_skeleton(arch, **over))
    params = params_from_numpy(tree, pcfg, "cpu")
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab_size, size=(2, 16)).astype(np.int32)
    rlm, plm = RLM(rcfg), LM(pcfg, "cpu")
    rx, _, _ = rlm.forward(rparams, {"tokens": jnp.asarray(toks)})
    px, _, _ = plm.forward(params, {"tokens": torch.from_numpy(toks)})
    ref = np.asarray(rlm._logits(rparams, rx), np.float32)
    np.testing.assert_allclose(plm._logits(params, px).numpy(), ref,
                               rtol=TOL, atol=TOL * float(np.abs(ref).max()))
    # every container's logical shape, from the skeleton, is repro's
    def shapes(node, ref, path=()):
        if isinstance(node, TernaryWeight):
            assert node.shape == tuple(ref.shape), path
            return 1
        if isinstance(node, dict):
            return sum(shapes(v, ref[k], path + (k,))
                       for k, v in node.items())
        return 0
    assert shapes(tree, rparams) > 0


def _skeleton(arch, **overrides):
    """A restore target for ``arch``'s packed checkpoint, from the config
    alone: the model drawn on the CPU from another seed, packed, written in
    repro's layout by ``params_to_numpy``, its containers the port's
    ``Dense2Bit`` (words int32). Restoring takes its structure, dtypes and
    static fields, none of its values."""
    cfg, params = _packed(arch, seed=1, **overrides)

    def to_container(node):
        if isinstance(node, dict):
            if set(node) == {"packed", "scale", "bias", "shape"}:
                return Dense2Bit.from_packed(
                    torch.from_numpy(node["packed"].view(np.int32)),
                    k=node["shape"][0],
                    scale=torch.from_numpy(node["scale"]),
                    bias=None if node["bias"] is None
                    else torch.from_numpy(node["bias"]))
            return {k: to_container(v) for k, v in node.items()}
        return torch.as_tensor(node)
    return to_container(params_to_numpy(params, cfg))


def test_period_eight_round_trips_through_numpy():
    """jamba's reduced config keeps its 8-layer period: block{j} stacks
    layers j, 8 + j, ...; packed banks and SSM projections included."""
    cfg, params = _packed("jamba-v0.1-52b", num_layers=16)
    tree = params_to_numpy(params, cfg)
    assert sorted(k for k in tree if k.startswith("block")) == \
        [f"block{j}" for j in range(8)]
    assert tree["block1"]["ffn"]["w_in"]["packed"].shape[:2] == (2, 4)
    assert tree["block1"]["ffn"]["w_in"]["packed"].dtype == np.uint32
    assert _equal(params, params_from_numpy(tree, cfg, "cpu"), nnz=False)
    with pytest.raises(ValueError, match="period"):
        params_from_numpy({"block0": tree["block0"], **{
            k: v for k, v in tree.items() if not k.startswith("block")}},
            cfg, "cpu")
