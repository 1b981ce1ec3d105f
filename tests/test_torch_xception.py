"""The port's Xception (biscuit_torch/models/xception.py) against the Flax
model, stage by stage, on the same weights and inputs.

Tolerances: in float32 compute, 1e-4 of the largest value (both sides
run the same f32 arithmetic; only sum order differs). In bf16 compute,
3e-2 of the largest value: both sides round every conv and BN output to
bf16, and a rounding that flips early moves later values by a few bf16
ulps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from biscuit_torch.hp import ModelParams as TorchModelParams
from biscuit_torch.models.convert import from_flax
from biscuit_torch.models.xception import build_model as torch_build_model
from biscuit_torch.models.xception import max_pool_same
from biscuit_tpu.hp import ModelParams
from biscuit_tpu.models.xception import build_model
from biscuit_tpu.train.trainer import init_model

torch.set_num_threads(1)


def _perturbed(params, stats, seed=0):
    """Non-trivial BN affine and statistics, so a BN mistake shows."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, unfreeze(params))
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.05, 0.3, a.shape).astype(
            np.float32), unfreeze(stats))

    def bn(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                if "scale" in v:
                    v["scale"] = (v["scale"] * rng.uniform(0.7, 1.3, v[
                        "scale"].shape)).astype(np.float32)
                    v["bias"] = rng.normal(0, 0.1, v["bias"].shape).astype(
                        np.float32)
                else:
                    bn(v)
    bn(params)
    return params, stats


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    hp = ModelParams(model="xception_tiny", tile_px=75, hidden_layer_width=32,
                     compute_dtype=dtype)
    fmodel = build_model(hp)
    params, stats = init_model(fmodel, hp, jax.random.PRNGKey(0))
    params, stats = _perturbed(params, stats)
    tmodel = torch_build_model(TorchModelParams(**hp.to_dict()))
    tmodel.load_state_dict(from_flax(params, stats))
    tmodel.eval()
    tol = 1e-4 if dtype == "float32" else 3e-2
    return fmodel, {"params": params, "batch_stats": stats}, tmodel, tol


def _close(got, want, tol):
    got = np.asarray(got.detach().float().numpy(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dtype,px", [("float32", 75), ("float32", 71),
                                      ("bfloat16", 75)])
def test_stages_match_flax(dtype, px):
    """75 px puts an even size (18) before entry1's pool, exercising the
    asymmetric SAME pad; 71 px keeps every pool input odd."""
    fmodel, v, tmodel, tol = _pair(dtype)
    x = np.random.default_rng(px).normal(0, 1, (2, px, px, 3)).astype(
        np.float32)
    tx = torch.from_numpy(x)

    def flax(method, inp):
        return fmodel.apply(v, jnp.asarray(inp), train=False, method=method)

    with torch.no_grad():
        feats = np.asarray(flax("features", x))
        assert (feats > 0).mean() > 0.3      # live features
        _close(tmodel.features(tx), feats, tol)
        _close(tmodel.trunk_stem(tx), flax("trunk_stem", x), tol)
        entry = flax("trunk_entry", x)
        _close(tmodel.trunk_entry(tx), entry, tol)
        te = torch.tensor(np.asarray(entry.astype(jnp.float32))).to(
            tmodel.compute_dtype)
        mid = flax("trunk_middle", entry)
        _close(tmodel.trunk_middle(te), mid, tol)
        tm = torch.tensor(np.asarray(mid.astype(jnp.float32))).to(
            tmodel.compute_dtype)
        _close(tmodel.trunk_exit(tm), flax("trunk_exit", mid), tol)
        tail_in = np.random.default_rng(1).normal(
            0, 1, (2, 3, 3, 64)).astype(np.float32)
        _close(tmodel.trunk_exit_tail(torch.from_numpy(tail_in)),
               flax("trunk_exit_tail", tail_in), tol)
        _close(tmodel.head_logits(torch.tensor(feats)),
               flax("head_logits", feats), 1e-5)


@pytest.mark.parametrize("size", [(6, 6), (7, 7), (18, 9)])
def test_max_pool_same_matches_flax(size):
    import flax.linen as nn

    x = np.random.default_rng(0).normal(0, 1, (1, *size, 4)).astype(
        np.float32)
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding="SAME")
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_unknown_arch_raises(caplog):
    """As the JAX package: the classifier raises on an unknown arch, and
    the ``hp.model`` registry (``build_model``) warns and builds the
    published 'xception' instead; 'resnet50' is registered."""
    import logging

    from biscuit_torch.models.xception import XceptionClassifier

    with pytest.raises(ValueError, match="Unknown architecture"):
        XceptionClassifier(arch="nope")
    with caplog.at_level(logging.WARNING, logger="biscuit_torch"):
        model = torch_build_model(TorchModelParams(model="nope"))
    assert model.arch == "xception"
    assert "Unknown model 'nope'; falling back to 'xception'" in caplog.text
    assert torch_build_model(TorchModelParams(model="resnet50")).arch == (
        "resnet50")
