"""The port's fused-backward train trunk (biscuit_torch/train/fused_train.py)
against the JAX twin (biscuit_tpu/train/fused_train.py, backend
'reference') on xception_tiny at 37 px, from the same weights and inputs.

Tolerances, as max |diff| over the largest |value| of each tensor:
  * f32: features and running statistics 1e-4, gradients 1e-3 (the same
    arithmetic in another summation order, through 38 layers), or 1e-4
    of the tree's largest gradient for the exit block's BN biases, whose
    true gradient is ~0 (rounding residue on both sides);
  * bf16: running statistics 3e-2. At 37 px the exit layers are 1x1 and
    BatchNorm normalizes over 8 values, so bf16 rounding alone moves
    JAX's features by 5% and some gradients by 70% from JAX's f32
    result. So the bound is relative to that noise: the port's bf16
    features, and its bf16 gradient tree (relative L2 norm), must be no
    further from JAX's f32 result than twice JAX's own bf16 result is.
Inside the port, the fused trunk and the module path in train mode run
the same forward; their gradients agree to 1e-4 in f32 and 5e-2 in bf16
(where the fused backward keeps gd in f32), with the same floor.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from biscuit_torch.hp import ModelParams as TorchModelParams
from biscuit_torch.models.convert import from_flax, to_flax
from biscuit_torch.models.xception import build_model as torch_build_model
from biscuit_torch.train.fused_train import (
    apply_stat_updates,
    fused_train_applicable,
    trunk_train_apply,
)
from biscuit_tpu.hp import ModelParams
from biscuit_tpu.models.xception import build_model
from biscuit_tpu.train import fused_train as jft
from biscuit_tpu.train.trainer import init_model

torch.set_num_threads(1)
PX = 37


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  unfreeze(tree))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v, np.float32)


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    """JAX params/stats with a non-trivial BN affine, the port model
    loaded from them, and a standardized-like input batch."""
    hp = ModelParams(model="xception_tiny", tile_px=PX, hidden_layer_width=32,
                     compute_dtype=dtype)
    params, stats = init_model(build_model(hp), hp, jax.random.PRNGKey(0))
    params, stats = _np_tree(params), _np_tree(stats)
    rng = np.random.default_rng(0)

    def affine(tree):
        for v in tree.values():
            if isinstance(v, dict):
                if "scale" in v:
                    v["scale"] = rng.uniform(0.7, 1.3, v["scale"].shape
                                             ).astype(np.float32)
                    v["bias"] = rng.normal(0, 0.1, v["bias"].shape
                                           ).astype(np.float32)
                else:
                    affine(v)

    affine(params)
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.05, 0.3, a.shape)).astype(np.float32),
        stats)
    x = rng.standard_normal((8, PX, PX, 3)).astype(np.float32)
    return hp, params, stats, x


def _torch_model(dtype):
    hp, params, stats, _ = _setup(dtype)
    model = torch_build_model(TorchModelParams(**hp.to_dict()))
    model.load_state_dict(from_flax(params, stats))
    return model.train()


@functools.lru_cache(maxsize=None)
def _jax_run(dtype):
    """JAX features, backbone stat updates and grads of sum(feats * w)."""
    hp, params, stats, x = _setup(dtype)
    w = np.random.default_rng(1).standard_normal((8, 128)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))

    @jax.jit
    def run(bb):
        def loss(bb):
            feats, upd = jft.trunk_train_apply(
                "xception_tiny", bb, stats["backbone"], xj,
                backend="reference")
            return jnp.sum(feats * w), (feats, upd)

        (_, (feats, upd)), grads = jax.value_and_grad(loss, has_aux=True)(bb)
        return feats, upd, grads

    feats, upd, grads = run(params["backbone"])
    return (np.asarray(feats), dict(_flat(_np_tree(upd))),
            dict(_flat(_np_tree(grads))), w)


def _torch_run(dtype, fused=True):
    _, _, _, x = _setup(dtype)
    _, _, _, w = _jax_run(dtype)
    model = _torch_model(dtype)
    bb = model.backbone
    xt = torch.from_numpy(x)
    if fused:
        feats, upd = trunk_train_apply(bb, xt)
        stats = {f"{k}.{s}": v.detach().numpy()
                 for k, (m, var) in upd.items()
                 for s, v in (("mean", m), ("var", var))}
    else:
        feats = model.features(xt)
        stats = {k.replace("running_", ""): v.numpy()
                 for k, v in bb.state_dict().items() if "running_" in k}
    (feats * torch.from_numpy(w)).sum().backward()
    grads = dict(_flat(to_flax({n: p.grad for n, p in bb.named_parameters()}
                               )[0]))
    return feats.detach().numpy(), stats, grads


def _rel(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _l2(got, want):
    keys = sorted(want)
    g = np.concatenate([got[k].ravel() for k in keys])
    w = np.concatenate([want[k].ravel() for k in keys])
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _assert_grads_close(got, want, rel_tol, floor):
    assert set(got) == set(want)
    tree_max = max(np.abs(v).max() for v in want.values())
    for key, w in want.items():
        diff = np.abs(got[key] - w).max()
        rel = diff / (np.abs(w).max() + 1e-12)
        assert rel < rel_tol or diff < floor * tree_max, (key, rel, diff)


def test_features_and_stats_match_jax_f32():
    feats_j, upd_j, _, _ = _jax_run("float32")
    feats, upd, _ = _torch_run("float32")
    assert (feats_j > 0).mean() > 0.3                  # live features
    assert _rel(feats, feats_j) < 1e-4
    assert set(upd) == set(upd_j) and len(upd) == 2 * 22
    for key, v in upd_j.items():
        assert _rel(upd[key], v) < 1e-4, key


def test_features_and_stats_match_jax_bf16():
    feats32, _, _, _ = _jax_run("float32")
    feats_j, upd_j, _, _ = _jax_run("bfloat16")
    feats, upd, _ = _torch_run("bfloat16")
    assert set(upd) == set(upd_j)
    for key, v in upd_j.items():
        assert _rel(upd[key], v) < 3e-2, key
    assert _rel(feats, feats32) <= 2 * _rel(feats_j, feats32)


def test_grads_match_jax_f32():
    _, _, grads_j, _ = _jax_run("float32")
    _, _, grads = _torch_run("float32")
    _assert_grads_close(grads, grads_j, 1e-3, 1e-4)


def test_grads_match_jax_bf16():
    _, _, grads32, _ = _jax_run("float32")
    _, _, grads_j, _ = _jax_run("bfloat16")
    _, _, grads = _torch_run("bfloat16")
    assert set(grads) == set(grads_j)
    assert _l2(grads, grads32) <= 2 * _l2(grads_j, grads32)


@pytest.mark.parametrize("dtype,rel_tol,floor", [("float32", 1e-4, 1e-6),
                                                 ("bfloat16", 5e-2, 1e-3)])
def test_fused_trunk_matches_module_path(dtype, rel_tol, floor):
    feats_f, upd_f, grads_f = _torch_run(dtype, fused=True)
    feats_m, stats_m, grads_m = _torch_run(dtype, fused=False)
    np.testing.assert_array_equal(feats_f, feats_m)
    for key, v in upd_f.items():
        assert _rel(v, stats_m[key]) < 1e-6, key
    _assert_grads_close(grads_f, grads_m, rel_tol, floor)


def test_apply_stat_updates_and_applicability():
    model = _torch_model("bfloat16")
    _, _, _, x = _setup("bfloat16")
    with torch.no_grad():
        _, upd = trunk_train_apply(model.backbone, torch.from_numpy(x))
    apply_stat_updates(model.backbone, upd)
    bn = model.backbone.entry1.bn0
    assert torch.equal(bn.running_mean, upd["entry1.bn0"][0])
    assert torch.equal(bn.running_var, upd["entry1.bn0"][1])
    assert fused_train_applicable(model)
    assert not fused_train_applicable(_torch_model("float32"))
