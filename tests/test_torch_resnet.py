"""The port's ResNet family (biscuit_torch/models/resnet.py) against the
Flax ``ResNetBackbone`` of the JAX package, on the same weights and
inputs, and the ``hp.model`` registry around it.

Tolerances as tests/test_torch_xception.py: in f32 compute 1e-4 of the
largest value, in bf16 3e-2. 37 px puts an even size (10) before stage
1's stride-2 conv and 64 px even sizes everywhere, so the asymmetric
Flax ``SAME`` pads (0 before, 1 after) are exercised in convs and pool.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from biscuit_torch.hp import ModelParams as TorchParams
from biscuit_torch.models import resnet
from biscuit_torch.models import xception as port_x
from biscuit_torch.models.convert import from_flax, to_flax
from biscuit_torch.train.trainer import init_model as port_init
from biscuit_torch.train.uq import UncertaintyInterface, trunk_features
from biscuit_tpu.hp import ModelParams
from biscuit_tpu.models import resnet as jax_resnet
from biscuit_tpu.models import xception as jax_x
from biscuit_tpu.train.trainer import init_model

torch.set_num_threads(1)


def _hp(arch, dtype="float32", **kw):
    return ModelParams(model=arch, tile_px=37, hidden_layer_width=32,
                       compute_dtype=dtype, **kw)


def _perturbed(params, stats, seed=0):
    """BN scales away from the init (the last BN of a block starts at 0,
    which would hide its branch) and statistics away from identity."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, unfreeze(params))
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.05, 0.3, a.shape).astype(
            np.float32), unfreeze(stats))

    def bn(tree):
        for v in tree.values():
            if isinstance(v, dict):
                if "scale" in v:
                    v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape
                                             ).astype(np.float32)
                    v["bias"] = rng.normal(0, 0.1, v["bias"].shape).astype(
                        np.float32)
                else:
                    bn(v)
    bn(params)
    return params, stats


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    hp = _hp(arch, dtype)
    fmodel = jax_x.build_model(hp)
    params, stats = _perturbed(*init_model(fmodel, hp, jax.random.PRNGKey(0)))
    tmodel = port_x.build_model(TorchParams(**hp.to_dict()))
    tmodel.load_state_dict(from_flax(params, stats))
    tol = 1e-4 if dtype == "float32" else 3e-2
    return hp, fmodel, {"params": params, "batch_stats": stats}, tmodel, tol


def _close(got, want, tol):
    got = np.asarray(got.detach().float().numpy(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("arch,dtype,px", [
    ("resnet_tiny", "float32", 64), ("resnet_tiny", "bfloat16", 37),
    ("resnet18", "float32", 37)])
def test_eval_features_match_flax(arch, dtype, px):
    _hp_, fmodel, v, tmodel, tol = _pair(arch, dtype)
    x = np.random.default_rng(px).normal(0, 1, (2, px, px, 3)).astype(
        np.float32)
    want = np.asarray(fmodel.apply(v, jnp.asarray(x), train=False,
                                   method="features"))
    assert (want > 0).mean() > 0.2      # live features
    with torch.no_grad():
        _close(tmodel.eval().features(torch.from_numpy(x)), want, tol)
        feats = np.random.default_rng(1).normal(
            0, 1, (2, want.shape[1])).astype(np.float32)
        _close(tmodel.head_logits(torch.from_numpy(feats)),
               fmodel.apply(v, jnp.asarray(feats), method="head_logits"),
               1e-5)


@pytest.mark.parametrize("arch", ["resnet_tiny"])
def test_train_mode_batch_statistics_match_flax(arch):
    """Train-mode BN normalizes with the batch's statistics and blends
    them into the running ones, as Flax does."""
    _hp_, fmodel, v, _t, _tol = _pair(arch, "float32")
    tmodel = port_x.build_model(TorchParams(**_hp_.to_dict()))
    tmodel.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    x = np.random.default_rng(3).normal(0, 1, (4, 37, 37, 3)).astype(
        np.float32)
    want, upd = fmodel.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"], method="features")
    tmodel.train()
    with torch.no_grad():
        _close(tmodel.features(torch.from_numpy(x)), want, 1e-4)
    _p, stats = to_flax(tmodel.state_dict())
    got = dict(jax.tree_util.tree_flatten_with_path(stats)[0])
    ref = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, unfreeze(upd["batch_stats"])))[0])
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=str(k))


def test_init_zeroes_each_blocks_last_scale():
    """As Flax's ``scale_init=zeros``: exactly the scales the JAX init
    zeroes are zero in the port's init, every other scale is one."""
    hp = _hp("resnet_tiny")
    jp, _s = init_model(jax_x.build_model(hp), hp, jax.random.PRNGKey(0))
    model = port_init(port_x.build_model(TorchParams(**hp.to_dict())),
                      TorchParams(**hp.to_dict()), torch.Generator())
    params, _stats = to_flax(model.state_dict())

    def scales(tree):
        return {jax.tree_util.keystr(k): np.asarray(a)
                for k, a in jax.tree_util.tree_flatten_with_path(
                    unfreeze(tree))[0] if k[-1].key == "scale"}

    want, got = scales(jp), scales(params)
    assert want.keys() == got.keys()
    zeroed = {k for k, a in want.items() if not a.any()}
    assert zeroed == {k for k in want if k.endswith("['bn2']['scale']")}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_uq_interface_on_the_cpu():
    """The module trunk and head: at dropout 0 the mean is the softmax of
    the Flax logits of the same preprocessed tiles, and the std is 0. A
    fused trunk is Xception's and refused."""
    from biscuit_torch.data.normalize import inference_preprocess

    hp, fmodel, v, _t, _tol = _pair("resnet_tiny", "float32")
    thp = TorchParams(**{**hp.to_dict(), "dropout": 0.0, "normalizer": None,
                         "uq_samples": 3})
    tmodel = port_x.build_model(thp)
    tmodel.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    tiles = np.random.default_rng(4).integers(0, 256, (3, 37, 37, 3),
                                              dtype=np.uint8)
    ui = UncertaintyInterface.from_model(tmodel, thp, device="cpu")
    mean, std = ui(tiles)
    x = inference_preprocess(torch.from_numpy(tiles), None)
    want = jax.nn.softmax(fmodel.apply(v, jnp.asarray(x.numpy()),
                                       train=False))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want), atol=1e-5)
    assert not std.any() and not ui._fused
    with pytest.raises(ValueError, match="fused trunk is Xception's"):
        UncertaintyInterface.from_model(tmodel, thp, device="cpu",
                                        fuse_blocks=True)
    with pytest.raises(ValueError, match="fused trunk is Xception's"):
        trunk_features(tmodel, x, fused_trunk=True)


def test_registry_matches_the_jax_package(caplog):
    # The port's registry is the JAX package's and the ViT family, which
    # the JAX package lacks (tests/test_torch_vit.py).
    from biscuit_torch.models.vit import VIT_ARCHS

    assert port_x.available_models() == (jax_x.available_models()
                                         + sorted(VIT_ARCHS))
    assert resnet.RESNET_ARCHS == jax_resnet.RESNET_ARCHS
    for name in jax_x.available_models() + ["nope"]:
        hp = TorchParams(model=name)
        assert port_x.feature_dim(hp) == jax_x.feature_dim(
            ModelParams(model=name))
    model = port_x.build_model(TorchParams(model="resnet50"))
    assert model.arch == "resnet50"
    assert model.head.hidden0.in_features == 2048
    assert model.backbone.stage3_block2.conv3.weight.shape == (2048, 512,
                                                               1, 1)


@pytest.mark.parametrize("size,k,stride", [(299, 7, 2), (150, 3, 2),
                                           (75, 3, 2), (38, 3, 2),
                                           (19, 3, 2), (19, 1, 2),
                                           (38, 1, 2), (10, 3, 1)])
def test_same_pads_match_lax(size, k, stride):
    """ResNet-50's pads at 299 px: the stem (3, 3), the stride convs (1, 1)
    on odd sizes and (0, 1) on even ones."""
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert resnet.same_pads(size, k, stride) == tuple(want)
