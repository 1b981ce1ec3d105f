"""The port's training step and checkpoints (biscuit_torch/train/trainer.py)
against the JAX trainer on xception_tiny at 37 px.

One make_train_step step from the same params and batch, with augment
off and dropout 0, on both sides; the JAX step runs under jit with an
optax transformation whose state captures the gradients, the port's
leaves them in .grad. Tolerances, as max |diff| over the largest |value|
of each tensor:
  * f32, module path against flax autodiff: loss 1e-5, accuracy exact,
    gradients 1e-3 (or 1e-4 of the tree's largest gradient where the
    true gradient is ~0), running statistics 1e-4;
  * bf16, fused trunk against JAX's fused trunk (BISCUIT_FUSED_TRAIN=1,
    whose units take the XLA reference backward on the CPU): running
    statistics 3e-2, and loss and the gradient tree (relative L2 norm)
    no further from the f32 step's than twice JAX's own bf16 step is,
    since bf16 rounding alone moves this tiny model's gradients by tens
    of percent (tests/test_torch_fused_train.py).
The optimizers agree with optax to a few f32 roundings of the unit-scale
parameters (1e-6 absolute; torch forms the step size in double), and a
checkpoint written by the port loads bit for bit in the JAX package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from biscuit_torch.data.normalize import make_normalizer as t_make_normalizer
from biscuit_torch.hp import ModelParams as TorchModelParams
from biscuit_torch.models.convert import from_flax, to_flax
from biscuit_torch.models.xception import build_model as torch_build_model
from biscuit_torch.train import trainer as ttr
from biscuit_tpu.data.normalize import make_normalizer
from biscuit_tpu.hp import nature2022
from biscuit_tpu.models.xception import build_model
from biscuit_tpu.train import trainer as jtr

torch.set_num_threads(1)
PX, N = 37, 8


def _hp(dtype):
    hp = nature2022.copy()
    hp.model, hp.tile_px, hp.compute_dtype = "xception_tiny", PX, dtype
    hp.hidden_layer_width, hp.dropout, hp.augment = 32, 0.0, ""
    return hp


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
def _state():
    """Shared JAX params/stats (non-trivial BN affine) and one batch."""
    hp = _hp("float32")
    params, stats = jtr.init_model(build_model(hp), hp, jax.random.PRNGKey(0))
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

    affine(params["backbone"])
    images = rng.integers(0, 256, (N, PX, PX, 3), dtype=np.uint8)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, -1], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
    return params, stats, images, labels, mask


def _grad_capture():
    """An optax transformation whose new state is the gradient tree."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@functools.lru_cache(maxsize=None)
def _jax_step(dtype, fused):
    """The JAX step's (loss, acc, grads, new batch_stats); the fused trunk
    is the JAX trainer's opt-in BISCUIT_FUSED_TRAIN=1, read when the step
    is made."""
    params, stats, images, labels, mask = _state()
    hp = _hp(dtype)
    model = build_model(hp)
    tx = _grad_capture()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BISCUIT_FUSED_TRAIN", "1" if fused else "0")
        step = jax.jit(jtr.make_train_step(model, tx, hp,
                                           make_normalizer(hp.normalizer)))
    _, new_bs, grads, metrics = step(
        params, stats, tx.init(params), jnp.asarray(images),
        jnp.asarray(labels), jnp.asarray(mask), jax.random.PRNGKey(1))
    return (float(metrics["loss"]), float(metrics["acc"]),
            dict(_flat(_np_tree(grads))), dict(_flat(_np_tree(new_bs))))


def _torch_step(dtype, fused):
    params, stats, images, labels, mask = _state()
    hp = TorchModelParams(**_hp(dtype).to_dict())
    model = torch_build_model(hp)
    model.load_state_dict(from_flax(params, stats))
    tx = ttr.make_optimizer(hp, model.parameters())
    step = ttr.make_train_step(model, tx, hp,
                               t_make_normalizer(hp.normalizer),
                               fused_trunk=fused, device="cpu")
    out = step(torch.from_numpy(images), torch.from_numpy(labels),
               torch.from_numpy(mask), torch.Generator().manual_seed(1))
    grads = to_flax({n: p.grad for n, p in model.named_parameters()})[0]
    stats_after = to_flax(model.state_dict())[1]
    return (float(out["loss"]), float(out["acc"]), dict(_flat(grads)),
            dict(_flat(stats_after)), tx)


def _rel(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _l2(got, want):
    keys = sorted(want)
    g = np.concatenate([got[k].ravel() for k in keys])
    w = np.concatenate([want[k].ravel() for k in keys])
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def test_train_step_f32_module_path_matches_flax():
    loss_j, acc_j, grads_j, bs_j = _jax_step("float32", False)
    loss, acc, grads, bs, tx = _torch_step("float32", False)
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
    assert acc == acc_j and 0 <= acc <= 1
    assert set(grads) == set(grads_j) and set(bs) == set(bs_j)
    tree_max = max(np.abs(v).max() for v in grads_j.values())
    for key, w in grads_j.items():
        diff = np.abs(grads[key] - w).max()
        assert (diff < 1e-3 * np.abs(w).max() or diff < 1e-4 * tree_max), key
    for key, w in bs_j.items():
        assert _rel(bs[key], w) < 1e-4, key
    assert tx.count == 1


def test_train_step_bf16_fused_matches_jax_fused():
    loss32, _, grads32, _ = _jax_step("float32", False)
    loss_j, _, grads_j, bs_j = _jax_step("bfloat16", True)
    loss, acc, grads, bs, _ = _torch_step("bfloat16", True)
    assert np.isfinite(loss) and 0 <= acc <= 1
    assert set(grads) == set(grads_j)
    for key, w in bs_j.items():
        assert _rel(bs[key], w) < 3e-2, key
    assert abs(loss - loss32) <= 2 * abs(loss_j - loss32) + 1e-4 * loss32
    assert _l2(grads, grads32) <= 2 * _l2(grads_j, grads32)


def test_train_step_defaults_to_the_card(monkeypatch):
    """Without device="cpu" the step is for the card: with no card it
    raises, and a model that is not on the asked device is refused."""
    hp = TorchModelParams(**_hp("float32").to_dict())
    model = torch_build_model(hp)
    tx = ttr.make_optimizer(hp, model.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.make_train_step(model, tx, hp, None)
    with pytest.raises(ValueError, match="must be on meta"):
        ttr.make_train_step(model, tx, hp, None, device="meta")
    ttr.make_train_step(model, tx, hp, None, device="cpu")


def test_lr_schedule_matches_jax():
    hp = nature2022.copy()
    thp = TorchModelParams(**hp.to_dict())
    for step in (0, 1, 100, 511, 512, 1024, 5000):
        assert ttr.lr_schedule(thp)(step) == pytest.approx(
            float(jtr.lr_schedule(hp)(step)), rel=1e-6)


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_optimizer_matches_optax(name):
    hp = nature2022.copy()
    hp.optimizer = name
    hp.learning_rate, hp.learning_rate_decay_steps = 1e-2, 2
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    tx = jtr.make_optimizer(hp)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(pj)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               pj)
        pj = optax.apply_updates(pj, upd)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = ttr.make_optimizer(TorchModelParams(**hp.to_dict()), pt.values())
    for g in grads:
        for k, t in pt.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        hp.optimizer = "rmsprop"
        ttr.make_optimizer(TorchModelParams(**hp.to_dict()), pt.values())


def test_save_checkpoint_loads_in_jax(tmp_path):
    params, stats, *_ = _state()
    hp = TorchModelParams(**_hp("float32").to_dict())
    model = torch_build_model(hp)
    model.load_state_dict(from_flax(params, stats))
    sub = ttr.save_checkpoint(str(tmp_path), model, hp, 1, "outcome", "lbl",
                              2, outcome_labels=["a", "b"])
    assert sub.endswith("outcome-lbl-HP0-kfold2_epoch1")
    _, jparams, jstats, jhp, meta = jtr.load_checkpoint(sub)
    assert meta["outcome_labels"] == ["a", "b"] and jhp.tile_px == PX
    want_p, want_s = to_flax(model.state_dict())
    for got, want in ((_np_tree(jparams), want_p), (_np_tree(jstats), want_s)):
        got, want = dict(_flat(got)), dict(_flat(want))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    back, _, _ = ttr.load_checkpoint(sub, device="cpu")
    for key, t in model.state_dict().items():
        assert torch.equal(back.state_dict()[key], t)
