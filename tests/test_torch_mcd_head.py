"""Plain version of the port's MC-dropout head kernel
(biscuit_torch/ops/mcd_head.py) against the JAX package, with the three
kinds of parity the frameworks allow (their random streams differ):

* dropout 0 against the Pallas kernel in interpret mode (whose random bits
  are zeros off the TPU, so it is exact only at dropout 0): 1e-4 absolute
  on probabilities, since both sides take bf16 inputs with f32 sums;
* injected keep-masks against a numpy oracle of the same arithmetic
  (float64 sums of the same bf16-rounded operands): 2e-3 absolute, the
  size of one flipped bf16 rounding of a hidden unit;
* sampled dropout against the JAX lax head at large K: 0.03 absolute on
  mean and std, the Monte-Carlo spread at K = 2000.

The Philox stream itself is held to Random123's known answers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from biscuit_torch.models.xception import Head as TorchHead
from biscuit_torch.ops.mcd_head import (
    head_weights,
    mcd_head,
    mcd_head_reference,
    philox4x32_10,
    philox_dropout_bits,
)
from biscuit_tpu.models.xception import Head
from biscuit_tpu.ops.mcd_head import mcd_head_pallas

torch.set_num_threads(1)
F_DIM, HIDDEN = 256, 128


def _flax_head(dropout, n=16, seed=0, classes=2, f_dim=F_DIM):
    head = Head(num_classes=classes, hidden_layers=2, hidden_width=HIDDEN,
                dropout=dropout)
    feats = np.random.default_rng(seed).normal(0, 1, (n, f_dim)).astype(
        np.float32)
    params = head.init({"params": jax.random.PRNGKey(1),
                        "dropout": jax.random.PRNGKey(2)},
                       jnp.asarray(feats))["params"]
    params = jax.tree_util.tree_map(np.asarray, unfreeze(params))
    # Non-zero biases, so a dropped bias would show.
    rng = np.random.default_rng(seed + 1)
    for layer in params.values():
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(
            np.float32)
    return head, params, feats


def _torch_weights(params, dropout):
    f_dim, classes = (params["hidden0"]["kernel"].shape[0],
                      params["logits"]["kernel"].shape[1])
    th = TorchHead(f_dim, classes, 2, HIDDEN, dropout)
    with torch.no_grad():
        for name in ("hidden0", "hidden1", "logits"):
            getattr(th, name).weight.copy_(
                torch.from_numpy(params[name]["kernel"].T.copy()))
            getattr(th, name).bias.copy_(torch.from_numpy(params[name]["bias"]))
    return head_weights(th)


def test_philox_known_answers():
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = philox4x32_10(*(torch.tensor([c]) for c in ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_dropout_bits_layout():
    bits = philox_dropout_bits(seed=(7 << 32) | 5, k=2, layer=1, n=3, h=6)
    assert bits.shape == (2, 3, 6)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    # Element (pass 1, row 2, col 5) is word 1 of counter (1, 2, 1, 1).
    words = philox4x32_10(*(torch.tensor([c]) for c in (1, 2, 1, 1)), 5, 7)
    assert int(bits[1, 2, 5]) == int(words[1])


def test_zero_dropout_matches_pallas():
    head, params, feats = _flax_head(0.0)
    want_m, want_s = mcd_head_pallas(params, jnp.asarray(feats),
                                     jax.random.PRNGKey(0), k=4, dropout=0.0,
                                     interpret=True)
    wts = _torch_weights(params, 0.0)
    got_m, got_s = mcd_head_reference(torch.from_numpy(feats), *wts, k=4,
                                      dropout=0.0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


@pytest.mark.parametrize("classes", [9, 33, 128])
def test_zero_dropout_matches_pallas_wide_heads(classes):
    """Heads of more than 8 classes, which the card's kernel pads to 16,
    64 and 128 classes: the Pallas kernel pads C to its 128-lane tile with -1e9 biases, the plain version takes
    the softmax over the C classes; F = H = 128, logits weights scaled up
    so that the softmax is far from uniform."""
    head, params, feats = _flax_head(0.0, n=8, seed=classes,
                                     classes=classes, f_dim=HIDDEN)
    params["logits"]["kernel"] = params["logits"]["kernel"] * 8
    want_m, want_s = mcd_head_pallas(params, jnp.asarray(feats),
                                     jax.random.PRNGKey(0), k=4, dropout=0.0,
                                     interpret=True)
    got_m, got_s = mcd_head_reference(torch.from_numpy(feats),
                                      *_torch_weights(params, 0.0), k=4,
                                      dropout=0.0)
    assert got_m.shape == (8, classes)
    assert float(np.asarray(want_m).max()) > 2.0 / classes
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


def _bf16(a):
    """Round float arrays to bf16 (nearest even), returned as float64."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def _numpy_oracle(feats, params, keep1, keep2, rate):
    scale = np.float32(1.0 / (1.0 - rate))
    w = {n: _bf16(params[n]["kernel"]) for n in ("hidden0", "hidden1",
                                                  "logits")}
    b = {n: params[n]["bias"].astype(np.float64) for n in w}
    h1 = np.maximum(_bf16(feats) @ w["hidden0"] + b["hidden0"], 0)
    ps = []
    for i in range(keep1.shape[0]):
        h = _bf16(np.where(keep1[i], h1 * scale, 0))
        h = np.maximum(h @ w["hidden1"] + b["hidden1"], 0)
        h = _bf16(np.where(keep2[i], h * scale, 0))
        z = h @ w["logits"] + b["logits"]
        e = np.exp(z - z.max(-1, keepdims=True))
        ps.append(e / e.sum(-1, keepdims=True))
    ps = np.stack(ps)
    return ps.mean(0), ps.std(0)


def test_injected_masks_match_numpy_oracle():
    rate, k = 0.3, 6
    _, params, feats = _flax_head(rate)
    rng = np.random.default_rng(3)
    keep1 = rng.random((k, feats.shape[0], HIDDEN)) >= rate
    keep2 = rng.random((k, feats.shape[0], HIDDEN)) >= rate
    want_m, want_s = _numpy_oracle(feats, params, keep1, keep2, rate)
    got_m, got_s = mcd_head_reference(
        torch.from_numpy(feats), *_torch_weights(params, rate), k=k,
        dropout=rate, keep1=torch.from_numpy(keep1),
        keep2=torch.from_numpy(keep2))
    np.testing.assert_allclose(got_m.numpy(), want_m, atol=2e-3)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=2e-3)


def test_sampled_dropout_matches_lax_statistically():
    rate, k = 0.3, 2000
    head, params, feats = _flax_head(rate, n=8)

    def one(rng):
        logits = head.apply({"params": params}, jnp.asarray(feats),
                            mc_dropout=True, rngs={"dropout": rng})
        return jax.nn.softmax(logits, -1)

    probs = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(9), k))
    got_m, got_s = mcd_head(torch.from_numpy(feats),
                            *_torch_weights(params, rate), k=k, dropout=rate,
                            seed=11)
    assert float(got_s.mean()) > 0.01
    np.testing.assert_allclose(got_m.numpy(), np.asarray(probs.mean(0)),
                               atol=0.03)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(probs.std(0)),
                               atol=0.03)


@pytest.mark.parametrize("n", [13, 1])
def test_unaligned_batches_are_rows_of_the_full_batch(n):
    """The stream is keyed by row, so a batch's rows do not depend on the
    batch size: any prefix gives the same rows."""
    _, params, feats = _flax_head(0.1)
    wts = _torch_weights(params, 0.1)
    full_m, full_s = mcd_head(torch.from_numpy(feats), *wts, k=5,
                              dropout=0.1, seed=3)
    m, s = mcd_head(torch.from_numpy(feats[:n]), *wts, k=5, dropout=0.1,
                    seed=3)
    assert m.shape == (n, 2)
    torch.testing.assert_close(m, full_m[:n], rtol=0, atol=0)
    torch.testing.assert_close(s, full_s[:n], rtol=0, atol=0)
    np.testing.assert_allclose(m.sum(-1).numpy(), 1.0, rtol=1e-6)



# (N, K, C, H) at the edges of the kernel's contract: K of 1 and 2 with
# 8 classes (64 and 32 tiles a block), K above one block's 64 rows (70),
# H not a multiple of the 128-column tile (136, 264), H past what the
# kernel's A operand holds at once (2048), one class; heads of more than
# 8 classes, 9 (padded to 16), 33 (to 64) and 128.
ORACLE_SHAPES = [(13, 1, 8, 136), (13, 2, 8, 136), (7, 7, 2, 128),
                 (5, 30, 5, 136), (3, 33, 2, 136), (3, 70, 5, 136),
                 (2, 30, 8, 2048), (1, 1, 1, 8), (4, 64, 3, 264),
                 (5, 7, 9, 136), (3, 70, 33, 136), (4, 1, 128, 264)]


@pytest.mark.parametrize("n,k,c,h", ORACLE_SHAPES)
def test_seeded_masks_match_numpy_oracle(n, k, c, h):
    """The plain version on its own Philox stream, against the numpy
    oracle given the same stream's keep-masks."""
    rate, seed = 0.2, (3 << 32) | 17
    rng = np.random.default_rng(n * 1000 + k)
    params = {name: {"kernel": rng.normal(0, d ** -0.5, (d, o)).astype(
                         np.float32),
                     "bias": rng.normal(0, 0.1, o).astype(np.float32)}
              for name, d, o in (("hidden0", F_DIM, h), ("hidden1", h, h),
                                 ("logits", h, c))}
    feats = rng.normal(0, 1, (n, F_DIM)).astype(np.float32)
    thresh = int(rate * 2 ** 32)
    keep1, keep2 = (philox_dropout_bits(seed, k, layer, n, h).numpy()
                    >= thresh for layer in (0, 1))
    want_m, want_s = _numpy_oracle(feats, params, keep1, keep2, rate)
    wts = []
    for name in ("hidden0", "hidden1", "logits"):
        wts.append(torch.from_numpy(params[name]["kernel"]).to(torch.bfloat16))
        wts.append(torch.from_numpy(params[name]["bias"]))
    got_m, got_s = mcd_head(torch.from_numpy(feats), *wts, k=k, dropout=rate,
                            seed=seed)
    assert got_m.shape == got_s.shape == (n, c)
    np.testing.assert_allclose(got_m.numpy(), want_m, atol=2e-3)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=2e-3)
