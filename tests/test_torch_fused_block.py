"""The port's fused strided block (biscuit_torch/ops/fused_block.py): the
weight stacking against the JAX one, the plain version against the JAX
Pallas kernel in interpret mode, and the fully fused trunk
(``fuse_blocks=True``) against the JAX one and against the default
composition.

Tolerances: weight stacking is exact up to f32 rounding of the BN fold
(rtol 1e-6). The plain version and the Pallas kernel share their rounding
points (bf16 before each pointwise product, y0 in f32, y1 in bf16 before
the pool), so only an f32 sum in another order flipping one bf16 rounding
separates them: 1e-2 of the largest value, with bf16 x and with f32 x
(whose residual product both take in f32: the Pallas kernel's jnp.dot of
f32 x and bf16 rw promotes to f32). With f32 x the residual alone (BN1's
scale and shift zero, so y1 and the pool are exact zeros) is held within
1e-5 of its largest value: both sides take an f32 product, where x
rounded to bf16 (within 2**-8 relative) moves it by about 2e-3. The fused trunk
carries the middle flow in f32 and rounds at the kernels' points rather
than Flax's: 3e-2 of the largest feature, and of the largest mean
probability at dropout 0.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from biscuit_torch.hp import ModelParams as TorchModelParams
from biscuit_torch.models.convert import from_flax
from biscuit_torch.models.xception import build_model as torch_build_model
from biscuit_torch.ops.fused_block import (
    fused_strided_block,
    fused_strided_block_reference,
    stack_block_weights,
)
from biscuit_torch.ops.fused_sepconv import trunk_features_fused
from biscuit_torch.train.uq import UncertaintyInterface
from biscuit_tpu.hp import ModelParams
from biscuit_tpu.models.xception import build_model
from biscuit_tpu.ops import fused_block as jfb
from biscuit_tpu.ops.fused_sepconv import (
    trunk_features_fused as jax_trunk_features_fused,
)
from biscuit_tpu.train.trainer import init_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    """xception_tiny with live features: jittered running statistics and
    positive BN shifts, carried to the port by ``from_flax``."""
    hp = ModelParams(model="xception_tiny", tile_px=32, hidden_layer_width=32,
                     compute_dtype="float32", dropout=0.0)
    fmodel = build_model(hp)
    params, stats = init_model(fmodel, hp, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, unfreeze(params))
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(0.05, 0.3, a.shape)).astype(
            np.float32), unfreeze(stats))

    def shift(tree):
        if "scale" in tree:
            tree["bias"] = rng.uniform(0.1, 0.3, tree["bias"].shape).astype(
                np.float32)
            return
        for sub in tree.values():
            if isinstance(sub, dict):
                shift(sub)

    shift(params["backbone"])
    thp = TorchModelParams(**hp.to_dict())
    tmodel = torch_build_model(thp).eval()
    tmodel.load_state_dict(from_flax(params, stats))
    return fmodel, params, stats, tmodel, thp


@pytest.mark.parametrize("block", ["entry1", "exit_block"])
def test_stack_block_weights_matches_jax(tiny, block):
    _, params, stats, tmodel, _ = tiny
    want = jfb.stack_block_weights(params["backbone"][block],
                                   stats["backbone"][block])
    got = stack_block_weights(getattr(tmodel.backbone, block))
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g.dtype == {jnp.float32: torch.float32,
                           jnp.bfloat16: torch.bfloat16}[w.dtype.type]
        w = np.asarray(w.astype(jnp.float32))
        if w.shape[0] == 1:                 # JAX keeps BN vectors as (1, C)
            w = w[0]
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-6,
                                   atol=1e-7)


def _rand_weights(rng, cin, f0, f1):
    """The kernel's weight tuple in numpy: taps, pointwise and residual
    weights (bf16-representable), folded BN scale and shift."""

    def bf(a):
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    def bn(c):
        return (rng.uniform(0.6, 1.4, c).astype(np.float32),
                rng.normal(0, 0.2, c).astype(np.float32))

    dw0 = rng.normal(0, 0.3, (9, cin)).astype(np.float32)
    pw0 = bf(rng.normal(0, cin ** -0.5, (cin, f0)))
    dw1 = rng.normal(0, 0.3, (9, f0)).astype(np.float32)
    pw1 = bf(rng.normal(0, f0 ** -0.5, (f0, f1)))
    rw = bf(rng.normal(0, cin ** -0.5, (cin, f1)))
    return (dw0, pw0, *bn(f0), dw1, pw1, *bn(f1), rw, *bn(f1))


# (H, W, Cin, (F0, F1), relu_first, hs): tests/test_fused_block.py's CASES,
# odd and even H and W, relu_first both ways, F0 != F1; in bf16, and one
# odd geometry with f32 x.
CASES = [
    (14, 14, 8, (8, 16), True, 6, "bfloat16"),
    (13, 13, 8, (8, 16), True, 6, "bfloat16"),
    (16, 13, 8, (16, 16), False, 6, "bfloat16"),
    (19, 19, 16, (16, 24), True, 18, "bfloat16"),
    (12, 18, 8, (8, 24), False, 6, "bfloat16"),
    (13, 13, 8, (8, 16), True, 6, "float32"),
]
CASE_IDS = [f"{h}-{w}-{cin}-f{i}-{relu}-{hs}" + ("" if dt == "bfloat16"
                                                 else "-f32x")
            for i, (h, w, cin, _, relu, hs, dt) in enumerate(CASES)]


@pytest.mark.parametrize("h,w,cin,f,relu_first,hs,dtype", CASES,
                         ids=CASE_IDS)
def test_reference_matches_pallas(h, w, cin, f, relu_first, hs, dtype):
    rng = np.random.default_rng(h * 100 + w)
    x = rng.normal(0, 1.5, (2, h, w, cin)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    wts = _rand_weights(rng, cin, *f)
    bf_idx = (1, 5, 8)
    jw = tuple(jnp.asarray(a, jnp.bfloat16) if i in bf_idx
               else jnp.asarray(a if a.ndim == 2 else a[None, :])
               for i, a in enumerate(wts))
    want = jfb.fused_strided_block(
        jnp.asarray(x, getattr(jnp, dtype)), jw, relu_first=relu_first, hs=hs,
        interpret=True)
    assert want.dtype == getattr(jnp, dtype)
    want = np.asarray(want.astype(jnp.float32))
    tw = tuple(torch.from_numpy(a).to(torch.bfloat16) if i in bf_idx
               else torch.from_numpy(a) for i, a in enumerate(wts))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = fused_strided_block_reference(xt, tw, relu_first)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape == (2, -(-h // 2), -(-w // 2), f[1])
    assert np.abs(got.float().numpy() - want).max() <= 1e-2 * np.abs(want).max()
    # On a CPU tensor the wrapper is the plain version.
    torch.testing.assert_close(fused_strided_block(xt, tw, relu_first), got,
                               rtol=0, atol=0)
    if dtype == "float32":
        zero = np.zeros(f[1], np.float32)
        jw = jw[:6] + (jnp.asarray(zero[None, :]),) * 2 + jw[8:]
        tw = tw[:6] + (torch.from_numpy(zero),) * 2 + tw[8:]
        want = np.asarray(jfb.fused_strided_block(
            jnp.asarray(x), jw, relu_first=relu_first, hs=hs, interpret=True))
        got = fused_strided_block_reference(xt, tw, relu_first).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fully_fused_trunk_matches_jax(tiny):
    fmodel, params, stats, tmodel, _ = tiny
    x = np.random.default_rng(1).normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax_trunk_features_fused(
        fmodel, params, stats, jnp.asarray(x), interpret=True,
        fuse_blocks=True))
    with torch.no_grad():
        got = trunk_features_fused(tmodel, torch.from_numpy(x),
                                   fuse_blocks=True).numpy()
    assert got.shape == want.shape
    assert (want > 0).mean() > 0.5          # live features, not relu'd away
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_interface_with_fused_blocks_matches_default(tiny):
    """At dropout 0 the fully fused trunk's mean probabilities are the
    default composition's, on the CPU through the plain versions."""
    *_, tmodel, thp = tiny
    tmodel = copy.deepcopy(tmodel)
    with torch.no_grad():               # predictions that differ by tile
        for layer in tmodel.head.modules():
            if isinstance(layer, torch.nn.Linear):
                layer.weight.mul_(4.0)
    tiles = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3),
                                              dtype=np.uint8)
    means = {}
    for fuse in (False, True):       # True implies the fused trunk
        ui = UncertaintyInterface.from_model(tmodel, thp, k=2, device="cpu",
                                             fuse_blocks=fuse)
        assert ui._fused == fuse and (ui._block_wts is not None) == fuse
        means[fuse] = ui(tiles)[0].numpy()
    assert np.ptp(means[False][:, 0]) > 2e-2
    assert np.abs(means[True] - means[False]).max() <= 3e-2
    with pytest.raises(ValueError):
        UncertaintyInterface.from_model(tmodel, thp, device="cpu",
                                        fused_trunk=False, fuse_blocks=True)
