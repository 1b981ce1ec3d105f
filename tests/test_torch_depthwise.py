"""The port's standalone depthwise 3x3 (biscuit_torch/ops/depthwise.py)
against the JAX Pallas kernel in interpret mode and its custom VJP.

Tolerances: both sides take nine f32 taps in the same (dy, dx) order from
zero, each product and sum rounded on its own, so the f32 forward and the
input gradient agree to f32 rounding (2e-6 of the largest value) and the
bf16 ones to one bf16 ulp of each value (only a rounding tie broken by a
last f32 bit could differ). The filter gradient is a sum over N*H*W
products in another order on each side: 1e-5 of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biscuit_torch.ops.depthwise import (
    depthwise_conv3x3,
    depthwise_conv3x3_reference,
)
from biscuit_tpu.ops import depthwise_pallas as jdw

torch.set_num_threads(1)

# (N, H, W, C, filter shape): odd and even sizes, both filter layouts.
SHAPES = [(2, 7, 9, 8, (3, 3, 1, 8)), (1, 6, 4, 12, (3, 3, 12)),
          (3, 5, 5, 3, (3, 3, 1, 3))]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, kshape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    k = rng.normal(0, 0.3, kshape).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    return x, k, g


def _bf16_ulp(v):
    """One bf16 ulp at each value (8 significant bits)."""
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1), e - 8)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,h,w,c,kshape", SHAPES)
def test_forward_matches_pallas(n, h, w, c, kshape, dtype):
    tdt, jdt = DTYPES[dtype]
    x, k, _ = _inputs((n, h, w, c), kshape)
    want = jdw.depthwise_conv3x3(jnp.asarray(x, jdt), jnp.asarray(k), True)
    xt = torch.from_numpy(x).to(tdt)
    got = depthwise_conv3x3(xt, torch.from_numpy(k))
    assert got.dtype == tdt
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    # On a CPU tensor the op's forward is the plain version.
    ref = depthwise_conv3x3_reference(xt, torch.from_numpy(k))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# The JAX VJP gives the filter gradient as (3, 3, 1, C) whatever the
# filter's layout, so the gradients are compared on that layout.
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,h,w,c,kshape", [(2, 7, 9, 8, (3, 3, 1, 8)),
                                            (1, 6, 4, 12, (3, 3, 1, 12))])
def test_gradients_match_jax_vjp(n, h, w, c, kshape, dtype):
    tdt, jdt = DTYPES[dtype]
    x, k, g = _inputs((n, h, w, c), kshape, seed=1)
    _, vjp = jax.vjp(lambda a, b: jdw.depthwise_conv3x3(a, b, True),
                     jnp.asarray(x, jdt), jnp.asarray(k))
    want_dx, want_dk = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = depthwise_conv3x3(xt, kt)
    dx, dk = torch.autograd.grad(y, (xt, kt), torch.from_numpy(g).to(tdt))
    assert dx.dtype == tdt and dk.shape == kt.shape
    _close(dx.float().numpy(), np.asarray(want_dx.astype(jnp.float32)), dtype)
    want_dk = np.asarray(want_dk, np.float32)
    assert np.abs(dk.numpy() - want_dk).max() <= 1e-5 * np.abs(want_dk).max()


def test_rejects_a_filter_that_is_not_3x3():
    x = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError):
        depthwise_conv3x3(x, torch.zeros((5, 5, 1, 8)))
