"""Plain version of the port's fused preprocessing kernel
(biscuit_torch/ops/fused_preprocess.py) against the JAX Pallas kernel in
interpret mode, f32 out; the kernel's launch plan and its coefficient
cache, which the CPU reaches.

Tolerance: 5e-5 of the largest value, the bound the JAX package's own test
holds its kernel to against the exact chain (per-image f32 reductions in
another order; the log/exp sandwich amplifies the last ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biscuit_torch.data.normalize import ReinhardFastNormalizer as TNorm
from biscuit_torch.ops.fused_preprocess import (
    CLUSTERS,
    SMEM_LIMIT,
    coefficients,
    fused_preprocess,
    fused_preprocess_reference,
    launch_plan,
    smem_bytes,
)
from biscuit_tpu.data.normalize import ReinhardFastNormalizer as JNorm
from biscuit_tpu.ops.fused_preprocess import fused_preprocess as jax_fused

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,fit", [((2, 32, 32, 3), False),
                                       ((2, 37, 41, 3), True),
                                       ((1, 299, 299, 3), True)])
def test_reference_matches_pallas(shape, fit):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    jnorm, tnorm = JNorm(), TNorm()
    if fit:
        target = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        jnorm.fit(target)
        tnorm = TNorm(np.asarray(jnorm.target_means),
                      np.asarray(jnorm.target_stds))
    want = np.asarray(jax_fused(jnp.asarray(x), jnorm, out_dtype=jnp.float32,
                                interpret=True))
    got = fused_preprocess_reference(torch.from_numpy(x), tnorm).numpy()
    assert np.abs(got - want).max() <= 5e-5 * np.abs(want).max()


def test_wrapper_on_cpu_is_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 16, 16, 3), dtype=np.uint8))
    torch.testing.assert_close(fused_preprocess(x, None, torch.float32),
                               fused_preprocess_reference(x, None),
                               rtol=0, atol=0)
    assert fused_preprocess(x).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        fused_preprocess(x[..., :2])


# (N, H, W, cluster the plan must take): the serving batch and one tile at
# 299 px, the ragged 37 x 41 and a 1 x 3 image, both too small to split.
@pytest.mark.parametrize("n,h,w,cluster", [(256, 299, 299, 16),
                                           (1, 299, 299, 16),
                                           (3, 37, 41, 1), (2, 1, 3, 1)])
def test_launch_plan_owns_every_pixel_once(n, h, w, cluster):
    plan = launch_plan(n, h, w)
    assert plan.cluster == cluster and plan.cluster in CLUSTERS
    assert plan.grid == n * plan.cluster
    owner = np.zeros(h * w, np.int64)
    for p0, p1 in plan.ranges:
        assert 0 <= p0 <= p1 <= h * w
        owner[p0:p1] += 1
    assert (owner == 1).all()
    assert max(p1 - p0 for p0, p1 in plan.ranges) <= plan.chunk
    assert smem_bytes(plan.chunk) == plan.smem <= SMEM_LIMIT
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0


def test_launch_plan_sizes_and_limits():
    # A forced cluster of 8 at 299 px: about 134 KB a CTA, one an SM.
    plan = launch_plan(256, 299, 299, cluster=8)
    assert (plan.chunk, plan.smem, plan.threads) == (11_176, 134_144, 1024)
    assert launch_plan(1, 512, 512).smem <= SMEM_LIMIT
    with pytest.raises(ValueError):
        launch_plan(1, 600, 600)        # beyond 16 CTAs of shared memory
    with pytest.raises(ValueError):
        launch_plan(1, 299, 299, cluster=3)
    with pytest.raises(ValueError):
        launch_plan(1, 299, 299, cluster=2)   # 536 KB a CTA


def test_coefficients_are_made_once_per_targets_and_device():
    norm = TNorm()
    first = coefficients(norm, "cpu")
    assert coefficients(norm, torch.device("cpu")) is first
    assert coefficients(TNorm(), "cpu") is first       # same targets
    assert coefficients(None, "cpu") is first           # the defaults
    assert first.dtype == torch.float32 and first.shape == (42,)
    target = np.random.default_rng(2).integers(0, 256, (16, 16, 3),
                                               dtype=np.uint8)
    norm.fit(target)
    refit = coefficients(norm, "cpu")
    assert refit is not first
    torch.testing.assert_close(refit[-6:-3], norm.target_means, rtol=0,
                               atol=0)
    torch.testing.assert_close(refit[-3:], norm.target_stds, rtol=0, atol=0)
    assert coefficients(norm, "cpu") is refit
