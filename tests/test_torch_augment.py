"""The port's augmentation (biscuit_torch/data/augment.py) against the JAX
package's on the same images and the same per-image decisions.

Tolerances: flips, rotations and their dihedral composition are pixel
permutations, so they must agree exactly. The blur sums seven taps twice
in f32 in another order: 1e-5 absolute on standardized inputs. The JPEG
round trip rounds at each stage to integer sample values, so sums that
differ in the last f32 bit can move one rounding by one level: at most
1 level apart, and at most 1 pixel value in 1000 differing at qualities
up to 90. (Above that the tables' small steps put many rounding inputs
on exact halves, which f32 sums in any order miss by a bit either way;
JAX's own results then change with the batch size.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biscuit_torch.data import augment as tau
from biscuit_tpu.data import augment as jau

torch.set_num_threads(1)


def _imgs(seed, n=16, h=12, w=12):
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, 3)).astype(np.float32)


def _decisions(seed, n=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, n).astype(bool),
            rng.integers(0, 2, n).astype(bool),
            rng.integers(0, 4, n))


def test_dihedral_matches_jax():
    x = _imgs(0)
    # Cover all 16 (fx, fy, k) combinations.
    fx, fy, k = (np.arange(16) & 1).astype(bool), \
        (np.arange(16) & 2).astype(bool), np.arange(16) // 4
    want = jau._dihedral_batch(jnp.asarray(x), jnp.asarray(fx),
                               jnp.asarray(fy), jnp.asarray(k))
    got = tau._dihedral_batch(torch.from_numpy(x), torch.from_numpy(fx),
                              torch.from_numpy(fy), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rot90_matches_jax():
    x = _imgs(2)
    k = np.arange(16) % 4
    want = jau._rot90_batch(jnp.asarray(x), jnp.asarray(k))
    got = tau._rot90_batch(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tau._rot90_batch(torch.zeros((1, 4, 5, 3)), torch.zeros(1, dtype=torch.long))


def test_separate_flips_match_jax_on_rectangles():
    """Without 'r' the flips apply one by one, on any shape."""
    x = _imgs(3, h=6, w=10)
    fx, fy, _ = _decisions(4)
    got = tau.apply_augment(torch.from_numpy(x), {
        "fx": torch.from_numpy(fx), "fy": torch.from_numpy(fy)})
    want = np.where(fx[:, None, None, None], x[:, :, ::-1], x)
    want = np.where(fy[:, None, None, None], want[:, ::-1], want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_blur_matches_jax():
    x = _imgs(5, n=8, h=20, w=17)
    rng = np.random.default_rng(6)
    sigma_idx = rng.integers(0, len(jau.BLUR_SIGMAS), 8)
    apply = np.array([True, False] * 4)
    want = jau._blur_batch(jnp.asarray(x), jnp.asarray(sigma_idx),
                           jnp.asarray(apply))
    got = tau._blur_batch(torch.from_numpy(x), torch.from_numpy(sigma_idx),
                          torch.from_numpy(apply))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got.numpy()[1::2], x[1::2])


def test_sampler_and_batch_contract():
    gen = torch.Generator().manual_seed(0)
    d = tau.sample_augment(64, gen, "xyrjb")
    assert set(d) == {"fx", "fy", "k", "blur", "sigma_idx"}
    assert d["fx"].dtype == torch.bool and d["k"].max() <= 3
    assert 0 < d["fx"].sum() < 64 and d["sigma_idx"].max() < 4
    x = torch.from_numpy(_imgs(7, n=64))
    out = tau.augment_batch(x, torch.Generator().manual_seed(1), "xyr")
    # Permutations keep each image's multiset of values.
    np.testing.assert_array_equal(
        np.sort(out.reshape(64, -1).numpy(), axis=1),
        np.sort(x.reshape(64, -1).numpy(), axis=1))
    assert tau.sample_augment(4, gen, "") == {}


def test_jpeg_tables_match_ijg_integer_math():
    q = np.array([1, 25, 49, 50, 51, 75, 99, 100])
    tbl_y, tbl_c = tau.jpeg_tables(torch.from_numpy(q))
    scale = np.where(q < 50, 5000 // q, 200 - 2 * q)[:, None]
    want_y = np.clip((jau._JPEG_LUMA_BASE.reshape(64).astype(np.int64)
                      * scale + 50) // 100, 1, 255)
    want_c = np.clip((jau._JPEG_CHROMA_BASE.reshape(64).astype(np.int64)
                      * scale + 50) // 100, 1, 255)
    np.testing.assert_array_equal(tbl_y.numpy(), want_y)
    np.testing.assert_array_equal(tbl_c.numpy(), want_c)


def _close_levels(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


@pytest.mark.parametrize("q,subsample,shape", [
    (57, True, (3, 40, 36)),     # padded to the 16-pixel MCU
    (90, True, (2, 32, 32)),
    (75, False, (2, 24, 20)),
])
def test_jpeg_matches_jax(q, subsample, shape):
    """prob=1 and quality_range=(q, q+1) make the JAX side deterministic."""
    rng = np.random.default_rng(q)
    x = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    want = jau.jpeg_augment_batch(jnp.asarray(x), jax.random.PRNGKey(0),
                                  prob=1.0, quality_range=(q, q + 1),
                                  subsample=subsample)
    got = tau.jpeg_augment_batch(torch.from_numpy(x),
                                 torch.Generator().manual_seed(0), prob=1.0,
                                 quality_range=(q, q + 1), subsample=subsample)
    assert got.dtype == torch.uint8
    _close_levels(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), x)     # it did re-compress


def test_jpeg_apply_keeps_unselected_images():
    x = np.random.default_rng(9).integers(0, 256, (4, 16, 16, 3),
                                          dtype=np.uint8)
    apply = torch.tensor([True, False, True, False])
    got = tau.jpeg_apply(torch.from_numpy(x), apply,
                         torch.full((4,), 60)).numpy()
    np.testing.assert_array_equal(got[1::2], x[1::2])
    want = jau.jpeg_augment_batch(jnp.asarray(x), jax.random.PRNGKey(0),
                                  prob=1.0, quality_range=(60, 61))
    _close_levels(got[0::2], np.asarray(want)[0::2])
