"""The port's fused sep+BN unit (biscuit_torch/ops/fused_unit_bwd.py)
against the JAX module on the same seeded inputs.

Layers of evidence, as tests/test_fused_unit_bwd.py has them for JAX:
  1. unit_fwd: the port's library-conv forward against JAX's;
  2. unit_bwd_reference (the plain version) against JAX's reference, and
     the CPU wrappers unit_bwd_plane / unit_bwd_strips against the Pallas
     kernels in interpret mode at the JAX tests' own shapes, including
     the ragged multi-strip case;
  3. the autograd.Function's gradients against torch autograd of
     unit_fwd in f32.

Tolerances, as max |diff| over the largest |value| of each tensor:
f32 1e-5 (the same arithmetic in another summation order); bf16 2e-4 for
the weight and BN gradients and 1e-3 for da, whose bf16 rounding of gp
(one ulp of gd) can flip on a ~1e-7 difference of the f32 sums, as the
JAX tests state for the strip kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biscuit_torch.ops import _build
from biscuit_torch.ops import fused_unit_bwd as tub
from biscuit_tpu.ops import fused_unit_bwd as fub

torch.set_num_threads(1)
EPS = 1e-5
NAMES = ("da", "dwdw", "dwpw", "dgamma", "dbeta")


def make_unit(seed, n, h, w, ci, co):
    """f32 numpy inputs: a, taps (9, CI), wpw (CI, CO), gamma, beta, gy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((n, h, w, ci)).astype(f),
            (rng.standard_normal((9, ci)) * 0.2).astype(f),
            (rng.standard_normal((ci, co)) * 0.2).astype(f),
            (rng.standard_normal(co) * 0.1 + 1.0).astype(f),
            (rng.standard_normal(co) * 0.1).astype(f),
            rng.standard_normal((n, h, w, co)).astype(f))


def to_jax(x, dt):
    return jnp.asarray(x, dt)


def to_torch(x, dt):
    return torch.from_numpy(np.array(x, np.float32)).to(dt)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def relerr(got, want):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def jax_residuals(a, taps, wpw, gamma, beta, relu_first, dt):
    """JAX unit_fwd; returns its (mu, var, r, d, p) as numpy f32."""
    ci, co = wpw.shape
    _, mu, var, (r, d, p) = fub.unit_fwd(
        to_jax(a, dt), jnp.asarray(taps.reshape(3, 3, 1, ci)),
        jnp.asarray(wpw.reshape(1, 1, ci, co)), jnp.asarray(gamma),
        jnp.asarray(beta), EPS, relu_first)
    return tuple(np32(t) for t in (mu, var, r, d, p))


def jax_bwd(fn, gy, taps, wpw, gamma, res, relu_first, dt, **kw):
    ci, co = wpw.shape
    mu, var, r, d, p = res
    out = fn(to_jax(gy, dt), to_jax(r, dt), to_jax(d, dt), to_jax(p, dt),
             jnp.asarray(taps.reshape(3, 3, 1, ci)),
             jnp.asarray(wpw.reshape(1, 1, ci, co)), jnp.asarray(gamma),
             jnp.asarray(mu), jnp.asarray(var), EPS, relu_first, **kw)
    da, dwdw, dwpw, dgamma, dbeta = out
    return (da, np32(dwdw).reshape(9, ci), np32(dwpw).reshape(ci, co),
            dgamma, dbeta)


def torch_bwd(fn, gy, taps, wpw, gamma, res, relu_first, dt, **kw):
    mu, var, r, d, p = res
    return fn(to_torch(gy, dt), to_torch(r, dt), to_torch(d, dt),
              to_torch(p, dt), torch.from_numpy(taps), torch.from_numpy(wpw),
              torch.from_numpy(gamma), torch.from_numpy(mu),
              torch.from_numpy(var), EPS, relu_first, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_first", [True, False])
def test_unit_fwd_matches_jax(dtype, relu_first):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    a, taps, wpw, gamma, beta, _ = make_unit(4, 4, 9, 7, 8, 16)
    ci, co = wpw.shape
    yj, muj, varj, (rj, dj, pj) = fub.unit_fwd(
        to_jax(a, jdt), jnp.asarray(taps.reshape(3, 3, 1, ci)),
        jnp.asarray(wpw.reshape(1, 1, ci, co)), jnp.asarray(gamma),
        jnp.asarray(beta), EPS, relu_first)
    y, mu, var, (r, d, p) = tub.unit_fwd(
        to_torch(a, tdt), torch.from_numpy(taps), torch.from_numpy(wpw),
        torch.from_numpy(gamma), torch.from_numpy(beta), EPS, relu_first)
    assert y.dtype == tdt and y.is_contiguous()
    # f32: sum order only. bf16: both round d and p to bf16 after f32
    # sums in another order, so one rounding may flip (2**-8 relative).
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, want in ((r, rj), (d, dj), (p, pj), (mu, muj), (var, varj),
                      (y, yj)):
        assert relerr(got, want) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_first", [True, False])
def test_reference_matches_jax_reference(dtype, relu_first):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    a, taps, wpw, gamma, beta, gy = make_unit(0, 4, 9, 7, 8, 16)
    res = jax_residuals(a, taps, wpw, gamma, beta, relu_first, jdt)
    want = jax_bwd(fub.unit_bwd_reference, gy, taps, wpw, gamma, res,
                   relu_first, jdt)
    got = torch_bwd(tub.unit_bwd_reference, gy, taps, wpw, gamma, res,
                    relu_first, tdt)
    assert got[0].dtype == tdt
    for name, g, w in zip(NAMES, got, want):
        tol = 1e-5 if dtype == "float32" else (1e-3 if name == "da" else 2e-4)
        assert relerr(g, w) < tol, name


# (case, N, H, W, CI, CO, hs): the JAX tests' small plane and strip
# shapes, and H = 19 in strips of 6 (the last one row, ragged) over 16
# images, which exercises the halo rows at both edges.
CASES = [("plane", 4, 9, 7, 8, 16, None),
         ("strips", 4, 9, 7, 8, 16, 3),
         ("strips_ragged", 16, 19, 13, 8, 16, 6)]


@pytest.mark.parametrize("case,n,h,w,ci,co,hs", CASES,
                         ids=[c[0] for c in CASES])
def test_cpu_wrappers_match_pallas_interpret(case, n, h, w, ci, co, hs):
    relu_first = case != "strips"
    a, taps, wpw, gamma, beta, gy = make_unit(7, n, h, w, ci, co)
    res = jax_residuals(a, taps, wpw, gamma, beta, relu_first, jnp.bfloat16)
    if hs is None:
        want = jax_bwd(fub.unit_bwd_pallas, gy, taps, wpw, gamma, res,
                       relu_first, jnp.bfloat16, interpret=True)
        got = torch_bwd(tub.unit_bwd_plane, gy, taps, wpw, gamma, res,
                        relu_first, torch.bfloat16)
    else:
        want = jax_bwd(fub.unit_bwd_pallas_strips, gy, taps, wpw, gamma, res,
                       relu_first, jnp.bfloat16, hs=hs, interpret=True)
        got = torch_bwd(tub.unit_bwd_strips, gy, taps, wpw, gamma, res,
                        relu_first, torch.bfloat16, hs=hs)
    for name, g, wnt in zip(NAMES, got, want):
        assert np.isfinite(np32(g)).all(), name
        assert relerr(g, wnt) < (1e-3 if name == "da" else 2e-4), name


def test_cpu_wrappers_compute_the_plain_version():
    """A CPU tensor takes the plain version, and no kernel is counted."""
    a, taps, wpw, gamma, beta, gy = make_unit(3, 2, 5, 6, 8, 8)
    res = jax_residuals(a, taps, wpw, gamma, beta, True, jnp.bfloat16)
    before = _build.launch_counts()
    ref = torch_bwd(tub.unit_bwd_reference, gy, taps, wpw, gamma, res, True,
                    torch.bfloat16)
    for fn in (tub.unit_bwd_plane, tub.unit_bwd_strips):
        got = torch_bwd(fn, gy, taps, wpw, gamma, res, True, torch.bfloat16)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert _build.launch_counts() == before


@pytest.mark.parametrize("relu_first", [True, False])
def test_autograd_function_matches_autograd_f32(relu_first):
    a, taps, wpw, gamma, beta, gy = make_unit(5, 3, 8, 6, 8, 16)
    leaves = [torch.from_numpy(t).requires_grad_()
              for t in (a, taps, wpw, gamma, beta)]
    g = torch.from_numpy(gy)
    y, mu, var = tub.sep_bn_unit(*leaves, EPS, relu_first)
    assert not mu.requires_grad and not var.requires_grad
    got = torch.autograd.grad((y * g).sum(), leaves)
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves]
    y2 = tub.unit_fwd(*leaves2, EPS, relu_first)[0]
    want = torch.autograd.grad((y2 * g).sum(), leaves2)
    assert torch.equal(y.detach(), y2.detach())
    for name, gg, ww in zip(NAMES, got, want):
        assert relerr(gg, ww) < 2e-5, name


def test_sep_bn_unit_rejects_unknown_backend():
    a, taps, wpw, gamma, beta, _ = make_unit(1, 1, 3, 3, 8, 8)
    with pytest.raises(ValueError):
        tub.sep_bn_unit(*(torch.from_numpy(t) for t in
                          (a, taps, wpw, gamma, beta)), EPS, True, "pallas")


# (H = W, CI, CO) of the 34 sep+BN units of Xception-299 in the order the
# trunk runs them: entry blocks 0-2 at 147, 74 and 37 px, the 24 middle
# units and the exit block at 19 px, the exit sepconvs at 10 px.
XCEPTION_299_UNITS = ([(147, 64, 128), (147, 128, 128), (74, 128, 256),
                       (74, 256, 256), (37, 256, 728), (37, 728, 728)]
                      + [(19, 728, 728)] * 24
                      + [(19, 728, 728), (19, 728, 1024), (10, 1024, 1536),
                         (10, 1536, 2048)])


@pytest.mark.parametrize("hs", [None, tub.DEFAULT_HS], ids=["plane", "strips"])
@pytest.mark.parametrize("batch", [128, 32])
def test_launch_plan_fits_the_card(batch, hs):
    """The kernels' launch plan at every Xception-299 unit: grids within
    65535 a dimension, non-empty scratch, shared memory within a block's
    227 KB, and the limits the CUDA source checks. The kernels launch
    these fields as they are."""
    assert len(XCEPTION_299_UNITS) == 34
    for hw, ci, co in XCEPTION_299_UNITS:
        plan = tub.launch_plan(batch, hw, hw, ci, co, hs)
        where = (batch, hw, ci, co, hs)
        assert len(plan["ints"]) == len(tub.PLAN_FIELDS), where
        for name in tub.GRID_FIELDS:
            assert 1 <= plan[name] <= 65535, (where, name, plan[name])
        for name, shape in plan["scratch"].items():
            assert all(s >= 1 for s in shape), (where, name, shape)
        for name in tub.SMEM_FIELDS:
            assert 0 < plan[name] <= tub.SMEM_LIMIT, (where, name, plan[name])
        m = batch * hw * hw
        assert 1 <= plan["bn_tx"] <= 32, where
        assert plan["bn_gx"] * plan["bn_tx"] * 8 >= co, where
        assert plan["bn_parts"] * plan["bn_rows"] >= m, where
        assert plan["fin_grid"] * 32 >= co, where
        assert plan["wg_chunk"] % 64 == 0, where
        assert (plan["wg_splits"] - 1) * plan["wg_chunk"] < m, where
        assert plan["wg_splits"] * plan["wg_chunk"] >= m, where
        for g, a_tile, rows, cols, splits in (
                ("dg", 2 * tub.GEMM_TILE, m, ci, 1),
                ("wg", tub.GEMM_TILE, ci, co, plan["wg_splits"])):
            bn, cm = plan[f"{g}_bn"], plan[f"{g}_cluster"]
            stages, grid = plan[f"{g}_stages"], plan[f"{g}_grid"]
            assert bn in (64, 128, 256) and cm in (1, 2), (where, g)
            # A ring of at least two stages (16 at most: the barriers'
            # room), its shared memory as csrc/sepconv_gemm.cuh lays it out.
            assert 2 <= stages <= 16, (where, g, stages)
            stage = a_tile + tub._cdiv(bn, 64) * tub.GEMM_BOX
            assert plan[f"{g}_smem"] == tub.GEMM_FIXED + stages * stage
            # A persistent grid of whole clusters, one block an SM, no more
            # clusters than work items.
            items = (tub._cdiv(tub._cdiv(rows, 128), cm) * tub._cdiv(cols, bn)
                     * splits)
            assert grid % cm == 0 and grid <= 132, (where, g, grid)
            assert 1 <= grid // cm <= items, (where, g, grid, items)
        assert 2 <= plan["dw_ring"] <= 16, where
        assert plan["dw_consumers"] % 32 == 0, where
        cpt = plan["dw_cpt"]
        assert plan["dw_consumers"] <= tub.DW_MAX_CONSUMERS[cpt], where
        assert plan["dw_cb"] % 8 == 0, where
        assert plan["dw_cb"] <= 2 * tub.DW_MAX_CONSUMERS[cpt], where
        assert plan["dw_ncs"] * plan["dw_cb"] >= ci, where
        assert plan["dw_cpt"] in (1, 2) and plan["dw_wt"] % plan["dw_cpt"] == 0
        assert (plan["dw_wt"] // plan["dw_cpt"] * plan["dw_cb"] // 2
                <= plan["dw_consumers"]), where
        assert plan["dw_nwr"] * plan["dw_wt"] >= hw, where
        rows = hw if hs is None else hs
        assert plan["dw_rows"] == rows, where
        assert plan["dw_nstrips"] == -(-hw // rows), where
        items = plan["dw_nwr"] * batch * plan["dw_nstrips"]
        assert 1 <= plan["dw_grid"] <= items, where
        assert plan["dw_blocks"] == plan["dw_ncs"] * plan["dw_grid"], where
        # One dWdw partial a block of a channel slice.
        assert plan["scratch"]["dw_part"] == (plan["dw_grid"], 9, ci), where
