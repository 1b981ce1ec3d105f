"""Separable conv + train-mode BatchNorm unit with a fused backward
(``csrc/fused_unit_bwd.cu``).

Counterpart of ``biscuit_tpu/ops/fused_unit_bwd.py``. The unit, as Flax
trains it (``models/xception.py`` SeparableConv + BatchNorm):

    r  = relu(a)                 (skipped when relu_first=False)
    d  = dwconv3x3_SAME(r, Wdw)  bf16
    p  = conv1x1(d, Wpw)         bf16
    pf = f32(p); mu = mean(pf); var = max(0, mean(pf^2) - mu^2)
    y  = bf16((pf - mu) * rsqrt(var+eps) * gamma + beta)

and its backward:

    g   = f32(gy);  xhat = (pf - mu) * inv
    gp  = gamma*inv * (g - mean(g) - xhat * mean(g*xhat))
    gd  = bf16(gp) @ Wpw^T                    (f32, not rounded)
    dWpw= d^T @ bf16(gp)
    gr  = dwconv3x3_SAME(gd, flip(Wdw))
    dWdw[u,v,c] = sum_{b,i,j} rpad[b,i+u,j+v,c] * gd[b,i,j,c]
    da  = gr * (r > 0)            (gr when relu_first=False)
    dgamma = sum(g*xhat); dbeta = sum(g)

Numerics deviate from Flax autodiff as the JAX module's do: gd stays f32
into the depthwise taps and both weight gradients sum in f32.

Layouts: activations NHWC, as the JAX package keeps them; the depthwise
taps as ``(9, CI)`` f32 in (dy, dx) row-major order and the pointwise
weight as ``(CI, CO)``, which are the JAX ``(3, 3, 1, CI)`` and
``(1, 1, CI, CO)`` kernels without their unit dimensions.

Backends of ``sep_bn_unit``'s backward: ``'auto'`` (the strip kernel),
``'plane'`` or ``'reference'`` (the plain version, named explicitly). The kernel wrappers ``unit_bwd_plane`` and
``unit_bwd_strips`` compute the plain version for CPU tensors; for CUDA
tensors they launch the kernel or raise. Unlike the JAX ``'auto'``,
which keeps XLA's composition on the TPU, ``'auto'`` on the card always
launches the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

PLANE = "unit_bwd_plane"
STRIPS = "unit_bwd_strips"
SOURCE = "fused_unit_bwd"
BACKENDS = ("auto", "plane", "reference")
DEFAULT_HS = 24       # strip height (rows), as the JAX strip kernel's default
PLANE_COLS = 8        # columns per block of the plane kernel's depthwise pass


# ---------------------------------------------------------------- forward

def unit_fwd(a, taps, wpw, gamma, beta, eps: float, relu_first: bool):
    """Forward of the unit on NHWC ``a`` with library convs (cast to a's
    dtype, as Flax casts its f32 kernels). Returns (y, mean, var,
    (r, d, p)); r, d and p are contiguous NHWC."""
    n, h, w, ci = a.shape
    co = wpw.shape[1]
    r = torch.relu(a) if relu_first else a
    wd = taps.t().reshape(ci, 1, 3, 3).to(a.dtype)
    wp = wpw.t().reshape(co, ci, 1, 1).to(a.dtype)
    d = F.conv2d(r.permute(0, 3, 1, 2), wd, padding=1, groups=ci)
    p = F.conv2d(d, wp)
    d = d.permute(0, 2, 3, 1).contiguous()
    p = p.permute(0, 2, 3, 1).contiguous()
    pf = p.float()
    mu = pf.mean(dim=(0, 1, 2))
    mu2 = pf.square().mean(dim=(0, 1, 2))
    var = torch.clamp_min(mu2 - mu.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    y = ((pf - mu) * (inv * gamma.float()) + beta.float()).to(a.dtype)
    return y, mu, var, (r.contiguous(), d, p)


# ---------------------------------------------------------- plain version

def unit_bwd_reference(gy, r, d, p, taps, wpw, gamma, mu, var, eps: float,
                       relu_first: bool):
    """The backward as plain torch ops (the JAX ``unit_bwd_reference``).
    Returns (da, dwdw (9, CI), dwpw (CI, CO), dgamma, dbeta), f32 but da
    in gy's dtype."""
    n, h, w, ci = r.shape
    inv = torch.rsqrt(var.float() + eps)
    g = gy.float()
    pf = p.float()
    xhat = (pf - mu) * inv
    m = n * h * w
    sum_g = g.sum(dim=(0, 1, 2))
    sum_gx = (g * xhat).sum(dim=(0, 1, 2))
    gp = (gamma.float() * inv) * (g - sum_g / m - xhat * (sum_gx / m))
    cdt = gy.dtype
    gpb = gp.to(cdt).float().reshape(m, -1)
    wpw_c = wpw.to(cdt).float()
    gd = (gpb @ wpw_c.t()).reshape(n, h, w, ci)
    dwpw = d.to(cdt).float().reshape(m, ci).t() @ gpb
    wt = taps.float()
    gdpad = F.pad(gd, (0, 0, 1, 1, 1, 1))
    gr = torch.zeros_like(gd)
    for u in range(3):
        for v in range(3):
            gr = gr + gdpad[:, u:u + h, v:v + w, :] * wt[(2 - u) * 3 + (2 - v)]
    rpad = F.pad(r.float(), (0, 0, 1, 1, 1, 1))
    dwdw = torch.stack([
        (rpad[:, u:u + h, v:v + w, :] * gd).sum(dim=(0, 1, 2))
        for u in range(3) for v in range(3)])
    if relu_first:
        gr = gr * (r > 0)
    return gr.to(cdt), dwdw, dwpw, sum_gx, sum_g


# ---------------------------------------------------------------- kernels

def _scratch(m: int, ci: int, co: int):
    """(bn_rows, bn_partials, wg_chunk, wg_splits) of one launch: at most
    1024 row blocks for the BN sums, and enough pixel splits of the
    weight-gradient GEMM for about four blocks per SM of 132."""
    bn_rows = max(64, -(-m // 1024))
    tiles = -(-ci // 128) * -(-co // 128)
    splits = max(1, min(-(-528 // tiles), -(-m // 256)))
    wg_chunk = -(-(-(-m // splits)) // 64) * 64
    return bn_rows, -(-m // bn_rows), wg_chunk, -(-m // wg_chunk)


def _launch(name, gy, r, d, p, taps, wpw, gamma, mu, var, eps, relu_first,
            hs=None):
    n, h, w, ci = r.shape
    co = gy.shape[-1]
    dev = gy.device
    for t_name, t, shape in (("gy", gy, (n, h, w, co)), ("p", p, (n, h, w, co)),
                             ("r", r, (n, h, w, ci)), ("d", d, (n, h, w, ci))):
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {t_name} must be {shape} bf16, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous on {dev}")
    if ci % 8 or co % 8:
        raise ValueError(f"{name}: needs CI % 8 == CO % 8 == 0, got CI={ci}, "
                         f"CO={co}")
    for t_name, t, shape in (("taps", taps, (9, ci)), ("wpw", wpw, (ci, co)),
                             ("gamma", gamma, (co,)), ("mu", mu, (co,)),
                             ("var", var, (co,))):
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: {t_name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    m = n * h * w
    wflip = taps.detach().float().flip(0).contiguous()
    wpwt = wpw.detach().t().to(torch.bfloat16).contiguous()      # (CO, CI)
    gamma32, mu32, var32 = (t.detach().float().contiguous()
                            for t in (gamma, mu, var))
    # The kernels read the activations in 16-byte vectors.
    for t_name, t in (("gy", gy), ("p", p), ("r", r), ("d", d),
                      ("gamma", gamma32), ("mu", mu32), ("var", var32)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must start on a 16-byte "
                             f"boundary (a view at an offset does not)")
    bn_rows, p_bn, wg_chunk, splits = _scratch(m, ci, co)
    # Depthwise-backward blocks per image: column tiles of the plane
    # kernel, or row strips of the strip kernel.
    tiles = -(-w // PLANE_COLS) if hs is None else -(-h // hs)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    da = torch.empty_like(r)
    dwdw, dwpw, dgamma, dbeta = f32(9, ci), f32(ci, co), f32(co), f32(co)
    bn_part, sums, vec = f32(p_bn, 2, co), f32(2, co), f32(5, co)
    gpb = torch.empty((m, co), dtype=torch.bfloat16, device=dev)
    gd = f32(m, ci)
    wg_part, dw_part = f32(splits, ci, co), f32(n * tiles, 9, ci)
    fn = getattr(_build.load(SOURCE), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    rc = fn(*(_build.ptr(t) for t in (gy, p, r, d, wflip, wpwt, gamma32,
                                      mu32, var32)),
            float(eps),
            *(_build.ptr(t) for t in (da, dwdw, dwpw, dgamma, dbeta, bn_part,
                                      sums, vec, gpb, gd, wg_part, dw_part)),
            n, h, w, ci, co, int(bool(relu_first)), bn_rows, wg_chunk,
            PLANE_COLS if hs is None else int(hs),
            dev.index or 0, _build.stream_ptr(gy))
    _build.check(rc, name)
    _build.count_launch(name)
    return da, dwdw, dwpw, dgamma, dbeta


def unit_bwd_plane(gy, r, d, p, taps, wpw, gamma, mu, var, eps: float,
                   relu_first: bool):
    """Fused unit backward, whole-plane kernel (counterpart of
    ``unit_bwd_pallas``). NHWC in and out; returns (da, dwdw (9, CI),
    dwpw (CI, CO), dgamma, dbeta)."""
    if not gy.is_cuda:
        return unit_bwd_reference(gy, r, d, p, taps, wpw, gamma, mu, var,
                                  eps, relu_first)
    return _launch(PLANE, gy, r, d, p, taps, wpw, gamma, mu, var, eps,
                   relu_first)


def unit_bwd_strips(gy, r, d, p, taps, wpw, gamma, mu, var, eps: float,
                    relu_first: bool, hs: int = DEFAULT_HS):
    """Fused unit backward, strips of ``hs`` rows with halo rows
    (counterpart of ``unit_bwd_pallas_strips``). NHWC in and out; returns
    (da, dwdw (9, CI), dwpw (CI, CO), dgamma, dbeta)."""
    if hs < 1:
        raise ValueError(f"strip height must be >= 1, got {hs}")
    if not gy.is_cuda:
        return unit_bwd_reference(gy, r, d, p, taps, wpw, gamma, mu, var,
                                  eps, relu_first)
    return _launch(STRIPS, gy, r, d, p, taps, wpw, gamma, mu, var, eps,
                   relu_first, hs)


_BWD = {"auto": unit_bwd_strips, "plane": unit_bwd_plane,
        "reference": unit_bwd_reference}


# ------------------------------------------------------------- autograd

class _SepBnUnit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, taps, wpw, gamma, beta, eps, relu_first, backend):
        y, mu, var, (r, d, p) = unit_fwd(a.contiguous(), taps, wpw, gamma,
                                         beta, eps, relu_first)
        ctx.save_for_backward(r, d, p, taps, wpw, gamma, mu, var)
        ctx.eps, ctx.relu_first, ctx.backend = eps, relu_first, backend
        ctx.mark_non_differentiable(mu, var)
        return y, mu, var

    @staticmethod
    def backward(ctx, gy, _gmu, _gvar):
        r, d, p, taps, wpw, gamma, mu, var = ctx.saved_tensors
        da, dwdw, dwpw, dgamma, dbeta = _BWD[ctx.backend](
            gy.contiguous(), r, d, p, taps, wpw, gamma, mu, var, ctx.eps,
            ctx.relu_first)
        return (da, dwdw.to(taps.dtype), dwpw.to(wpw.dtype),
                dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None,
                None)


def sep_bn_unit(a, taps, wpw, gamma, beta, eps: float, relu_first: bool,
                backend: str = "auto"):
    """relu? -> depthwise 3x3 -> pointwise 1x1 -> train-mode BatchNorm on
    NHWC ``a``, with the fused backward. Returns (y, batch mean, batch
    var); mean and var feed the running-statistics update and are not
    differentiated (their cotangents are ignored, as in the JAX
    ``sep_bn_unit``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return _SepBnUnit.apply(a, taps, wpw, gamma, beta, eps, relu_first,
                            backend)
