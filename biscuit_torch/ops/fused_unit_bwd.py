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

Under lockstep data parallelism (``group``, ``parallel/lockstep.py``)
the BatchNorm statistics are the group's, as under the JAX package's jit
over a sharded batch: ``unit_fwd`` all-reduces its f32 (sum p, sum p^2),
and the backward takes mean(g) and mean(g*xhat) over every rank's pixels.
It is then split at the BN sums: ``unit_bwd_sums`` gives this rank's
(2, CO) f32 (sum g, sum g*xhat), the group all-reduces it, and the
backward runs from the summed vector and the group's pixel count m
(``sums=``, ``m=``; the kernel's second entry). That entry, and its plain
version, return no dgamma and dbeta (None): a rank's share of them is its
own (sum g*xhat, sum g), which ``sep_bn_unit`` under a group returns, so
that the gradient all-reduce of the step counts each rank's share once.
At one rank the two entries give the one-call kernel's outputs bit for
bit; one unit backward counts one launch either way, taken by the entry
that finishes it.

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
from .bn_train import bn_apply, group_sums

PLANE = "unit_bwd_plane"
STRIPS = "unit_bwd_strips"
SOURCE = "fused_unit_bwd"
BACKENDS = ("auto", "plane", "reference")
DEFAULT_HS = 24       # strip height (rows), as the JAX strip kernel's default


# ---------------------------------------------------------------- forward

def unit_fwd(a, taps, wpw, gamma, beta, eps: float, relu_first: bool,
             group=None):
    """Forward of the unit on NHWC ``a`` with library convs (cast to a's
    dtype, as Flax casts its f32 kernels) and the BatchNorm tail of
    ``ops/bn_train`` (its sums and forward-apply kernels on the card).
    Returns (y, mean, var, (r, d, p)); r, d and p are contiguous NHWC.
    With a ``group`` of several ranks, mean and var are over every rank's
    pixels."""
    n, h, w, ci = a.shape
    co = wpw.shape[1]
    r = torch.relu(a) if relu_first else a
    wd = taps.t().reshape(ci, 1, 3, 3).to(a.dtype)
    wp = wpw.t().reshape(co, ci, 1, 1).to(a.dtype)
    d = F.conv2d(r.permute(0, 3, 1, 2), wd, padding=1, groups=ci)
    p = F.conv2d(d, wp)
    d = d.permute(0, 2, 3, 1).contiguous()
    p = p.permute(0, 2, 3, 1).contiguous()
    _, sums, m = group_sums(p, group)
    y, mu, var = bn_apply(p, gamma, beta, eps, sums, m)
    return y, mu, var, (r.contiguous(), d, p)


# ---------------------------------------------------------- plain version

def unit_bwd_sums_reference(gy, p, mu, var, eps: float):
    """(2, CO) f32 (sum g, sum g*xhat) over the pixels of gy and p, the
    plain version of ``unit_bwd_sums``."""
    g = gy.float()
    xhat = (p.float() - mu) * torch.rsqrt(var.float() + eps)
    return torch.stack([g.sum(dim=(0, 1, 2)), (g * xhat).sum(dim=(0, 1, 2))])


def unit_bwd_reference(gy, r, d, p, taps, wpw, gamma, mu, var, eps: float,
                       relu_first: bool, sums=None, m=None):
    """The backward as plain torch ops (the JAX ``unit_bwd_reference``).
    Returns (da, dwdw (9, CI), dwpw (CI, CO), dgamma, dbeta), f32 but da
    in gy's dtype. ``sums`` (2, CO), with ``m``: the BN sums and pixel
    count of a group (see the module docstring), else this call's; with
    them dgamma and dbeta are None."""
    n, h, w, ci = r.shape
    inv = torch.rsqrt(var.float() + eps)
    g = gy.float()
    pf = p.float()
    xhat = (pf - mu) * inv
    if sums is None:
        m = n * h * w
        sum_g = g.sum(dim=(0, 1, 2))
        sum_gx = (g * xhat).sum(dim=(0, 1, 2))
    else:
        sum_g, sum_gx = sums.float()
    gp = (gamma.float() * inv) * (g - sum_g / m - xhat * (sum_gx / m))
    cdt = gy.dtype
    pixels = n * h * w
    gpb = gp.to(cdt).float().reshape(pixels, -1)
    wpw_c = wpw.to(cdt).float()
    gd = (gpb @ wpw_c.t()).reshape(n, h, w, ci)
    dwpw = d.to(cdt).float().reshape(pixels, ci).t() @ gpb
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
    if sums is not None:
        return gr.to(cdt), dwdw, dwpw, None, None
    return gr.to(cdt), dwdw, dwpw, sum_gx, sum_g


# ---------------------------------------------------------------- kernels

# The launch plan's fields, in the order csrc/fused_unit_bwd.cu reads them.
PLAN_FIELDS = ("bn_tx", "bn_gx", "bn_rows", "bn_parts", "fin_grid",
               "dg_bn", "dg_stages", "dg_smem", "dg_grid", "dg_cluster",
               "wg_bn", "wg_stages", "wg_smem", "wg_grid", "wg_splits",
               "wg_chunk", "wg_cluster",
               "dw_cb", "dw_ncs", "dw_cpt", "dw_wt", "dw_nwr", "dw_rows",
               "dw_nstrips",
               "dw_grid", "dw_ring", "dw_consumers", "dw_smem", "dw_blocks",
               "red_grid")
# The plan's launch grids (each dimension at most 65535) and shared memory.
GRID_FIELDS = ("bn_gx", "bn_parts", "fin_grid", "dg_grid", "wg_grid",
               "dw_blocks", "red_grid")
SMEM_FIELDS = ("dg_smem", "wg_smem", "dw_smem")
SMEM_LIMIT = 232448          # dynamic shared memory a block, sm_90
# A GEMM block (csrc/sepconv_gemm.cuh with F32Epilogue): alignment slack
# and barriers, then the ring; a 128 x 64 A tile of bf16 is 16 KB, a
# 64-column B box of 64 k-rows 8 KB.
GEMM_FIXED = 1024 + 256
GEMM_MAX_STAGES = 6
GEMM_TILE = 128 * 64 * 2
GEMM_BOX = 64 * 64 * 2
# Computing threads of a depthwise block, by columns a thread: with two,
# 13 warps keep the 128 registers a thread that its windows take.
DW_MAX_CONSUMERS = {1: 512, 2: 384}
DW_WIDE = 256                # channels past which a thread takes two columns
DW_BARRIERS = 256            # bytes of barriers before its ring
DW_RING_BYTES = 180 * 1024   # at most, its ring of row slots
DW_RING = 16                 # at most, row slots
RED_BLOCKS = 2048            # at most, blocks of the final reduction


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _column_tile(n: int) -> int:
    """A GEMM's column tile for n output columns: the widest of 256, 128
    and 64 that pads at most a tenth of n (728: 3 x 256), else the one
    that pads least. The wider the tile, the fewer bytes a block's ring
    reads from L2 for each product."""
    tiles = (256, 128, 64)
    for t in tiles:
        if _cdiv(n, t) * t - n <= n // 10:
            return t
    return min(tiles, key=lambda t: (_cdiv(n, t) * t - n, -t))


def _gemm(a_tile: int, rows: int, cols: int, splits: int, sms: int) -> dict:
    """One GEMM's launch: column tile, ring stages (as many as fit, at
    most GEMM_MAX_STAGES) and shared memory for an A tile of a_tile bytes
    a stage; clusters of two on neighbouring row tiles wherever there are
    two; a persistent grid of whole clusters, at most one block an SM and
    no more than the work items."""
    bn = _column_tile(cols)
    stage = a_tile + _cdiv(bn, 64) * GEMM_BOX
    stages = min(GEMM_MAX_STAGES, (SMEM_LIMIT - GEMM_FIXED) // stage)
    cm = 2 if rows > 128 else 1
    items = _cdiv(_cdiv(rows, 128), cm) * _cdiv(cols, bn) * splits
    return {"bn": bn, "stages": stages, "smem": GEMM_FIXED + stages * stage,
            "grid": cm * min(items, sms // cm), "cluster": cm}


def launch_plan(n: int, h: int, w: int, ci: int, co: int, hs=None,
                sms: int = 132) -> dict:
    """How one unit backward runs on a card of ``sms`` SMs: the PLAN_FIELDS
    that the kernels read and launch as they are (every grid, tile, split,
    ring depth and shared-memory size), and the scratch tensors' shapes.
    ``hs`` None is the plane kernel (a depthwise block walks all H rows),
    else the strip height.

    BN sums: blocks of 256 threads, up to 32 groups of 8 channels by
    rows, at most 1024 row blocks of at least 256 rows. GEMMs (dgrad: M pixels x CI, k = CO;
    wgrad: CI x CO, k = M pixels; ``_gemm``): 128-row tiles, the wgrad's
    pixels split for about four work items an SM, at least 512 pixels a
    split. Depthwise backward: two channels of one column a thread, or of
    two columns where CI passes 256 (at most 512 threads a block, or 384
    with two columns a thread, and at most twice as many channels: wider
    CI in equal slices of a multiple of 8), as many columns as the
    threads hold, a ring of at most 16 rows in 180 KB, and a persistent
    grid of one block an SM walking (strip or image, column range)
    items."""
    m = n * h * w
    p = {"bn_tx": min(32, co // 8)}
    p["bn_gx"] = _cdiv(co // 8, p["bn_tx"])
    p["bn_rows"] = max(256, _cdiv(m, 1024))
    p["bn_parts"] = _cdiv(m, p["bn_rows"])
    p["fin_grid"] = _cdiv(co, 32)

    # dgrad: an A stage is gy's and p's 128 x 64 tiles.
    dg = _gemm(2 * GEMM_TILE, m, ci, 1, sms)
    p.update({f"dg_{k}": v for k, v in dg.items()})

    # wgrad: an A stage is d's two 64 x 64 boxes.
    tiles = _cdiv(ci, 128) * _cdiv(co, _column_tile(co))
    splits = max(1, min(_cdiv(4 * sms, tiles), _cdiv(m, 512)))
    chunk = _cdiv(_cdiv(m, splits), 64) * 64
    splits = _cdiv(m, chunk)
    wg = _gemm(GEMM_TILE, ci, co, splits, sms)
    p.update({f"wg_{k}": v for k, v in wg.items() if k != "cluster"})
    p["wg_splits"], p["wg_chunk"] = splits, chunk
    p["wg_cluster"] = wg["cluster"]

    # Depthwise backward.
    cpt = 2 if ci > DW_WIDE else 1
    ncs = _cdiv(ci, 2 * DW_MAX_CONSUMERS[cpt])
    cb = _cdiv(_cdiv(ci, ncs), 8) * 8
    groups = max(1, min(_cdiv(w, cpt), DW_MAX_CONSUMERS[cpt] // (cb // 2)))
    nwr = _cdiv(w, groups * cpt)
    wt = _cdiv(_cdiv(w, nwr), cpt) * cpt
    consumers = _cdiv(wt // cpt * cb // 2, 32) * 32
    rows = h if hs is None else int(hs)
    nstrips = _cdiv(h, rows)
    items = nwr * n * nstrips
    grid = max(1, min(items, sms // ncs))
    slot = (wt + 2) * cb * 6
    ring = max(2, min(DW_RING, DW_RING_BYTES // slot))
    p.update(dw_cb=cb, dw_ncs=ncs, dw_cpt=cpt, dw_wt=wt, dw_nwr=nwr,
             dw_rows=rows,
             dw_nstrips=nstrips, dw_grid=grid, dw_ring=ring,
             dw_consumers=consumers,
             dw_smem=DW_BARRIERS + max(ring * slot, consumers * 72),
             dw_blocks=ncs * grid)
    p["red_grid"] = min(RED_BLOCKS, _cdiv(ci * co, 128) + _cdiv(9 * ci, 128))
    assert tuple(p) == PLAN_FIELDS
    p["ints"] = [p[k] for k in PLAN_FIELDS]
    p["scratch"] = {"bn_part": (p["bn_parts"], 2, co), "vec": (5, co),
                    "wpw16": (co, ci), "gpb": (m, co), "gd": (m, ci),
                    "wg_part": (splits, ci, co),
                    "dw_part": (grid, 9, ci)}
    return p


_SMS: dict = {}


def _sm_count(dev) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _check_bn_inputs(name, gy, p, mu, var, dev):
    """gy and p as the kernels read them (bf16, contiguous, on ``dev``)."""
    for t_name, t in (("gy", gy), ("p", p)):
        if t.dtype != torch.bfloat16 or t.device != dev or (
                not t.is_contiguous()) or tuple(t.shape) != tuple(gy.shape):
            raise ValueError(f"{name}: {t_name} must be {tuple(gy.shape)} "
                             f"bf16 and contiguous on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    co = gy.shape[-1]
    if co % 8:
        raise ValueError(f"{name}: needs CO % 8 == 0, got CO={co}")
    for t_name, t in (("mu", mu), ("var", var)):
        if tuple(t.shape) != (co,) or t.device != dev:
            raise ValueError(f"{name}: {t_name} must be ({co},) on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _aligned(name, tensors) -> None:
    """The kernels read their inputs in 16-byte vectors and by TMA."""
    for t_name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must start on a 16-byte "
                             f"boundary (a view at an offset does not)")


def unit_bwd_sums(gy, p, mu, var, eps: float):
    """(2, CO) f32 (sum g, sum g*xhat) over the pixels of NHWC gy and p,
    with the forward's mean and var: the first entry of the kernel's group
    route (pass 1 and the sums of pass 2). The plain version for CPU
    tensors; on the card the kernel or a raise. Not counted: the second
    entry counts the unit backward it finishes."""
    if not gy.is_cuda:
        return unit_bwd_sums_reference(gy, p, mu, var, eps)
    name = "unit_bwd_sums"
    dev = gy.device
    _check_bn_inputs(name, gy, p, mu, var, dev)
    n, h, w, co = gy.shape
    mu32, var32 = (t.detach().float().contiguous() for t in (mu, var))
    _aligned(name, (("gy", gy), ("p", p), ("mu", mu32), ("var", var32)))
    plan = launch_plan(n, h, w, co, co, None, _sm_count(dev))
    bn_part = torch.empty(plan["scratch"]["bn_part"], dtype=torch.float32,
                          device=dev)
    sums = torch.empty((2, co), dtype=torch.float32, device=dev)
    ints = (ctypes.c_int * len(PLAN_FIELDS))(*plan["ints"])
    fn = _build.bound(SOURCE, "unit_bwd_sums_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_float]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                      + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                         ctypes.c_void_p])
    rc = fn(*(_build.ptr(t) for t in (gy, p, mu32, var32)), float(eps),
            _build.ptr(bn_part), _build.ptr(sums), n, h, w, co, ints,
            dev.index or 0, _build.stream_ptr(gy))
    _build.check(rc, name)
    return sums


def _launch(name, gy, r, d, p, taps, wpw, gamma, mu, var, eps, relu_first,
            hs=None, sums=None, m=None):
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
    # The kernels read both weights in f32 as the modules hold them: the
    # taps as (CI, 9) and Wpw as (CO, CI), of which the training path's
    # (9, CI) and (CI, CO) arguments are transposed views, so there these
    # are views and launch nothing (pass 1 casts Wpw to bf16).
    taps_m = taps.detach().t().float().contiguous()
    wpw_m = wpw.detach().t().float().contiguous()
    gamma32, mu32, var32 = (t.detach().float().contiguous()
                            for t in (gamma, mu, var))
    given = []
    if sums is not None:
        if tuple(sums.shape) != (2, co) or sums.device != dev or m is None:
            raise ValueError(f"{name}: sums must be (2, {co}) on {dev}, with "
                             f"m, got {tuple(sums.shape)} on {sums.device}")
        sums = sums.detach().float().contiguous()
        given = [("sums", sums)]
    _aligned(name, [("gy", gy), ("p", p), ("r", r), ("d", d),
                    ("taps", taps_m), ("wpw", wpw_m), ("gamma", gamma32),
                    ("mu", mu32), ("var", var32)] + given)
    plan = launch_plan(n, h, w, ci, co, hs, _sm_count(dev))
    sc = plan["scratch"]

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    da = torch.empty_like(r)
    dwdw, dwpw = f32(9, ci), f32(ci, co)
    dgamma, dbeta = (f32(co), f32(co)) if sums is None else (None, None)
    bn_part, vec = f32(*sc["bn_part"]), f32(*sc["vec"])
    wpw16, gpb = (torch.empty(sc[k], dtype=torch.bfloat16, device=dev)
                  for k in ("wpw16", "gpb"))
    gd, wg_part, dw_part = f32(*sc["gd"]), f32(*sc["wg_part"]), f32(
        *sc["dw_part"])
    ints = (ctypes.c_int * len(PLAN_FIELDS))(*plan["ints"])
    if _build.bound(SOURCE, "unit_bwd_plan_fields", [],
                    ctypes.c_int)() != len(PLAN_FIELDS):
        raise RuntimeError(f"{name}: the kernel reads another plan")
    params = ([ctypes.c_void_p] * 9 + [ctypes.c_float]
              + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
              + [ctypes.POINTER(ctypes.c_int)])
    args = [*(_build.ptr(t) for t in (gy, p, r, d, taps_m, wpw_m, gamma32,
                                      mu32, var32)),
            float(eps),
            *(_build.ptr(t) if t is not None else None
              for t in (da, dwdw, dwpw, dgamma, dbeta, bn_part, vec, wpw16,
                        gpb, gd, wg_part, dw_part)),
            n, h, w, ci, co, int(bool(relu_first)), ints]
    if sums is None:
        fn = _build.bound(SOURCE, f"{name}_launch",
                          params + [ctypes.c_int, ctypes.c_void_p])
    else:
        fn = _build.bound(SOURCE, f"{name}_global_launch",
                          params + [ctypes.c_void_p, ctypes.c_float,
                                    ctypes.c_int, ctypes.c_void_p])
        args += [_build.ptr(sums), float(m)]
    rc = fn(*args, dev.index or 0, _build.stream_ptr(gy))
    _build.check(rc, name)
    _build.count_launch(name)
    return da, dwdw, dwpw, dgamma, dbeta


def unit_bwd_plane(gy, r, d, p, taps, wpw, gamma, mu, var, eps: float,
                   relu_first: bool, sums=None, m=None):
    """Fused unit backward, whole-plane kernel (counterpart of
    ``unit_bwd_pallas``). NHWC in and out; returns (da, dwdw (9, CI),
    dwpw (CI, CO), dgamma, dbeta). ``sums``/``m``: a group's BN sums and
    pixel count (the kernel's second entry, which returns None for dgamma
    and dbeta; see the module docstring)."""
    if not gy.is_cuda:
        return unit_bwd_reference(gy, r, d, p, taps, wpw, gamma, mu, var,
                                  eps, relu_first, sums, m)
    return _launch(PLANE, gy, r, d, p, taps, wpw, gamma, mu, var, eps,
                   relu_first, None, sums, m)


def unit_bwd_strips(gy, r, d, p, taps, wpw, gamma, mu, var, eps: float,
                    relu_first: bool, hs: int = DEFAULT_HS, sums=None,
                    m=None):
    """Fused unit backward, strips of ``hs`` rows with halo rows
    (counterpart of ``unit_bwd_pallas_strips``). NHWC in and out; returns
    (da, dwdw (9, CI), dwpw (CI, CO), dgamma, dbeta). ``sums``/``m`` as
    for ``unit_bwd_plane``."""
    if hs < 1:
        raise ValueError(f"strip height must be >= 1, got {hs}")
    if not gy.is_cuda:
        return unit_bwd_reference(gy, r, d, p, taps, wpw, gamma, mu, var,
                                  eps, relu_first, sums, m)
    return _launch(STRIPS, gy, r, d, p, taps, wpw, gamma, mu, var, eps,
                   relu_first, hs, sums, m)


_BWD = {"auto": unit_bwd_strips, "plane": unit_bwd_plane,
        "reference": unit_bwd_reference}
_SUMS = {"auto": unit_bwd_sums, "plane": unit_bwd_sums,
         "reference": unit_bwd_sums_reference}


# ------------------------------------------------------------- autograd

class _SepBnUnit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, taps, wpw, gamma, beta, eps, relu_first, backend,
                group):
        y, mu, var, (r, d, p) = unit_fwd(a.contiguous(), taps, wpw, gamma,
                                         beta, eps, relu_first, group)
        ctx.save_for_backward(r, d, p, taps, wpw, gamma, mu, var)
        ctx.eps, ctx.relu_first, ctx.backend = eps, relu_first, backend
        ctx.group = group
        ctx.mark_non_differentiable(mu, var)
        return y, mu, var

    @staticmethod
    def backward(ctx, gy, _gmu, _gvar):
        r, d, p, taps, wpw, gamma, mu, var = ctx.saved_tensors
        gy = gy.contiguous()
        group = ctx.group
        if group is None or group.size == 1:
            da, dwdw, dwpw, dgamma, dbeta = _BWD[ctx.backend](
                gy, r, d, p, taps, wpw, gamma, mu, var, ctx.eps,
                ctx.relu_first)
        else:
            # The group's BN sums; dgamma, dbeta are this rank's own.
            local = _SUMS[ctx.backend](gy, p, mu, var, ctx.eps)
            total = group.all_reduce_sum([local])[0]
            da, dwdw, dwpw, _, _ = _BWD[ctx.backend](
                gy, r, d, p, taps, wpw, gamma, mu, var, ctx.eps,
                ctx.relu_first, sums=total,
                m=gy[..., 0].numel() * group.size)
            dgamma, dbeta = local[1], local[0]
        return (da, dwdw.to(taps.dtype), dwpw.to(wpw.dtype),
                dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None,
                None, None)


def sep_bn_unit(a, taps, wpw, gamma, beta, eps: float, relu_first: bool,
                backend: str = "auto", group=None):
    """relu? -> depthwise 3x3 -> pointwise 1x1 -> train-mode BatchNorm on
    NHWC ``a``, with the fused backward. Returns (y, batch mean, batch
    var); mean and var feed the running-statistics update and are not
    differentiated (their cotangents are ignored, as in the JAX
    ``sep_bn_unit``). With a ``group`` of several ranks (``parallel/
    lockstep.Group``) the statistics are the group's, and gamma's and
    beta's gradients this rank's share (see the module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return _SepBnUnit.apply(a, taps, wpw, gamma, beta, eps, relu_first,
                            backend, group)
