"""Train-mode BatchNorm over channels-last rows as one op, with two
hand-written passes each way (``csrc/bn_train.cu``).

The op is Flax's train-mode BatchNorm (``models/xception.py``), on x of
shape (..., C), C last and contiguous (NHWC), over its M = x.numel() / C
rows:

    sums = (sum x, sum x^2)                          f32
    mean = sums[0] / m;  var = max(0, sums[1] / m - mean^2)
    y    = x's dtype of ((x - mean) * (inv * gamma) + beta),  inv = rsqrt(var + eps)

and its closed-form backward:

    sums   = (sum g, sum g*xhat),  xhat = (x - mean) * inv
    gx     = x's dtype of (gamma * inv) * ((g - sums[0] / m) - xhat * (sums[1] / m))
    dgamma = sums[1];  dbeta = sums[0]

with m the rows of the whole batch and each division by m a product with
1 / m. The JAX package leaves this to XLA, which fuses it; the kernels
give the port the same: each way, a deterministic column reduction
(``bn_sums``) and one elementwise pass (``bn_apply``, ``bn_apply_bwd``),
which, given no sums, takes its own rows' in the same call (one call of
the wrappers each way). The op saves x, mean and var for its backward,
and no f32 copy.

Under lockstep data parallelism (``group``, ``parallel/lockstep.py``)
the statistics are the group's: the forward all-reduces its (2, C) f32
sums and the backward its (sum g, sum g*xhat) between ``bn_sums`` and
the apply, with m the group's rows; dgamma and dbeta stay this rank's
share, as the step's gradient all-reduce sums them.

Each kernel wrapper computes its plain version for CPU tensors (in f32,
or f64 for f64 inputs) and, for CUDA tensors, launches its kernel (bf16
or f32 x) or raises. Either way it raises where C is not a multiple of
the values in 16 bytes (8 in bf16, 4 in f32), which every registered
architecture's widths are. The apply passes round each step on its own
in the plain version's order, so from the same sums they give its
outputs bit for bit; the sums add in another order. ``bn_apply`` counts
one ``bn_train_fwd`` launch and ``bn_apply_bwd`` one ``bn_train_bwd``: one
a forward and one a backward of the op.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = "bn_train"
FWD = "bn_train_fwd"
BWD = "bn_train_bwd"
THREADS = 256        # threads a block of the sums and apply kernels
BLOCKS_PER_SM = 3    # blocks an SM resident at once (csrc/bn_train.cu)
ROW_THREADS = 32     # at most, channel vectors a block row
CARD_DTYPES = (torch.bfloat16, torch.float32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vector_width(dtype) -> int:
    """Values of ``dtype`` in one 16-byte load: 8 in bf16, 4 in f32."""
    return max(1, 16 // dtype.itemsize)


def check_width(name: str, c: int, dtype) -> None:
    v = vector_width(dtype)
    if c % v:
        raise ValueError(f"{name}: needs C % {v} == 0 in {dtype}, got C={c}")


def launch_plan(m: int, c: int, dtype, sms: int = 132,
                blocks_per_sm: int = BLOCKS_PER_SM) -> dict:
    """The grid of the three kernels for M = ``m`` rows of ``c`` channels
    on a card of ``sms`` SMs: a block row of ``tx`` channel vectors (all
    of C where it has at most 32, so that a warp reads whole neighbouring
    rows) and ``ty`` rows of threads, ``gx`` blocks across C, and
    ``parts`` blocks of ``rows`` rows down M, about ``blocks_per_sm``
    blocks an SM in all."""
    vecs = c // vector_width(dtype)
    tx = min(ROW_THREADS, vecs)
    ty = THREADS // tx
    gx = _cdiv(vecs, tx)
    rows = max(ty, _cdiv(m, max(1, blocks_per_sm * sms // gx)))
    return {"tx": tx, "ty": ty, "gx": gx, "rows": rows,
            "parts": _cdiv(m, rows)}


# ---------------------------------------------------------- plain version

def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def bn_sums_reference(x, gy=None, mean=None, var=None, eps: float = 0.0):
    """(2, C) sums over the rows of x (..., C): (sum x, sum x^2), or with
    gy (sum gy, sum gy*xhat), xhat from the forward's mean and var."""
    c = x.shape[-1]
    b = x.reshape(-1, c).to(_acc(x.dtype))
    if gy is None:
        a = b
    else:
        a = gy.reshape(-1, c).to(b.dtype)
        b = (b - mean) * torch.rsqrt(var + eps)
    return torch.stack([a.sum(dim=0), (a * b).sum(dim=0)])


def bn_apply_reference(x, gamma, beta, eps: float, sums=None, m=None):
    """(y, mean, var) from the forward's sums over m rows; without
    ``sums``, x's own sums and rows."""
    if sums is None:
        sums, m = bn_sums_reference(x), x.numel() // x.shape[-1]
    inv_m = 1.0 / m
    mean = sums[0] * inv_m
    var = torch.clamp_min(sums[1] * inv_m - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    acc = sums.dtype
    y = (x.to(acc) - mean) * (inv * gamma.to(acc)) + beta.to(acc)
    return y.to(x.dtype), mean, var


def bn_apply_bwd_reference(gy, x, mean, var, gamma, eps: float, sums=None,
                           m=None):
    """(gx, sums) from the backward's sums over m rows; without ``sums``,
    those of these rows."""
    if sums is None:
        sums = bn_sums_reference(x, gy, mean, var, eps)
        m = x.numel() // x.shape[-1]
    inv_m = 1.0 / m
    inv = torch.rsqrt(var + eps)
    acc = sums.dtype
    xhat = (x.to(acc) - mean) * inv
    gx = (gamma.to(acc) * inv) * ((gy.to(acc) - sums[0] * inv_m)
                                  - xhat * (sums[1] * inv_m))
    return gx.to(x.dtype), sums


# ---------------------------------------------------------------- kernels

_SMS: dict = {}


def _sm_count(dev) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _rows(name, x, others=()):
    """x (and each of ``others``, of x's shape and dtype) as the kernels
    read them; returns (M, C, the launch plan)."""
    dev = x.device
    if x.dtype not in CARD_DTYPES:
        raise ValueError(f"{name}: x must be bf16 or f32 on the card, got "
                         f"{x.dtype}")
    for t_name, t in (("x", x),) + tuple(others):
        if (t.dtype != x.dtype or t.device != dev or not t.is_contiguous()
                or t.shape != x.shape):
            raise ValueError(f"{name}: {t_name} must be {tuple(x.shape)} "
                             f"{x.dtype} and contiguous on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must start on a 16-byte "
                             f"boundary (a view at an offset does not)")
    c = x.shape[-1]
    m = x.numel() // c
    if m == 0:
        raise ValueError(f"{name}: x has no rows")
    return m, c, launch_plan(m, c, x.dtype, _sm_count(dev))


def _vectors(name, dev, c, **named):
    """Each named (C,) or (2, C) vector as f32 on ``dev``, contiguous: as
    it is where it is so already (the kernels only read it)."""
    out = []
    for t_name, t in named.items():
        want = (2, c) if t_name == "sums" else (c,)
        if tuple(t.shape) != want or t.device != dev:
            raise ValueError(f"{name}: {t_name} must be {want} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            t = t.detach().float().contiguous()
        out.append(t)
    return out


def _plan_args(x, m, c, plan):
    return [m, c, int(x.dtype == torch.float32), plan["tx"], plan["gx"],
            plan["rows"], plan["parts"], x.device.index or 0,
            _build.stream_ptr(x)]


_PLAN_TYPES = [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _sums_buffer(plan, c, dev):
    """The sums kernel's partials and its (2, C) result."""
    return (torch.empty((plan["parts"], 2, c), dtype=torch.float32,
                        device=dev),
            torch.empty((2, c), dtype=torch.float32, device=dev))


def bn_sums(x, gy=None, mean=None, var=None, eps: float = 0.0):
    """(2, C) f32 sums over the rows of x (..., C), C last and contiguous:
    (sum x, sum x^2), or with gy (sum gy, sum gy*xhat), xhat = (x - mean)
    * rsqrt(var + eps). The plain version for CPU tensors; on the card the
    kernels, summing in a fixed order, or a raise."""
    name = "bn_sums"
    check_width(name, x.shape[-1], x.dtype)
    if not x.is_cuda:
        return bn_sums_reference(x, gy, mean, var, eps)
    m, c, plan = _rows(name, x, () if gy is None else (("gy", gy),))
    dev = x.device
    mean32, var32 = ((None, None) if gy is None
                     else _vectors(name, dev, c, mean=mean, var=var))
    part, sums = _sums_buffer(plan, c, dev)
    fn = _build.bound(SOURCE, "bn_sums_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_float]
                      + [ctypes.c_void_p] * 2 + _PLAN_TYPES)
    rc = fn(_build.ptr(x), None if gy is None else _build.ptr(gy),
            None if mean32 is None else _build.ptr(mean32),
            None if var32 is None else _build.ptr(var32), float(eps),
            _build.ptr(part), _build.ptr(sums), *_plan_args(x, m, c, plan))
    _build.check(rc, name)
    return sums


def _given(name, x, sums, m, plan, c):
    """(part or None, sums, m): without ``sums``, a buffer for the sums
    that the apply's call takes first, over x's own rows."""
    rows = x.numel() // c
    if sums is None:
        return (*_sums_buffer(plan, c, x.device), rows)
    if m is None:
        raise ValueError(f"{name}: given sums need their rows m")
    return None, sums, m


def bn_apply(x, gamma, beta, eps: float, sums=None, m=None):
    """(y in x's dtype, mean, var) of x (..., C) from the forward's
    ``sums`` over ``m`` rows (the group's where a group summed them), or,
    without them, from x's own sums, taken in the same call. The plain
    version for CPU tensors; on the card the kernels, one ``bn_train_fwd``
    launch, or a raise."""
    name = "bn_apply"
    check_width(name, x.shape[-1], x.dtype)
    if not x.is_cuda:
        return bn_apply_reference(x, gamma, beta, eps, sums, m)
    rows, c, plan = _rows(name, x)
    dev = x.device
    part, sums, m = _given(name, x, sums, m, plan, c)
    sums32, gamma32, beta32 = _vectors(name, dev, c, sums=sums, gamma=gamma,
                                       beta=beta)
    y = torch.empty_like(x)
    mean, var = (torch.empty(c, dtype=torch.float32, device=dev)
                 for _ in range(2))
    fn = _build.bound(SOURCE, "bn_apply_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_float] * 2
                      + [ctypes.c_void_p] * 4 + _PLAN_TYPES)
    rc = fn(*(_build.ptr(t) for t in (x, sums32, gamma32, beta32)),
            1.0 / m, float(eps), *(_build.ptr(t) for t in (y, mean, var)),
            None if part is None else _build.ptr(part),
            *_plan_args(x, rows, c, plan))
    _build.check(rc, name)
    _build.count_launch(FWD)
    return y, mean, var


def bn_apply_bwd(gy, x, mean, var, gamma, eps: float, sums=None, m=None):
    """(gx in x's dtype, sums) from gy and x (..., C), the forward's mean
    and var, and the backward's ``sums`` over ``m`` rows, or, without
    them, the sums of these rows, taken in the same call. The plain
    version for CPU tensors; on the card the kernels, one ``bn_train_bwd``
    launch, or a raise."""
    name = "bn_apply_bwd"
    check_width(name, x.shape[-1], x.dtype)
    if not x.is_cuda:
        return bn_apply_bwd_reference(gy, x, mean, var, gamma, eps, sums, m)
    rows, c, plan = _rows(name, x, (("gy", gy),))
    part, sums, m = _given(name, x, sums, m, plan, c)
    vecs = _vectors(name, x.device, c, mean=mean, var=var, gamma=gamma,
                    sums=sums)
    gx = torch.empty_like(x)
    fn = _build.bound(SOURCE, "bn_apply_bwd_launch",
                      [ctypes.c_void_p] * 6 + [ctypes.c_float] * 2
                      + [ctypes.c_void_p] * 2 + _PLAN_TYPES)
    rc = fn(_build.ptr(gy), _build.ptr(x), *(_build.ptr(t) for t in vecs),
            1.0 / m, float(eps), _build.ptr(gx),
            None if part is None else _build.ptr(part),
            *_plan_args(x, rows, c, plan))
    _build.check(rc, name)
    _build.count_launch(BWD)
    return gx, sums


# ------------------------------------------------------------- autograd

def group_sums(x, group, gy=None, mean=None, var=None, eps: float = 0.0):
    """(this rank's sums of x, with gy the backward's; the group's; the
    group's rows) under a ``group`` of several ranks, each holding as many
    rows; (None, None, None) for one rank alone, whose apply takes its
    own sums in its call."""
    if group is None or group.size == 1:
        return None, None, None
    local = bn_sums(x, gy, mean, var, eps)
    rows = x.numel() // x.shape[-1]
    return local, group.all_reduce_sum([local])[0], rows * group.size


class _BnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        _, sums, m = group_sums(x, group)
        y, mean, var = bn_apply(x, gamma, beta, eps, sums, m)
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.eps, ctx.group, ctx.beta_dtype = eps, group, beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, mean, var = ctx.saved_tensors
        gy = gy.contiguous()
        local, sums, m = group_sums(x, ctx.group, gy, mean, var, ctx.eps)
        gx, sums = bn_apply_bwd(gy, x, mean, var, gamma, ctx.eps, sums, m)
        if local is None:
            local = sums
        return (gx, local[1].to(gamma.dtype), local[0].to(ctx.beta_dtype),
                None, None)


def bn_train(x, gamma, beta, eps: float, group=None):
    """Train-mode BatchNorm of x (..., C) over its rows, C last (NHWC; a
    channels-last activation's ``permute(0, 2, 3, 1)``, which is made
    contiguous here and so copied only where it is not channels-last).
    Returns (y in x's dtype, batch mean, batch biased var), mean and var f32
    (x's accumulation dtype on the CPU) and not differentiated. With a
    ``group`` of several ranks (``parallel/lockstep.Group``) the statistics
    are the group's, and gamma's and beta's gradients this rank's share."""
    return _BnTrain.apply(x.contiguous(), gamma, beta, eps, group)
