"""Train-mode BatchNorm as one op (``biscuit_torch/ops/bn_train.py``,
``csrc/bn_train.cu``).

On the CPU: the plain versions against autograd of the op written as a
chain of PyTorch ops (``chain`` below), computed in f64;
``bn_train`` through ``gradcheck``; the lockstep route over two ranks
against one; the width rule and the launch plan at every BatchNorm of the
registered architectures; and that a train-mode forward saves no f32 copy
of an activation.

On a CUDA card (marked ``cuda``; without a card they skip), run with

    python -m pytest tests/test_torch_bn_train.py -m cuda --noconftest -q

each kernel against its plain version at every BatchNorm geometry of
Xception and ResNet-50 at 299 px (batch 8, bf16 and f32, and Xception's
largest at batch 128): the sums within 2e-5 of the sums of the terms'
magnitudes (f32 sums in another order), the apply passes bit for bit
from the same sums; two runs bit for bit; the unit forward's r, d and p
as before; and the launches of one training step of each network.
"""

import math

import pytest
import torch

from biscuit_torch.hp import ModelParams
from biscuit_torch.models.xception import (
    BatchNorm,
    available_models,
    batch_norm_train,
    build_model,
)
from biscuit_torch.ops import _build
from biscuit_torch.ops.bn_train import (
    bn_apply,
    bn_apply_bwd,
    bn_apply_bwd_reference,
    bn_apply_reference,
    bn_sums,
    bn_sums_reference,
    bn_train,
    check_width,
    launch_plan,
    vector_width,
)
from biscuit_torch.parallel.lockstep import run_ranks
from biscuit_torch.parallel.mesh import Mesh

EPS = 1e-5

# (H*W side, C) of every train-mode BatchNorm of the two networks at 299
# px (test_geometries_are_the_networks' holds them to the models).
XCEPTION_BN = [(149, 32), (147, 64), (147, 128), (74, 128), (74, 256),
               (37, 256), (37, 728), (19, 728), (19, 1024), (10, 1024),
               (10, 1536), (10, 2048)]
RESNET50_BN = [(150, 64), (75, 64), (75, 128), (75, 256), (38, 128),
               (38, 256), (38, 512), (19, 256), (19, 512), (19, 1024),
               (10, 512), (10, 2048)]
BN_COUNT = {"xception": 40, "resnet50": 53}


def chain(x, w, b, eps=EPS):
    """Train-mode BatchNorm of NHWC x as a chain of PyTorch ops in x's
    dtype, differentiated by autograd: the oracle of the op."""
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    mu2 = x.square().mean(dim=(0, 1, 2), keepdim=True)
    var = torch.clamp_min(mu2 - mu.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    return (x - mu) * (inv * w) + b, mu.reshape(-1), var.reshape(-1)


def _inputs(shape, dtype, gen, device="cpu"):
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(dtype)
    gy = torch.randn(shape, generator=gen, device=device).to(dtype)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
    b = 0.1 * torch.randn(c, generator=gen, device=device)
    return x, gy, w, b


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("shape", [(4, 5, 7, 8), (2, 3, 3, 16),
                                   (3, 1, 1, 4), (1, 9, 9, 2)])
def test_plain_versions_against_the_chain_in_f64(shape):
    """Sums, forward apply and the closed-form backward, with dgamma and
    dbeta from the backward's sums, against autograd of the chain."""
    gen = torch.Generator().manual_seed(0)
    x, gy, w, b = (t.double() for t in _inputs(shape, torch.float64, gen))
    m = x[..., 0].numel()
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    y_want, mu_want, var_want = chain(xg, wg, bg)
    (y_want * gy).sum().backward()

    sums = bn_sums_reference(x)
    assert _rel(sums[0], x.reshape(-1, shape[-1]).sum(0)) <= 1e-12
    y, mu, var = bn_apply_reference(x, w, b, EPS, sums, m)
    assert y.dtype == sums.dtype == torch.float64
    assert _rel(y, y_want.detach()) <= 1e-10
    assert _rel(mu, mu_want.detach()) <= 1e-10
    assert _rel(var, var_want.detach()) <= 1e-10

    back = bn_sums_reference(x, gy, mu, var, EPS)
    gx, _ = bn_apply_bwd_reference(gy, x, mu, var, w, EPS, back, m)
    assert _rel(gx, xg.grad) <= 1e-9
    assert _rel(back[1], wg.grad) <= 1e-10          # dgamma
    assert _rel(back[0], bg.grad) <= 1e-10          # dbeta
    # Without sums, each apply takes those of its own rows.
    assert all(torch.equal(a, b) for a, b in zip(
        bn_apply_reference(x, w, b, EPS), (y, mu, var)))
    assert all(torch.equal(a, b) for a, b in zip(
        bn_apply_bwd_reference(gy, x, mu, var, w, EPS), (gx, back)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batch_norm_train_against_the_chain(dtype):
    """The op as the models call it, in their dtypes, against autograd of
    the f32 chain: y and gx within a rounding of x's dtype of the largest
    value, mean, var, dgamma and dbeta within 1e-5 (sums in another
    order)."""
    gen = torch.Generator().manual_seed(1)
    x, gy, w, b = _inputs((6, 5, 5, 16), dtype, gen)
    outs = []
    for fn in (lambda x, w, b: batch_norm_train(x, w, b, EPS, (0, 1, 2)),
               lambda x, w, b: chain(x.float(), w, b)):
        xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
        y, mu, var = fn(xg, wg, bg)
        y = y.to(dtype)
        (y.float() * gy.float()).sum().backward()
        assert xg.grad.dtype == dtype
        outs.append((y.detach(), xg.grad, mu, var, wg.grad, bg.grad))
    rounding = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    for i, (got, want) in enumerate(zip(*outs)):
        assert got.dtype == want.dtype
        assert _rel(got.float(), want.float()) <= (rounding if i < 2
                                                   else 1e-5), i


def test_bn_train_passes_gradcheck():
    gen = torch.Generator().manual_seed(2)
    x, _, w, b = (t.double() for t in _inputs((2, 3, 3, 4), torch.float64,
                                              gen))
    args = tuple(t.requires_grad_() for t in (x, w, b))
    assert torch.autograd.gradcheck(
        lambda x, w, b: bn_train(x, w, b, EPS)[0], args)


def test_bn_train_over_two_ranks_is_the_batch():
    """Each rank's half of the batch, the statistics all-reduced forward
    and back: y and gx are the one-rank batch's row by row, mean and var
    the same on both ranks, and dgamma, dbeta each rank's share, which
    the step's gradient all-reduce sums."""
    gen = torch.Generator().manual_seed(3)
    x, gy, w0, b0 = _inputs((6, 5, 5, 8), torch.float32, gen)
    gy[3:] += 1                 # the halves' sums far from the batch's

    def run(group, x, gy):
        xg, w, b = (t.clone().requires_grad_() for t in (x, w0, b0))
        y, mu, var = bn_train(xg, w, b, EPS, group)
        (y * gy).sum().backward()
        return y.detach(), mu, var, xg.grad, w.grad, b.grad

    one = run(None, x, gy)
    out = {}

    def rank(group):
        n = x.shape[0] // group.size
        rows = slice(group.rank * n, (group.rank + 1) * n)
        out[group.rank] = run(group, x[rows], gy[rows])

    run_ranks(Mesh(["cpu", "cpu"]), rank)
    r0, r1 = out[0], out[1]
    for i in (0, 3):
        assert _rel(torch.cat([r0[i], r1[i]]), one[i]) <= 1e-5
    for i in (1, 2):
        assert torch.equal(r0[i], r1[i]) and _rel(r0[i], one[i]) <= 1e-5
    for i in (4, 5):
        assert _rel(r0[i] + r1[i], one[i]) <= 1e-5
        assert _rel(r0[i], one[i]) > 1e-2


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 12),
                                     (torch.bfloat16, 4),
                                     (torch.float32, 6)])
def test_widths_off_the_vector_raise(dtype, c):
    """C must be a multiple of the values in 16 bytes (8 in bf16, 4 in
    f32), on either device, at every entry."""
    x = torch.ones((2, 2, 2, c), dtype=dtype)
    v = torch.ones(c)
    sums = torch.ones((2, c))
    for call in (lambda: bn_sums(x), lambda: bn_sums(x, x, v, v, EPS),
                 lambda: bn_apply(x, v, v, EPS, sums, 8),
                 lambda: bn_apply_bwd(x, x, v, v, v, EPS, sums, 8),
                 lambda: bn_train(x, v, v, EPS)):
        with pytest.raises(ValueError, match=f"C % {vector_width(dtype)}"):
            call()


def _bn_geometries(arch):
    """(H*W side, C) of each train-mode BatchNorm call of ``arch`` at 299
    px, in call order, from a forward on the meta device."""
    hp = ModelParams(model=arch, tile_px=299)
    with torch.device("meta"):
        model = build_model(hp)
    seen = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].shape[-1],
                                       args[0].shape[1])))
             for mod in model.modules() if isinstance(mod, BatchNorm)]
    model.train()
    model.features(torch.empty((1, 299, 299, 3), device="meta"))
    for h in hooks:
        h.remove()
    return seen


@pytest.mark.parametrize("arch,want", [("xception", XCEPTION_BN),
                                       ("resnet50", RESNET50_BN)])
def test_geometries_are_the_networks(arch, want):
    seen = _bn_geometries(arch)
    assert len(seen) == BN_COUNT[arch]
    assert sorted(set(seen)) == sorted(want)


@pytest.mark.parametrize("arch", available_models())
def test_every_architecture_fits_the_width_rule(arch):
    with torch.device("meta"):
        model = build_model(ModelParams(model=arch))
    widths = {mod.num_features for mod in model.modules()
              if isinstance(mod, BatchNorm)}
    assert widths
    for c in widths:
        for dtype in (torch.bfloat16, torch.float32):
            check_width(arch, c, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plan_covers_the_rows(dtype):
    """At every BatchNorm geometry of the two networks, batch 8 and 128,
    every row and channel vector falls in the grid, within the card's
    limits, with about BLOCKS_PER_SM blocks an SM where the rows allow."""
    for hw, c in XCEPTION_BN + RESNET50_BN:
        for batch in (8, 128):
            m = batch * hw * hw
            p = launch_plan(m, c, dtype)
            vecs = c // vector_width(dtype)
            assert 1 <= p["tx"] <= 32 and p["tx"] * p["ty"] <= 256
            assert p["gx"] * p["tx"] >= vecs > (p["gx"] - 1) * p["tx"]
            assert p["parts"] * p["rows"] >= m > (p["parts"] - 1) * p["rows"]
            assert p["parts"] <= 65535 and p["rows"] >= p["ty"]
            assert p["gx"] * p["parts"] <= 3 * 132 + p["gx"]


@pytest.mark.parametrize("arch", ["xception_tiny", "resnet_tiny"])
def test_train_forward_saves_no_f32_activation(arch):
    """The module path's train-mode forward in bf16 saves for backward no
    f32 tensor of the batch's shape: the op keeps bf16 x, and mean and
    var, where the chain kept f32 copies."""
    hp = ModelParams(model=arch, tile_px=37, compute_dtype="bfloat16")
    model = build_model(hp).train()
    x = torch.randn((2, 37, 37, 3))
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.features(x)
    acts = [s for s in saved if len(s[1]) == 4 and s[1][0] == 2]
    assert acts and not any(d == torch.float32 for d, _ in acts), acts


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _abs_sums(x, gy=None, mean=None, var=None):
    """The sums of the terms' magnitudes, the scale of the sums' error."""
    c = x.shape[-1]
    b = x.reshape(-1, c).float()
    if gy is None:
        a = b.abs()
    else:
        a = gy.reshape(-1, c).float().abs()
        b = (b - mean) * torch.rsqrt(var + EPS)
    return torch.stack([a.sum(0), (a * b.abs()).sum(0)])


def _kernels_against_plain(x, gy, w, b):
    """Both ways, each kernel against its plain version on the card: the
    sums within 2e-5 of the terms' magnitudes, the apply passes from the
    kernel's sums bit for bit, and the one-call route (the apply taking
    its own sums) the same bits as the sums then the apply; each apply
    call one launch counted."""
    m = x[..., 0].numel()
    sums = bn_sums(x)
    want = bn_sums_reference(x)
    assert bool(((sums - want).abs() <= 2e-5 * _abs_sums(x)).all())
    before = _build.launch_counts()
    y, mu, var = bn_apply(x, w, b, EPS, sums, m)
    assert y.dtype == x.dtype and y.shape == x.shape
    for got, ref in zip((y, mu, var),
                        bn_apply_reference(x, w, b, EPS, sums, m)):
        assert torch.equal(got, ref)
    for got, ref in zip(bn_apply(x, w, b, EPS), (y, mu, var)):
        assert torch.equal(got, ref)

    back = bn_sums(x, gy, mu, var, EPS)
    want = bn_sums_reference(x, gy, mu, var, EPS)
    assert bool(((back - want).abs()
                 <= 2e-5 * _abs_sums(x, gy, mu, var)).all())
    gx, _ = bn_apply_bwd(gy, x, mu, var, w, EPS, back, m)
    assert torch.equal(gx, bn_apply_bwd_reference(gy, x, mu, var, w, EPS,
                                                  back, m)[0])
    for got, ref in zip(bn_apply_bwd(gy, x, mu, var, w, EPS), (gx, back)):
        assert torch.equal(got, ref)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["bn_train_fwd"] == before["bn_train_fwd"] + 2
    assert after["bn_train_bwd"] == before["bn_train_bwd"] + 2
    return sums, y, back, gx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,c", sorted(set(XCEPTION_BN + RESNET50_BN)))
def test_kernels_at_the_networks_geometries(cuda_gen, hw, c, dtype):
    _kernels_against_plain(*_inputs((8, hw, hw, c), dtype, cuda_gen, "cuda"))


@pytest.mark.cuda
def test_kernels_at_xception_largest(cuda_gen):
    _kernels_against_plain(*_inputs((128, 147, 147, 128), torch.bfloat16,
                                    cuda_gen, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 19, 19, 728), (4, 5, 3, 32)])
def test_kernels_repeat_bit_for_bit(cuda_gen, shape):
    args = _inputs(shape, torch.bfloat16, cuda_gen, "cuda")
    first = _kernels_against_plain(*args)
    second = _kernels_against_plain(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_gen):
    x = torch.ones((2, 3, 3, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        bn_sums(x)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        bn_sums(xb.transpose(1, 2))
    buf = torch.zeros(xb.numel() + 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        bn_sums(buf[1:1 + xb.numel()].view(xb.shape))
    v = torch.ones(16, device="cuda")
    with pytest.raises(ValueError, match="sums"):
        bn_apply(xb, v, v, EPS, v, 18)


@pytest.mark.cuda
@pytest.mark.parametrize("relu_first", [True, False])
def test_unit_fwd_keeps_r_d_p(cuda_gen, relu_first):
    """The unit forward's r, d and p are the library convs' as before, bit
    for bit; y, mean and var come from the new passes, within the sums'
    order of the chain's."""
    import torch.nn.functional as F

    from biscuit_torch.ops.fused_unit_bwd import unit_fwd

    n, h, w, ci, co = 8, 19, 19, 64, 128
    a = torch.randn((n, h, w, ci), generator=cuda_gen, device="cuda").to(
        torch.bfloat16)
    taps = 0.2 * torch.randn((9, ci), generator=cuda_gen, device="cuda")
    wpw = torch.randn((ci, co), generator=cuda_gen, device="cuda") / ci ** .5
    gamma = 1 + 0.1 * torch.randn(co, generator=cuda_gen, device="cuda")
    beta = 0.1 * torch.randn(co, generator=cuda_gen, device="cuda")
    y, mu, var, (r, d, p) = unit_fwd(a, taps, wpw, gamma, beta, EPS,
                                     relu_first)
    r0 = torch.relu(a) if relu_first else a
    d0 = F.conv2d(r0.permute(0, 3, 1, 2),
                  taps.t().reshape(ci, 1, 3, 3).to(a.dtype), padding=1,
                  groups=ci)
    p0 = F.conv2d(d0, wpw.t().reshape(co, ci, 1, 1).to(a.dtype))
    for got, want in ((r, r0), (d, d0.permute(0, 2, 3, 1)),
                      (p, p0.permute(0, 2, 3, 1))):
        assert got.is_contiguous() and torch.equal(got, want)
    y0, mu0, var0 = chain(p.float(), gamma, beta)
    assert _rel(mu, mu0) <= 1e-5 and _rel(var, var0) <= 1e-5
    assert _rel(y.float(), y0.to(torch.bfloat16).float()) <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("arch,fwd,bwd,strips", [("xception", 40, 6, 34),
                                                 ("resnet50", 53, 53, 0)])
def test_train_step_launches(cuda_gen, arch, fwd, bwd, strips):
    """One training step of each network at 299 px, batch 4: every
    train-mode BatchNorm through the op (Xception's 34 units forward and
    its 6 library BatchNorms both ways; ResNet-50's 53 both ways)."""
    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.train.trainer import make_optimizer, make_train_step

    hp = nature2022_params()
    hp.model = arch
    model = build_model(hp).cuda()
    step = make_train_step(model, make_optimizer(hp, model.parameters()), hp,
                           make_normalizer(hp.normalizer))
    tiles = torch.randint(0, 256, (4, 299, 299, 3), generator=cuda_gen,
                          device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 2, (4,), generator=cuda_gen, device="cuda")
    _build.reset_launch_counts()
    out = step(tiles, labels, torch.ones(4, device="cuda"), cuda_gen)
    torch.cuda.synchronize()
    got = _build.launch_counts()
    assert math.isfinite(float(out["loss"]))
    assert got["bn_train_fwd"] == fwd and got["bn_train_bwd"] == bwd
    assert got["unit_bwd_strips"] == strips
