"""The port's hand-written kernels against their plain versions on a CUDA
card (they have no CPU mode; without a card these tests skip). Run on the
card with:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Small shapes that exercise the ragged edges (rows and columns that do not
fill a tile); chip_smoke.py holds the same comparisons at the main path's
shapes. Tolerances as there: bf16 outputs within 2e-2 (preprocess) and
1e-2 of the largest value (middle flow), head probabilities within 2e-3
on the same Philox stream; the unit backwards within 5e-3 of each
gradient's largest value (1e-2 for da), since the kernel factors the BN
backward as the TPU kernel does and a bf16 rounding of gp may flip; the
fused strided block within 1e-2 of the largest value (an f32 sum in
another order may flip a bf16 rounding of a0, a1 or y1); the depthwise
3x3 forward and input gradient within 2e-6 of the largest value in f32
and one bf16 ulp of each value in bf16, its filter gradient within 1e-5
of the largest value (sums over N*H*W in another order).
"""

import pytest
import torch

from biscuit_torch.data.normalize import ReinhardFastNormalizer
from biscuit_torch.models.xception import Head
from biscuit_torch.ops import _build
from biscuit_torch.ops.depthwise import (
    depthwise_conv3x3,
    depthwise_conv3x3_reference,
)
from biscuit_torch.ops.fused_block import (
    fused_strided_block,
    fused_strided_block_reference,
)
from biscuit_torch.ops.fused_preprocess import (
    fused_preprocess,
    fused_preprocess_reference,
)
from biscuit_torch.ops.fused_sepconv import (
    fused_middle_flow,
    fused_middle_flow_reference,
)
from biscuit_torch.ops.fused_unit_bwd import (
    unit_bwd_plane,
    unit_bwd_reference,
    unit_bwd_strips,
    unit_bwd_sums,
    unit_fwd,
)
from biscuit_torch.ops.mcd_head import (
    head_weights,
    mcd_head,
    mcd_head_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _preprocess_checked(x, norm):
    """One kernel call, its launch counted once, within 2e-2 of the plain
    version; returns the output in f32."""
    before = _build.launch_counts()["fused_preprocess"]
    got = fused_preprocess(x, norm)
    assert _build.launch_counts()["fused_preprocess"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float()
    assert bool(torch.isfinite(got).all())
    want = fused_preprocess_reference(x, norm)
    assert (got - want).abs().max().item() <= 2e-2
    return got


# A 299 x 299 image is 268,203 bytes in and 536,406 out, 11 and 6 mod 16,
# so no image after the first starts on a 16-byte boundary: every CTA of
# a cluster handles a head and a tail. 37 x 41 and 1 x 1 take a cluster of
# one CTA, whose image is smaller than a 16-byte chunk at 1 x 1.
@pytest.mark.parametrize("shape", [(3, 37, 41, 3), (1, 299, 299, 3),
                                   (2, 299, 299, 3), (256, 299, 299, 3),
                                   (1, 1, 1, 3)])
def test_fused_preprocess(gen, shape):
    x = torch.randint(0, 256, shape, generator=gen, device="cuda",
                      dtype=torch.uint8)
    _preprocess_checked(x, ReinhardFastNormalizer())


@pytest.mark.parametrize("cluster,threads", [(8, None), (16, None),
                                             (16, 64)])
def test_fused_preprocess_cluster_sizes(gen, cluster, threads):
    """Both cluster sizes of 299 px images launch (a cluster of 16 is
    non-portable), fit the card and agree with the plain version; with 64
    threads a CTA, its pixels above the bottom three quarters of the
    buffer take several rounds of loads and barriers."""
    import dataclasses

    from biscuit_torch.ops.fused_preprocess import (
        _launch,
        coefficients,
        launch_plan,
        max_active_clusters,
    )

    x = torch.randint(0, 256, (5, 299, 299, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    norm = ReinhardFastNormalizer()
    plan = launch_plan(5, 299, 299, cluster=cluster)
    if threads is not None:
        plan = dataclasses.replace(plan, threads=threads)
    assert max_active_clusters(plan) >= 1
    out = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
    _launch(x, out, coefficients(norm, x.device), plan)
    want = fused_preprocess_reference(x, norm)
    assert (out.float() - want).abs().max().item() <= 2e-2


@pytest.mark.parametrize("value", [0, 255])
def test_fused_preprocess_constant_tile(gen, value):
    """An all-0 or all-255 tile between two random ones. Its lab std is
    the rounding noise of its mean, which (lab - m) / max(std, 1e-6)
    amplifies up to a million times, so the plain version's own output
    there is set by its summation order: the constant tile is held to
    finite outputs, the same at every pixel; its neighbours to 2e-2."""
    x = torch.randint(0, 256, (3, 299, 299, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    x[1] = value
    norm = ReinhardFastNormalizer()
    got = fused_preprocess(x, norm).float()
    assert bool(torch.isfinite(got).all())
    assert bool((got[1] == got[1, :1, :1]).all())
    want = fused_preprocess_reference(x, norm)
    assert (got[0::2] - want[0::2]).abs().max().item() <= 2e-2


def test_fused_preprocess_fitted_normalizer(gen):
    target = torch.randint(0, 256, (64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    norm = ReinhardFastNormalizer().fit(target)
    x = torch.randint(0, 256, (2, 299, 299, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    got = _preprocess_checked(x, norm)
    default = fused_preprocess(x, ReinhardFastNormalizer()).float()
    assert (got - default).abs().max().item() > 2e-2


def test_fused_preprocess_repeats_bit_for_bit(gen):
    x = torch.randint(0, 256, (8, 299, 299, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    norm = ReinhardFastNormalizer()
    assert torch.equal(fused_preprocess(x, norm), fused_preprocess(x, norm))


def test_fused_preprocess_makes_no_copy_and_no_sync(gen):
    """With the library built and bound, a call, through the serving
    entry too, and the first call with newly fitted targets, make no
    synchronizing copy: the sync debug mode raises on any."""
    from biscuit_torch.data.normalize import inference_preprocess

    x = torch.randint(0, 256, (4, 299, 299, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    norm = ReinhardFastNormalizer()
    fused_preprocess(x, norm)
    refit = ReinhardFastNormalizer().fit(torch.randint(
        0, 256, (32, 32, 3), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(4)))
    torch.cuda.synchronize()
    before = _build.launch_counts()["fused_preprocess"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [fused_preprocess(x, norm), inference_preprocess(x, norm),
                fused_preprocess(x, refit)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.launch_counts()["fused_preprocess"] == before + 3
    assert torch.equal(outs[0], outs[1])
    want = fused_preprocess_reference(x, refit)
    assert (outs[2].float() - want).abs().max().item() <= 2e-2


def _middle_inputs(gen, n, hw, c, u, dtype=torch.bfloat16):
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device="cuda") * std

    dw = normal((u, 9, c), 0.15)
    pw = normal((u, c, c), 0.15 / c ** 0.5).to(torch.bfloat16)
    sc = 0.8 + 0.4 * torch.rand((u, c), generator=gen, device="cuda")
    sh = normal((u, c), 0.05)
    x = normal((n, hw, hw, c), 1.0).to(dtype)
    return x, dw, pw, sc, sh


# (N, hw, C, U): a plane smaller than a GEMM tile; two blocks at the
# serving width, whose K = 728 ends in a ragged k-tile (11 x 64 + 24) and
# whose N = 728 in a ragged column tile; 64 images, whose tiles outnumber
# the SMs, so each block walks several; one image; K = N = 8; and a 45 x 45
# plane, too large for a block's image slice, on the shared depthwise pass.
@pytest.mark.parametrize("n,hw,c,u", [(3, 5, 16, 3), (2, 19, 728, 6),
                                      (64, 19, 728, 3), (1, 19, 728, 3),
                                      (2, 7, 8, 3), (1, 45, 16, 3)])
def test_fused_middle_flow(gen, n, hw, c, u):
    x, dw, pw, sc, sh = _middle_inputs(gen, n, hw, c, u)
    before = _build.launch_counts()["fused_middle_flow"]
    got = fused_middle_flow(x, dw, pw, sc, sh)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fused_middle_flow"] == before + 1
    want = fused_middle_flow_reference(x, dw, pw, sc, sh).float()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


def test_fused_middle_flow_takes_views_off_a_boundary(gen):
    """Inputs that start 2 or 4 bytes off a 16-byte boundary, which the
    tensor maps cannot read in place, are copied, not refused."""
    x, dw, pw, sc, sh = _middle_inputs(gen, 2, 6, 16, 3)
    want = fused_middle_flow_reference(x, dw, pw, sc, sh).float()

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    got = fused_middle_flow(shifted(x), shifted(dw), shifted(pw), shifted(sc),
                            shifted(sh)).float()
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


# (N, F, H, rate, K, C): N not a multiple of a block's tiles (13, 300),
# H not a multiple of the 128-column tile (136), K of 1 and 2 with 8
# classes (64 and 32 tiles a block, 512 and 256 sums), K below and above
# one block's 64 rows (33 pads to 64, 70 walks two row chunks), 5 classes,
# H of 1152 and 1160, which the pass kernel's A holds whole at C <= 16 (19
# k-chunks), and 2048, which rebuilds A in two segments of uneven width.
HEAD_SHAPES = [(13, 256, 128, 0.0, 7, 2), (13, 256, 136, 0.3, 7, 2),
               (300, 2048, 1024, 0.1, 7, 2), (300, 256, 136, 0.1, 1, 2),
               (13, 256, 136, 0.2, 30, 5), (300, 256, 128, 0.2, 33, 2),
               (13, 256, 136, 0.1, 70, 5), (256, 2048, 1024, 0.1, 30, 2),
               (300, 256, 136, 0.1, 1, 8), (300, 256, 136, 0.1, 2, 8),
               (13, 256, 1152, 0.2, 7, 2), (13, 256, 1152, 0.1, 7, 8),
               (300, 256, 1160, 0.1, 30, 8), (40, 256, 2048, 0.1, 70, 5),
               (256, 2048, 2048, 0.1, 30, 2)]


@pytest.mark.parametrize("n,f,h,rate,k,c", HEAD_SHAPES)
def test_mcd_head(gen, n, f, h, rate, k, c):
    torch.manual_seed(0)
    wts = head_weights(Head(f, c, 2, h, rate).cuda())
    feats = torch.randn((n, f), generator=gen, device="cuda")
    km, ks = mcd_head(feats, *wts, k=k, dropout=rate, seed=99)
    rm, rs = mcd_head_reference(feats, *wts, k=k, dropout=rate, seed=99)
    assert km.shape == ks.shape == (n, c)
    assert (km - rm).abs().max().item() <= 2e-3
    assert (ks - rs).abs().max().item() <= 2e-3


# Heads of 9 to 128 classes (C padded to 16, 32, 64 or 128 in the
# kernel): every class count it pads to and two it pads, at K of
# 1 (64 tiles a block), 30 and 70 (two row chunks, the sums carried) and
# H of 136 (a ragged column tile), 1024 and 2048 (A rebuilt by segment).
WIDE_CLASSES = [9, 16, 33, 64, 128]
WIDE_KH = [(k, h) for k in (1, 30, 70) for h in (136, 1024, 2048)]


@pytest.mark.parametrize("k,h", WIDE_KH)
@pytest.mark.parametrize("c", WIDE_CLASSES)
def test_mcd_head_wide(gen, c, k, h):
    """The kernel against its plain version, within 1e-3 at dropout 0 and
    2e-3 at 0.1, on logits weights scaled up so that the softmax is far
    from uniform; a call repeats bit for bit."""
    torch.manual_seed(c)
    head = Head(256, c, 2, h, 0.1).cuda()
    with torch.no_grad():
        head.logits.weight.mul_(8.0)
    wts = head_weights(head)
    n = 300 if k == 1 else 40
    feats = torch.randn((n, 256), generator=gen, device="cuda")
    for rate, tol in ((0.0, 1e-3), (0.1, 2e-3)):
        km, ks = mcd_head(feats, *wts, k=k, dropout=rate, seed=99)
        rm, rs = mcd_head_reference(feats, *wts, k=k, dropout=rate, seed=99)
        assert km.shape == ks.shape == (n, c)
        assert (km - rm).abs().max().item() <= tol
        assert (ks - rs).abs().max().item() <= tol
        assert (km.sum(-1) - 1).abs().max().item() <= 1e-3
    assert rm.max().item() > 2.0 / c        # not a uniform softmax
    again = mcd_head(feats, *wts, k=k, dropout=0.1, seed=99)
    assert torch.equal(again[0], km) and torch.equal(again[1], ks)


def test_mcd_head_rejects_what_the_kernel_does_not_take(gen):
    """129 classes, or a hidden width that is not a multiple of 8."""
    feats = torch.zeros((4, 64), device="cuda")
    for c, h in ((129, 64), (2, 60)):
        wts = head_weights(Head(64, c, 2, h, 0.1).cuda())
        with pytest.raises(ValueError):
            mcd_head(feats, *wts, k=4, dropout=0.1, seed=1)


def test_mcd_head_repeats_bit_for_bit(gen):
    torch.manual_seed(0)
    wts = head_weights(Head(2048, 2, 2, 1024, 0.1).cuda())
    feats = torch.randn((256, 2048), generator=gen, device="cuda")
    first = mcd_head(feats, *wts, k=30, dropout=0.1, seed=5)
    second = mcd_head(feats, *wts, k=30, dropout=0.1, seed=5)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("classes,width", [(129, 64), (2, 1020)])
def test_interface_serves_heads_the_kernel_cannot_take(gen, classes, width):
    """129 classes, or a hidden width that is not a multiple of 8: the
    interface routes the head to the module head on the card, answers,
    and matches the module head at dropout 0."""
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import XceptionClassifier
    from biscuit_torch.train.uq import (
        UncertaintyInterface,
        mc_dropout_head,
        trunk_features,
    )

    hp = nature2022_params()
    hp.model, hp.tile_px, hp.dropout = "xception_tiny", 37, 0.0
    torch.manual_seed(0)
    model = XceptionClassifier(arch="xception_tiny", num_classes=classes,
                               hidden_layers=2, hidden_width=width,
                               dropout=0.0, compute_dtype=torch.bfloat16)
    tiles = torch.randint(0, 256, (6, 37, 37, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
    ui = UncertaintyInterface.from_model(model, hp, k=4)
    before = _build.launch_counts()["mcd_head"]
    mean, std = ui(tiles)
    assert _build.launch_counts()["mcd_head"] == before
    assert mean.shape == std.shape == (6, classes)
    with torch.inference_mode():
        x = inference_preprocess(tiles, ui.wsi_normalizer)
        feats = trunk_features(ui.model, x, True, ui._mid_wts)
        want_m, want_s = mc_dropout_head(ui.model, feats, k=4,
                                         use_kernel=False)
    assert (mean - want_m).abs().max().item() <= 1e-3
    assert (std - want_s).abs().max().item() <= 1e-3


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.zeros((1, 8, 8, 3), device="cuda")
    with pytest.raises(TypeError):
        fused_preprocess(x.to(torch.float32))
    with pytest.raises(ValueError):            # it writes bf16 or f32
        fused_preprocess(x.to(torch.uint8), out_dtype=torch.float16)
    x, dw, pw, sc, sh = _middle_inputs(gen, 1, 5, 16, 3)
    with pytest.raises(TypeError):             # it takes bf16 or f32
        fused_middle_flow(x.to(torch.float16), dw, pw, sc, sh)


def test_jpeg_products_stay_f32_with_tf32_on(gen):
    """The DCT products of the JPEG augmentation pin full f32: a process
    that turns TF32 on gets the same tiles at quality 99, and keeps its
    setting."""
    from biscuit_torch.data.augment import jpeg_apply

    x = torch.randint(0, 256, (8, 64, 64, 3), generator=gen, device="cuda",
                      dtype=torch.uint8)
    apply = torch.ones(8, dtype=torch.bool, device="cuda")
    q = torch.full((8,), 99, device="cuda")
    want = jpeg_apply(x, apply, q)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = jpeg_apply(x, apply, q)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, want)


def test_jpeg_products_leave_the_process_precision_alone(gen):
    """After ``set_float32_matmul_precision("high")`` and then the CUDA
    matmul's own TF32 switch turned off, PyTorch refuses to read the
    process-wide precision; the JPEG augmentation (in every training step
    with 'j') neither reads nor sets it, and still pins full f32."""
    from biscuit_torch.data.augment import jpeg_apply

    x = torch.randint(0, 256, (8, 64, 64, 3), generator=gen, device="cuda",
                      dtype=torch.uint8)
    apply = torch.ones(8, dtype=torch.bool, device="cuda")
    q = torch.full((8,), 99, device="cuda")
    want = jpeg_apply(x, apply, q)
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = jpeg_apply(x, apply, q)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, want)


# (N, H, W, CI, CO, hs): a small plane, a ragged last strip (19 = 3*6 + 1)
# over 16 images, the 37x37 entry geometry in two strips, the exit tail
# (CI over one depthwise block's 1024 channels, both GEMM dimensions over
# several tiles), a shape whose pixels fill no 128-row GEMM tile and whose
# CO is no multiple of 64, and one image of the middle flow.
UNIT_SHAPES = [(4, 9, 7, 8, 16, 3), (16, 19, 13, 8, 16, 6),
               (2, 37, 37, 256, 728, 24), (2, 10, 10, 1536, 2048, 4),
               (3, 11, 11, 24, 40, 4), (1, 19, 19, 728, 728, 6)]


def unit_bwd_args(gen, shape, relu_first):
    n, h, w, ci, co, _ = shape
    a = torch.randn((n, h, w, ci), generator=gen, device="cuda").to(
        torch.bfloat16)
    taps = 0.2 * torch.randn((9, ci), generator=gen, device="cuda")
    wpw = torch.randn((ci, co), generator=gen, device="cuda") / ci ** 0.5
    gamma = 1 + 0.1 * torch.randn(co, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(co, generator=gen, device="cuda")
    gy = torch.randn((n, h, w, co), generator=gen, device="cuda").to(
        torch.bfloat16)
    _, mu, var, (r, d, p) = unit_fwd(a, taps, wpw, gamma, beta, 1e-5,
                                     relu_first)
    return a, (gy, r, d, p, taps, wpw, gamma, mu, var, 1e-5, relu_first)


@pytest.mark.parametrize("relu_first", [True, False])
@pytest.mark.parametrize("shape", UNIT_SHAPES)
def test_unit_bwd(gen, shape, relu_first):
    hs = shape[-1]
    a, args = unit_bwd_args(gen, shape, relu_first)
    want = unit_bwd_reference(*args)
    for name, fn, kw in (("unit_bwd_plane", unit_bwd_plane, {}),
                         ("unit_bwd_strips", unit_bwd_strips, {"hs": hs})):
        before = _build.launch_counts()[name]
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts()[name] == before + 1
        assert got[0].dtype == torch.bfloat16 and got[0].shape == a.shape
        for i, (g, ref) in enumerate(zip(got, want)):
            g, ref = g.float(), ref.float()
            assert bool(torch.isfinite(g).all()), (name, i)
            err = (g - ref).abs().max().item() / ref.abs().max().item()
            assert err <= (1e-2 if i == 0 else 5e-3), (name, i, err)


@pytest.mark.parametrize("shape", [UNIT_SHAPES[1], UNIT_SHAPES[3]])
def test_unit_bwd_repeats_bit_for_bit(gen, shape):
    """No atomics, partials summed in a fixed order: the same inputs give
    the same outputs to the bit, on both entry points."""
    _, args = unit_bwd_args(gen, shape, True)
    for fn, kw in ((unit_bwd_plane, {}), (unit_bwd_strips, {"hs": shape[-1]})):
        first = fn(*args, **kw)
        second = fn(*args, **kw)
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            assert torch.equal(x, y)


def test_unit_bwd_reads_the_module_layout(gen):
    """The weights as the training path passes them, transposed views of
    f32 tensors laid out as the modules hold them ((CI, 9) taps, (CO, CI)
    Wpw), give the same outputs to the bit as contiguous (9, CI) and
    (CI, CO) weights."""
    _, args = unit_bwd_args(gen, UNIT_SHAPES[2], True)
    taps, wpw = args[4], args[5]
    views = args[:4] + (taps.t().contiguous().t(),
                        wpw.t().contiguous().t()) + args[6:]
    assert not views[4].is_contiguous() and not views[5].is_contiguous()
    for fn in (unit_bwd_plane, unit_bwd_strips):
        want = fn(*args)
        got = fn(*views)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_unit_bwd_rejects_what_the_kernel_does_not_take(gen):
    x = torch.zeros((1, 4, 4, 8), device="cuda")
    v = torch.ones(8, device="cuda")
    args = (x, x, x, x, torch.zeros((9, 8), device="cuda"),
            torch.zeros((8, 8), device="cuda"), v, v, v, 1e-5, True)
    with pytest.raises(ValueError):
        unit_bwd_plane(*args)          # f32 activations
    xb = x.to(torch.bfloat16)
    bad = (xb, xb, xb, xb[..., :4].contiguous()) + args[4:]
    with pytest.raises(ValueError):
        unit_bwd_strips(*bad)          # d of the wrong width
    buf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = buf[1:].view(x.shape)    # contiguous, 2 bytes off a boundary
    for i in range(4):
        off = tuple(shifted if j == i else xb for j in range(4)) + args[4:]
        with pytest.raises(ValueError, match="16-byte"):
            unit_bwd_plane(*off)


# The lockstep route's geometries: 147^2 64->128 and 19^2 728->728 at
# batch 16, halved for two ranks.
GROUP_SHAPES = [(16, 147, 147, 64, 128, 24), (16, 19, 19, 728, 728, 24)]


def _route(fn, args, sums, m, **kw):
    """The unit backward's second entry, from the group's sums."""
    return fn(*args, sums=sums, m=m, **kw)


@pytest.mark.parametrize("relu_first", [True, False])
@pytest.mark.parametrize("shape", GROUP_SHAPES)
def test_unit_bwd_group_route_at_one_rank_is_the_one_call(gen, shape,
                                                          relu_first):
    """The two entries of the group route (``unit_bwd_sums``, then the
    backward from those sums) at one rank give the one-call kernel's
    outputs bit for bit, count one launch, and the sums are the one
    call's dbeta and dgamma, which the second entry leaves unwritten."""
    _, args = unit_bwd_args(gen, shape, relu_first)
    gy, p, mu, var, eps = args[0], args[3], args[7], args[8], args[9]
    m = gy[..., 0].numel()
    for name, fn, kw in (("unit_bwd_strips", unit_bwd_strips,
                          {"hs": shape[-1]}),
                         ("unit_bwd_plane", unit_bwd_plane, {})):
        want = fn(*args, **kw)
        before = _build.launch_counts()[name]
        sums = unit_bwd_sums(gy, p, mu, var, eps)
        got = _route(fn, args, sums, m, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts()[name] == before + 1
        for x, y in zip(got[:3], want[:3]):
            assert torch.equal(x, y), name
        assert got[3] is None and got[4] is None
        assert torch.equal(sums[0], want[4]) and torch.equal(sums[1], want[3])


@pytest.mark.parametrize("shape", GROUP_SHAPES)
def test_unit_bwd_group_route_over_two_halves(gen, shape):
    """Each half of a batch, fed the summed sums of the two halves and the
    batch's pixel count, gives the one call on the whole batch: da row by
    row, the weight gradients summed over the halves, within the kernel's
    tolerances against its plain version (1e-2 of the largest da, 5e-3 of
    each f32 gradient's largest value: the sums add in another order).
    The second half's gy and p are shifted by 1, so that a half's own
    sums are far from the batch's."""
    _, args = unit_bwd_args(gen, shape, True)
    gy, r, d, p = args[:4]
    n = gy.shape[0] // 2
    gy, p = gy.clone(), p.clone()
    gy[n:] += 1
    p[n:] += 1
    args = (gy, r, d, p) + tuple(args[4:])
    mu, var, eps = args[7], args[8], args[9]
    halves = [tuple(t[i * n:(i + 1) * n] for t in (gy, r, d, p)) + args[4:]
              for i in range(2)]
    sums = sum(unit_bwd_sums(h[0], h[3], mu, var, eps) for h in halves)
    m = gy[..., 0].numel()
    want = unit_bwd_strips(*args, hs=shape[-1])
    outs = [_route(unit_bwd_strips, h, sums, m, hs=shape[-1])
            for h in halves]
    torch.cuda.synchronize()
    got = [torch.cat([outs[0][0], outs[1][0]]),
           outs[0][1] + outs[1][1], outs[0][2] + outs[1][2], sums[1],
           sums[0]]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item() / w.abs().max().item()
        assert err <= (1e-2 if i == 0 else 5e-3), (i, err)


def test_train_step_kernel_against_plain(gen):
    """One fused-trunk step of xception_tiny at 37 px on the card (unit
    planes down to 2x2 and 1x1) with the strip kernel, and one with the
    plain-version backward, from the same weights and batch: the same
    loss, every unit backward on the kernel, and gradients within 5e-2
    of each tensor's largest value (or, for a tensor whose gradient is
    under 1e-2 of the largest gradient, within 1e-3 of that)."""
    import copy

    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.trainer import make_optimizer, make_train_step

    hp = nature2022_params()
    hp.model, hp.tile_px, hp.hidden_layer_width = "xception_tiny", 37, 32
    hp.augment, hp.dropout = "", 0.0
    torch.manual_seed(0)
    model0 = build_model(hp)
    tiles = torch.randint(0, 256, (16, 37, 37, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 2, (16,), generator=gen, device="cuda")
    mask = torch.ones(16, device="cuda")
    grads, losses = {}, {}
    for backend in ("auto", "reference"):
        m = copy.deepcopy(model0).cuda()
        step = make_train_step(m, make_optimizer(hp, m.parameters()), hp,
                               make_normalizer(hp.normalizer),
                               backend=backend)
        before = _build.launch_counts()["unit_bwd_strips"]
        losses[backend] = float(step(tiles, labels, mask)["loss"])
        launched = _build.launch_counts()["unit_bwd_strips"] - before
        # 16 units: 3 entry blocks x 2, 2 middle blocks x 3, 2 + 2 exit.
        assert launched == (16 if backend == "auto" else 0)
        grads[backend] = {n: p.grad for n, p in m.named_parameters()}
    assert losses["auto"] == losses["reference"]
    tree_max = max(g.abs().max().item() for g in grads["reference"].values())
    for name, want in grads["reference"].items():
        scale = want.abs().max().item()
        diff = (grads["auto"][name] - want).abs().max().item()
        assert (diff <= 5e-2 * scale
                or (scale <= 1e-2 * tree_max and diff <= 1e-3 * tree_max)), \
            (name, diff / scale, scale / tree_max)


def _block_weights(gen, cin, f0, f1):
    """A random weight tuple as stack_block_weights gives it."""

    def normal(shape, std):
        return std * torch.randn(shape, generator=gen, device="cuda")

    def bn(c):
        return (0.6 + 0.8 * torch.rand(c, generator=gen, device="cuda"),
                normal((c,), 0.2))

    return (normal((9, cin), 0.3),
            normal((cin, f0), cin ** -0.5).to(torch.bfloat16), *bn(f0),
            normal((9, f0), 0.3),
            normal((f0, f1), f0 ** -0.5).to(torch.bfloat16), *bn(f1),
            normal((cin, f1), cin ** -0.5).to(torch.bfloat16), *bn(f1))


# (N, H, W, Cin, F0, F1, relu_first): odd and even H and W, F0 != F1,
# widths that are not multiples of 64 (nor of the GEMM's 128-column tile),
# a 4x4 plane (xception_tiny's entry2) and a 1-pixel one.
# Also entry0's geometry (147^2 64->128->128) and an output row wider than
# the residual GEMM's 128-row tile (W = 260: two runs of one row).
BLOCK_SHAPES = [(2, 13, 13, 24, 40, 40, True), (3, 14, 14, 24, 40, 56, False),
                (2, 16, 13, 16, 16, 16, False), (2, 19, 19, 72, 72, 136, True),
                (1, 12, 18, 8, 8, 24, False), (5, 4, 4, 48, 48, 64, True),
                (3, 1, 1, 8, 16, 8, True), (2, 147, 147, 64, 128, 128, False),
                (1, 3, 260, 8, 8, 16, True)]


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_fused_block(gen, shape):
    n, h, w, cin, f0, f1, relu_first = shape
    wts = _block_weights(gen, cin, f0, f1)
    x = (1.5 * torch.randn((n, h, w, cin), generator=gen, device="cuda")).to(
        torch.bfloat16)
    before = _build.launch_counts()["fused_block"]
    got = fused_strided_block(x, wts, relu_first)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fused_block"] == before + 1
    want = fused_strided_block_reference(x, wts, relu_first)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape == (n, -(-h // 2), -(-w // 2), f1)
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


def _bf16_ulp(v):
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
# H below the 8-row ring (1x1, 2x5), W wider than a block's 32-column
# range (70 is cut in three), C of 6 (the narrow path), 12 and 24.
@pytest.mark.parametrize("shape", [(2, 7, 9, 24), (3, 6, 4, 6),
                                   (2, 19, 19, 728), (3, 1, 1, 16),
                                   (2, 2, 5, 24), (2, 5, 70, 12),
                                   (1, 9, 33, 6)])
def test_depthwise3x3(gen, shape, dtype):
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k = 0.3 * torch.randn((3, 3, 1, c), generator=gen, device="cuda")
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    outs = {}
    for name, fn in (("kernel", depthwise_conv3x3),
                     ("plain", depthwise_conv3x3_reference)):
        xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
        before = _build.launch_counts()["depthwise3x3"]
        y = fn(xg, kg)
        dx, dk = torch.autograd.grad(y, (xg, kg), g)
        torch.cuda.synchronize()
        launched = _build.launch_counts()["depthwise3x3"] - before
        assert launched == (2 if name == "kernel" else 0)
        outs[name] = (y, dx, dk)
    for i, (got, want) in enumerate(zip(outs["kernel"], outs["plain"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        got, want = got.float(), want.float()
        if i == 2:
            tol = 1e-5 * want.abs().max().item()
            assert (got - want).abs().max().item() <= tol
        elif dtype == torch.float32:
            tol = 2e-6 * want.abs().max().item()
            assert (got - want).abs().max().item() <= tol
        else:
            assert bool(((got - want).abs() <= _bf16_ulp(want)).all())


def test_block_and_depthwise_reject_what_the_kernels_do_not_take(gen):
    wts = _block_weights(gen, 16, 16, 16)
    x = torch.zeros((1, 6, 6, 16), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((3, 3, 1, 16), device="cuda")
    buf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = buf[1:].view(x.shape)    # contiguous, 2 bytes off a boundary
    strided = x.permute(0, 2, 1, 3)    # not contiguous
    with pytest.raises(TypeError):             # it takes bf16 or f32
        fused_strided_block(x.to(torch.float16), wts)
    with pytest.raises(ValueError):
        fused_strided_block(strided, wts)
    with pytest.raises(ValueError, match="16-byte"):
        fused_strided_block(shifted, wts)
    with pytest.raises(ValueError):
        fused_strided_block(x[..., :8].contiguous(), wts)   # Cin != weights
    with pytest.raises(TypeError):
        depthwise_conv3x3(x.to(torch.float16), k)
    with pytest.raises(ValueError):
        depthwise_conv3x3(strided, k)
    with pytest.raises(ValueError, match="16-byte"):
        depthwise_conv3x3(shifted, k)
    torch.cuda.synchronize()           # no launch faulted the context


def test_score_tiles_on_the_card_matches_the_cpu(gen, tmp_path):
    """``score_tiles`` over 3 tfrecords of 12 Paeth-filtered PNG tiles at
    xception_tiny, batch 16 (three batches, the last padded to 4 rows), at
    dropout 0, with the default trunk and with ``fuse_blocks=True``: the
    card's rows equal the CPU's, its probabilities within 2e-2 (bf16
    trunk and preprocess on the card, the f32 chain and the module path
    on the CPU) and its std within 1e-3; each batch launches the
    preprocess, middle flow (the tiny width, 48, takes it) and MC head
    kernels once, and with ``fuse_blocks`` the strided-block kernel four
    times. The logits layer is set so the probabilities spread over the
    tiles (``chip_smoke.decisive_logits_``): a random head gives every
    tile about 0.5, where a wrong kernel would stay within 2e-2."""
    import numpy as np

    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.data.tfrecord import TFRecordWriter
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.trainer import score_tiles
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features
    from chip_smoke import decisive_logits_, encode_png, init_random_

    hp = ModelParams(model="xception_tiny", tile_px=32, batch_size=16,
                     hidden_layer_width=32, dropout=0.0, uq=True, uq_samples=4)
    model = build_model(hp)
    init_random_(torch, model, 0)
    rng = np.random.default_rng(0)
    paths, tiles = [], []
    for s in range(3):
        paths.append(str(tmp_path / f"s{s}.tfrecords"))
        with TFRecordWriter(paths[-1]) as w:
            for t in range(12):
                tiles.append(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
                w.write_tile(f"s{s}", encode_png(tiles[-1], 4), loc_x=t,
                             loc_y=s)
    labels = {"s0": 0, "s1": 1, "s2": 0}
    norm = UncertaintyInterface.from_model(model, hp,
                                           device="cpu").wsi_normalizer
    with torch.no_grad():
        feats = trunk_features(model, inference_preprocess(
            torch.from_numpy(np.stack(tiles)), norm))
    decisive_logits_(torch, model, feats)
    want_rows, want_p, want_u = score_tiles(model, hp, paths, labels,
                                            device="cpu")
    assert np.ptp(want_p[:, 1]) > 0.2
    for fuse in (False, True):
        before = _build.launch_counts()
        rows, probs, unc = score_tiles(model, hp, paths, labels,
                                       fuse_blocks=fuse)
        after = _build.launch_counts()
        for name in after:
            want = 3 if name in ("fused_preprocess", "fused_middle_flow",
                                 "mcd_head") else 0
            if fuse and name == "fused_block":
                want = 4 * 3
            assert after[name] - before[name] == want, (fuse, name)
        for key in ("slide", "loc_x", "loc_y", "y_true"):
            np.testing.assert_array_equal(rows[key], want_rows[key])
        assert probs.shape == unc.shape == (36, 2)
        np.testing.assert_allclose(probs, want_p, rtol=0, atol=2e-2)
        np.testing.assert_allclose(unc, want_u, rtol=0, atol=1e-3)


def test_train_project_on_the_card(gen, tmp_path):
    """``Project.train`` of xception_tiny (bf16, 32 px, batch 16, uq=True
    at K=4) on a project of 6 slides of 16 PNG tiles, 3 steps an epoch
    over epochs [1, 2], fold 1 of 3: every step's 16 unit backwards on
    the strip kernel and its BatchNorms on the op's kernels, the
    preprocess, middle-flow and MC-head kernels once for each of the 2
    validation batches of each epoch, nothing else; the model-dir
    contract; and the epoch model, loaded by
    ``UncertaintyInterface``, gives its CSV's probabilities again."""
    import os

    import numpy as np
    import pandas as pd

    from biscuit_torch.data.tfrecord import TFRecordWriter
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.project import Project
    from biscuit_torch.train.trainer import score_tiles
    from biscuit_torch.train.uq import UncertaintyInterface
    from chip_smoke import encode_png

    rng = np.random.default_rng(0)
    (tmp_path / "tfr").mkdir()
    for s in range(6):
        with TFRecordWriter(str(tmp_path / "tfr" / f"s{s}.tfrecords")) as w:
            for t in range(16):
                w.write_tile(f"s{s}", encode_png(rng.integers(
                    0, 256, (32, 32, 3), dtype=np.uint8)), loc_x=t, loc_y=s)
    pd.DataFrame({"patient": [f"p{s}" for s in range(6)],
                  "slide": [f"s{s}" for s in range(6)],
                  "cohort": [f"c{s % 2}" for s in range(6)],
                  "site": [f"site{s // 2}" for s in range(6)]}).to_csv(
                      tmp_path / "ann.csv", index=False)
    project = Project(str(tmp_path / "root"),
                      annotations=str(tmp_path / "ann.csv"), create=True)
    project.add_source("SRC", tfrecords=str(tmp_path / "tfr"))
    hp = ModelParams(model="xception_tiny", tile_px=32, tile_um=32,
                     batch_size=16, epochs=[1, 2], early_stop=False,
                     hidden_layer_width=32, dropout=0.1, uq=True,
                     uq_samples=4, augment="xyrjb")
    before = _build.launch_counts()
    (model_dir,) = project.train("cohort", "card", params=hp, val_k=[1],
                                 steps_per_epoch_override=3, save_model=True)
    after = _build.launch_counts()
    # 6 steps of xception_tiny: 16 units, 22 BatchNorms, 6 of them
    # outside the units.
    for name in after:
        want = {"unit_bwd_strips": 16 * 6, "bn_train_fwd": 22 * 6,
                "bn_train_bwd": 6 * 6}.get(name, 2 * 2 if name in (
                    "fused_preprocess", "fused_middle_flow", "mcd_head")
                else 0)
        assert after[name] - before[name] == want, name
    files = set(os.listdir(model_dir))
    for e in (1, 2):
        assert {f"tile_predictions_val_epoch{e}.csv",
                f"slide_predictions_cohort_val_epoch{e}.csv",
                f"patient_predictions_cohort_val_epoch{e}.csv",
                f"cohort-card-HP0-kfold1_epoch{e}"} <= files
    assert {"slide_manifest.csv", "params.json", "train_log.csv",
            "results_log.csv"} <= files
    log = pd.read_csv(os.path.join(model_dir, "results_log.csv"))
    assert list(log["model_name"]) == ["cohort-card-HP0_epoch1",
                                       "cohort-card-HP0_epoch2"]
    ui = UncertaintyInterface(os.path.join(model_dir,
                                           "cohort-card-HP0-kfold1_epoch2"))
    man = pd.read_csv(os.path.join(model_dir, "slide_manifest.csv"))
    val = list(man.loc[man["dataset"] == "validation", "slide"])
    labels = {f"s{s}": s % 2 for s in range(6)}
    _, probs, _ = score_tiles(ui.model, ui.hp, [
        str(tmp_path / "tfr" / f"{s}.tfrecords") for s in sorted(val)],
        labels)
    csv = pd.read_csv(os.path.join(model_dir,
                                   "tile_predictions_val_epoch2.csv"))
    np.testing.assert_allclose(
        probs, csv[["cohort_y_pred0", "cohort_y_pred1"]], rtol=0, atol=1e-6)


def test_experiment_run_on_the_card(gen, tmp_path):
    """``Experiment.run`` steps 3, 5 and 6 (step 6 evaluates step 5's FULL
    model) of ZD at xception_tiny (bf16, 32 px, batch 16, K=4) on a
    10-slide training and a 4-slide evaluation project of 16 PNG tiles,
    with no device in ``train_kwargs``: every training step on the strip
    kernel, the UQ validation predictions and the evaluation through the
    preprocess, middle-flow and MC-head kernels; the UQ folds' uncertainty
    columns, the eval dir's four files, and finite AUCs in [0, 1] from
    ``results``."""
    import os

    import numpy as np
    import pandas as pd

    from biscuit_torch import utils
    from biscuit_torch.data.tfrecord import TFRecordWriter
    from biscuit_torch.experiment import Experiment
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.project import Project
    from chip_smoke import encode_png

    rng = np.random.default_rng(0)
    projects = []
    for name, n in (("tr", 10), ("ev", 4)):
        (tmp_path / f"{name}_tfr").mkdir()
        for s in range(n):
            with TFRecordWriter(str(tmp_path / f"{name}_tfr" /
                                    f"{name}{s}.tfrecords")) as w:
                for t in range(16):
                    img = rng.integers(40, 120, (32, 32, 3), dtype=np.uint8)
                    img[..., 2 * (s % 2)] += 100
                    w.write_tile(f"{name}{s}", encode_png(img), loc_x=t,
                                 loc_y=s)
        pd.DataFrame({"patient": [f"{name}p{s}" for s in range(n)],
                      "slide": [f"{name}{s}" for s in range(n)],
                      "cohort": ["LUAD", "LUSC"] * (n // 2),
                      "site": [f"site{s // 2}" for s in range(n)]}).to_csv(
                          tmp_path / f"{name}.csv", index=False)
        projects.append(Project(str(tmp_path / name),
                                annotations=str(tmp_path / f"{name}.csv"),
                                name=name, create=True))
        projects[-1].add_source("SRC", tfrecords=str(tmp_path /
                                                     f"{name}_tfr"))
    exp = Experiment(projects[0], [projects[1]],
                     outdir=str(tmp_path / "results"))
    exp.train_kwargs = {"seed": 0, "validate_on_batch": 16,
                        "validation_steps": 8}
    hp = ModelParams(model="xception_tiny", tile_px=32, tile_um=32,
                     batch_size=16, epochs=[1], early_stop=False,
                     hidden_layer_width=32, dropout=0.1, uq_samples=4,
                     augment="xyrjb")
    before = _build.launch_counts()
    exp.run({"ZD": {"out1": 5, "out2": 5}}, steps=[3, 5, 6], hp=hp)
    after = _build.launch_counts()
    for name in ("fused_preprocess", "fused_middle_flow", "mcd_head",
                 "unit_bwd_strips"):
        assert after[name] > before[name], name
    for m in utils.find_cv(projects[0], "EXP_ZD_UQ", outcome="cohort"):
        df = pd.read_csv(os.path.join(m, "tile_predictions_val_epoch1.csv"))
        assert "cohort_uncertainty1" in df.columns
        assert np.isfinite(df["cohort_uncertainty1"]).all()
    eval_dir = utils.find_eval(projects[1], "EXP_ZD_FULL", outcome="cohort")
    assert set(os.listdir(eval_dir)) == {
        "results_log.csv", "tile_predictions_eval.csv",
        "patient_predictions_cohort_eval.csv",
        "slide_predictions_cohort_eval.csv"}
    df, eval_dfs = exp.results(["ZD"], uq=True, eval=True)
    assert list(df["uq"]) == ["all"] * 3
    assert len(eval_dfs["ev"]) == 1
    for auc in list(df["slide_auc"]) + list(eval_dfs["ev"]["patient_auc"]):
        assert 0.0 <= auc <= 1.0


def test_heatmap_on_the_card_matches_the_cpu(gen, tmp_path):
    """``Heatmap`` of a 192-px JPEG tiled slide (6 x 6 positions of 32 px,
    Otsu QC keeping the 24 tissue ones) at xception_tiny, batch 16, dropout
    0, on the card and on the CPU: the same -99 mask, probabilities within
    2e-2 (bf16 trunk and preprocess on the card, the f32 chain and the
    module path on the CPU), std within 1e-3; on the card the preprocess,
    middle-flow and MC-head kernels launch once a batch (2 batches). The
    logits layer is set so the probabilities spread
    (``chip_smoke.decisive_logits_``)."""
    import numpy as np

    from biscuit_torch.data.native_loader import write_tiled_tiff
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.data.slide import WSI
    from biscuit_torch.heatmap import Heatmap
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.trainer import save_checkpoint
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features
    from chip_smoke import decisive_logits_, init_random_

    rng = np.random.default_rng(0)
    img = rng.integers(236, 253, (192, 192, 3), dtype=np.uint8)
    img[:, :128] = np.clip(np.array([170, 90, 140]) + rng.normal(
        0, 30, (192, 128, 3)), 0, 255).astype(np.uint8)
    slide = str(tmp_path / "hs.svs")
    write_tiled_tiff(slide, img, tile=64, jpeg=True)
    hp = ModelParams(model="xception_tiny", tile_px=32, tile_um=32,
                     hidden_layer_width=32, dropout=0.0, uq=True,
                     uq_samples=4)
    model = build_model(hp)
    init_random_(torch, model, 0)
    tiles = np.stack([it["image"] for it in WSI(
        slide, 32, 32, qc="otsu").build_generator()()])
    norm = UncertaintyInterface.from_model(model, hp,
                                           device="cpu").wsi_normalizer
    with torch.no_grad():
        feats = trunk_features(model, inference_preprocess(
            torch.from_numpy(tiles), norm))
    decisive_logits_(torch, model, feats)
    model_dir = save_checkpoint(str(tmp_path / "models"), model, hp, 1,
                                "cohort", "HM", None)
    want = Heatmap(slide, model_dir, batch_size=16, qc="otsu", device="cpu")
    before = _build.launch_counts()
    got = Heatmap(slide, model_dir, batch_size=16, qc="otsu")
    after = _build.launch_counts()
    for name in after:
        n = 2 if name in ("fused_preprocess", "fused_middle_flow",
                          "mcd_head") else 0
        assert after[name] - before[name] == n, name
    unscored = want.logits[..., 1] == -99.0
    assert unscored.sum() == 12
    np.testing.assert_array_equal(got.logits[..., 1] == -99.0, unscored)
    assert np.ptp(want.logits[~unscored, 1]) > 0.2
    np.testing.assert_allclose(got.logits, want.logits, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got.uncertainty, want.uncertainty, rtol=0,
                               atol=1e-3)


def test_resize_batch_on_the_card_matches_the_cpu(gen):
    """The GAN path's 512 -> 299 resize on the card within 1e-3 (0-255
    scale) of the CPU's, with TF32 allowed or not: the weights are made on
    the CPU and the contractions run in f64 on both."""
    import numpy as np

    from biscuit_torch.gan import resize_batch

    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 512, 512, 3), dtype=np.uint8))
    want = resize_batch(imgs, 299)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got = resize_batch(imgs.cuda(), 299)
            assert got.is_cuda and got.dtype == torch.float32
            assert (got.cpu() - want).abs().max().item() <= 1e-3
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_registered_ops_pass_opcheck_on_the_card(gen):
    """The four serving kernels' registered ops (``ops/library.py``) on
    CUDA tensors: schema, fake tensors, autograd registration and AOT
    dispatch, each running the kernel."""
    from biscuit_torch.ops import library
    from biscuit_torch.ops.fused_block import stack_block_weights
    from biscuit_torch.ops.fused_preprocess import coefficients
    from biscuit_torch.ops.mcd_head import seed_tensor
    from biscuit_torch.models.xception import XceptionBlock

    x = torch.randint(0, 256, (2, 37, 37, 3), dtype=torch.uint8,
                      device="cuda", generator=gen)
    torch.library.opcheck(library.fused_preprocess, (
        x, coefficients(ReinhardFastNormalizer(), "cuda")))
    u, c = 3, 32
    torch.library.opcheck(library.fused_middle_flow, (
        torch.randn(2, 9, 9, c, device="cuda", generator=gen).to(
            torch.bfloat16),
        torch.randn(u, 9, c, device="cuda", generator=gen),
        (torch.randn(u, c, c, device="cuda", generator=gen) * 0.1).to(
            torch.bfloat16),
        torch.rand(u, c, device="cuda", generator=gen) + 0.5,
        torch.randn(u, c, device="cuda", generator=gen) * 0.1))
    block = XceptionBlock(16, (32, 32), relu_first=True).cuda().eval()
    torch.library.opcheck(library.fused_strided_block, (
        torch.randn(2, 9, 9, 16, device="cuda", generator=gen).to(
            torch.bfloat16), list(stack_block_weights(block)), 1))
    head = Head(64, 2, 2, 32, 0.25).cuda()
    torch.library.opcheck(library.mcd_head, (
        torch.randn(5, 64, device="cuda", generator=gen),
        list(head_weights(head)), seed_tensor((1 << 63) + 5), 4, 0.25))


def _servable_model_dir(tmp_path, dropout, compute_dtype="bfloat16"):
    """xception_tiny (bf16 unless ``compute_dtype`` says, 32 px, 2 x 32
    head, K=4) with seeded random weights, its logits spread over random
    tiles, saved as a model dir; and 16 random tiles."""
    import numpy as np

    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.trainer import save_checkpoint
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features
    from chip_smoke import decisive_logits_, init_random_

    hp = ModelParams(model="xception_tiny", tile_px=32, tile_um=32,
                     hidden_layer_width=32, dropout=dropout, uq=True,
                     uq_samples=4, compute_dtype=compute_dtype)
    model = build_model(hp)
    init_random_(torch, model, 0)
    tiles = np.random.default_rng(0).integers(0, 256, (16, 32, 32, 3),
                                              dtype=np.uint8)
    norm = UncertaintyInterface.from_model(model, hp,
                                           device="cpu").wsi_normalizer
    with torch.no_grad():
        feats = trunk_features(model, inference_preprocess(
            torch.from_numpy(tiles), norm))
    decisive_logits_(torch, model, feats)
    return save_checkpoint(str(tmp_path / f"m{dropout}{compute_dtype}"),
                           model, hp, 1, "cohort", "SV", None), tiles


@pytest.mark.parametrize("fuse_blocks", [False, True])
def test_kernels_artifact_equals_the_live_interface(gen, tmp_path,
                                                    fuse_blocks):
    """A servable exported on the card (``use_kernels=None`` puts the
    kernels' ops in it) against ``UncertaintyInterface`` on the same model
    dir at the same seeds, dropout 0.25: equal bit for bit (the same
    kernels see the same inputs); rows 1-3 launch once a call, the
    strided block 4 times with ``fuse_blocks``."""
    from biscuit_torch import serve
    from biscuit_torch.train.uq import UncertaintyInterface

    model_dir, tiles = _servable_model_dir(tmp_path, 0.25)
    path = serve.export_servable(model_dir, str(tmp_path / "a.biscuit"),
                                 batch_size=16, fuse_blocks=fuse_blocks)
    sv = serve.load_servable(path)
    assert sv.device.type == "cuda" and sv.header["use_kernels"] is True
    live = UncertaintyInterface(model_dir, fuse_blocks=fuse_blocks)
    for seed in (3, (1 << 63) | 7):
        before = _build.launch_counts()
        got = sv.call_exact(tiles, seed=seed)
        after = _build.launch_counts()
        for name in after:
            want = 1 if name in ("fused_preprocess", "fused_middle_flow",
                                 "mcd_head") else 0
            if fuse_blocks and name == "fused_block":
                want = 4
            assert after[name] - before[name] == want, name
        want = live(tiles, seed=seed)
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)
    assert float(got[1].mean()) > 0
    assert not torch.equal(sv.call_exact(tiles, seed=4)[0], got[0])
    with pytest.raises(ValueError, match="runs on"):
        serve.load_servable(path, device="cpu")


def test_portable_artifact_on_the_card_matches_the_cpu(gen, tmp_path):
    """A portable servable (``use_kernels=False``) exported on the CPU,
    loaded on the card (moved there) and on the CPU, at dropout 0: the
    card's means within 2e-2 of the CPU's (cuDNN's and the CPU's f32
    convs in another order) over a spread of 0.2 or more, std within
    1e-3; no kernel launches."""
    import numpy as np

    from biscuit_torch import serve

    model_dir, tiles = _servable_model_dir(tmp_path, 0.0)
    path = serve.export_servable(model_dir, str(tmp_path / "c.biscuit"),
                                 batch_size=16, use_kernels=False,
                                 platforms=["cuda", "cpu"], device="cpu",
                                 with_features=False)
    cpu = serve.load_servable(path, device="cpu")
    card = serve.load_servable(path)
    assert card.device.type == "cuda"
    want = cpu.call_exact(tiles, seed=2)
    before = _build.launch_counts()
    got = card.call_exact(tiles, seed=2)
    assert _build.launch_counts() == before
    assert got[0].is_cuda
    assert np.ptp(want[0][:, 1].numpy()) > 0.2
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=2e-2)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-3)


def test_device_statistics_on_the_card_match_the_cpu(gen):
    """The device statistics backend on the card (its default device)
    against itself on the CPU: equal thresholds, AUCs and apply results
    (the tile thresholds come from integer counts; the group means are
    rounded to f32 after f64 sums that differ only in order), the f64
    group table within 1e-12, and bit for bit on a repeat."""
    from biscuit_torch import threshold as th
    from biscuit_torch.ops import roc_device as rd
    from biscuit_torch.ops import threshold_device as td
    from chip_smoke import stats_frame

    df = stats_frame(0, 60_000, 500)
    card = th.detect(df.copy(), backend="device")
    assert card == th.detect(df.copy(), backend="device", device="cpu")
    assert card[0]["slide_uq"] is not None
    folds = [stats_frame(k, 30_000, 500) for k in (1, 2, 3)]
    cv = th.from_cv([f.copy() for f in folds], backend="device")
    assert cv == th.from_cv([f.copy() for f in folds], backend="device",
                            device="cpu")
    ext = stats_frame(4, 30_000, 500)
    patients = dict(zip(ext["slide"], ext["patient"]))
    got, got_df = th.apply(ext.copy(), level="patient", patients=patients,
                           backend="device", **cv)
    want, want_df = th.apply(ext.copy(), level="patient", patients=patients,
                             backend="device", device="cpu", **cv)
    assert got == want and got_df.equals(want_df)

    yt, yp, u, seg, _levels, nseg = td._prepare(df, "slide", "cpu")
    tables = [rd.group_reduce(*(t.to(dev) for t in (yt, yp, u, seg)), nseg,
                              (u < 0.2).to(dev))
              for dev in ("cpu", "cuda", "cuda")]
    for k in tables[0]:
        assert torch.equal(tables[1][k], tables[2][k]), k
        torch.testing.assert_close(tables[1][k].cpu(), tables[0][k],
                                   rtol=1e-12, atol=0)


def test_resnet_tiny_on_the_card_matches_the_cpu(gen):
    """resnet_tiny (f32, TF32 off for the call) on the card against the
    CPU: pooled features within 1e-4 of the largest; served through
    ``UncertaintyInterface``, rows 1 and 3 launch once a call and no other
    kernel (the fused trunks are Xception's), means within 2e-2 of the
    CPU's at dropout 0."""
    import copy

    import numpy as np

    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.uq import UncertaintyInterface
    from chip_smoke import init_random_

    hp = ModelParams(model="resnet_tiny", tile_px=64, hidden_layer_width=32,
                     dropout=0.0, compute_dtype="float32", uq=True,
                     uq_samples=4)
    model = build_model(hp)
    init_random_(torch, model, 0)
    model.eval()
    x = torch.randn((8, 64, 64, 3), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        want = model.features(x)
        got = copy.deepcopy(model).cuda().features(x.cuda()).cpu()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * want.abs().max().item())
    tiles = np.random.default_rng(2).integers(0, 256, (16, 64, 64, 3),
                                              dtype=np.uint8)
    cpu = UncertaintyInterface.from_model(copy.deepcopy(model), hp,
                                          device="cpu")
    card = UncertaintyInterface.from_model(model, hp)
    assert not card._fused and card._use_kernel
    before = _build.launch_counts()
    mean, _ = card(tiles, seed=1)
    after = _build.launch_counts()
    for name in after:
        want_n = 1 if name in ("fused_preprocess", "mcd_head") else 0
        assert after[name] - before[name] == want_n, name
    torch.testing.assert_close(mean.cpu(), cpu(tiles, seed=1)[0], rtol=0,
                               atol=2e-2)


def test_imported_model_serves_on_the_card(gen, tmp_path):
    """An xception_tiny Keras full-model export (``chip_smoke.keras_export``
    of a seeded model with spread logits), imported by
    ``load_pretrained_full`` and saved as a model dir, served on the card
    against the CPU at dropout 0: rows 1-3 once a call, means within 2e-2
    over a spread of 0.2 or more."""
    import numpy as np

    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.pretrained import load_pretrained_full
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.trainer import init_model, save_checkpoint
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features
    from chip_smoke import (
        decisive_logits_,
        init_random_,
        keras_export,
        save_keras,
    )

    hp = ModelParams(model="xception_tiny", tile_px=32, tile_um=32,
                     hidden_layer_width=32, dropout=0.0, uq=True,
                     uq_samples=4)
    src = build_model(hp)
    init_random_(torch, src, 0)
    src.eval()
    tiles = np.random.default_rng(0).integers(0, 256, (16, 32, 32, 3),
                                              dtype=np.uint8)
    norm = UncertaintyInterface.from_model(src, hp,
                                           device="cpu").wsi_normalizer
    with torch.no_grad():
        decisive_logits_(torch, src, trunk_features(src, inference_preprocess(
            torch.from_numpy(tiles), norm)))
    path = str(tmp_path / "full.npz")
    save_keras(path, keras_export(src))
    model = load_pretrained_full(
        init_model(build_model(hp), hp, torch.Generator()), path)
    model_dir = save_checkpoint(str(tmp_path / "models"), model, hp, 1,
                                "cohort", "imported", None)
    card = UncertaintyInterface(model_dir)
    cpu = UncertaintyInterface(model_dir, device="cpu")
    before = _build.launch_counts()
    got, _ = card(tiles, seed=1)
    after = _build.launch_counts()
    for name in after:
        want_n = 1 if name in ("fused_preprocess", "fused_middle_flow",
                               "mcd_head") else 0
        assert after[name] - before[name] == want_n, name
    want, _ = cpu(tiles, seed=1)
    assert np.ptp(want[:, 1].numpy()) > 0.2
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-2)


# (rows-making input shape N, H, W, Cin; kernel size; stride; Cout): a
# 1x1 conv of fewer than 17 rows (padded for cuBLASLt), the 1x1/s2
# residual, the stem convs (inner size 27 padded to 32) and an output
# width that is no multiple of 8.
INT8_CONVS = [((1, 4, 4, 16), 1, 1, 24), ((2, 9, 9, 32), 1, 2, 48),
              ((2, 33, 33, 3), 3, 2, 8), ((2, 16, 16, 8), 3, 1, 12)]


@pytest.mark.parametrize("shape,k,stride,cout", INT8_CONVS)
def test_int8_products_on_the_card_equal_the_cpu(gen, shape, k, stride,
                                                 cout):
    """``torch._int_mm`` on the card (cuBLASLt) against the CPU: the int32
    accumulators of an int8 conv equal exactly, the padded rows, inner
    size and output channels included."""
    import numpy as np

    from biscuit_torch.ops.int8_trunk import _int8_conv, place_int8_trunk

    rng = np.random.default_rng(0)
    w = {"k": rng.integers(-127, 128, (k, k, shape[-1], cout),
                           dtype=np.int8),
         "inv_s_in": np.float32(1.0), "eff": np.ones(cout, np.float32),
         "shift": np.zeros(cout, np.float32)}
    q = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    want = _int8_conv(q, place_int8_trunk({"c": w}, "cpu")["c"], stride)
    got = _int8_conv(q.cuda(), place_int8_trunk({"c": w}, "cuda")["c"],
                     stride)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


def test_int8_interface_on_the_card_matches_the_cpu(gen):
    """The int8 trunk of ``xception_tiny`` on the card against the CPU at
    the same scales and preprocessed input (the middle flow the fused
    kernel on the card, its plain version on the CPU): pooled features
    within 3e-2 of the largest, chip_smoke's bound for the bf16 trunks (a
    bf16 rounding that flips early moves them by about 1e-2, and the
    quantizer can carry it one int8 code further); an
    interface calibrated on the card serves int8 requests with rows 1-3
    launched once each."""
    import copy

    import numpy as np

    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.ops.int8_trunk import (
        calibrate_int8_trunk,
        prepare_int8_trunk,
        trunk_features_int8,
    )
    from biscuit_torch.train.uq import UncertaintyInterface
    from chip_smoke import init_random_

    hp = ModelParams(model="xception_tiny", tile_px=64, hidden_layer_width=32,
                     dropout=0.0, uq=True, uq_samples=4)
    model = build_model(hp)
    init_random_(torch, model, 0)
    model.eval()
    x = torch.randn((8, 64, 64, 3), generator=torch.Generator()
                    .manual_seed(1))
    qw = prepare_int8_trunk(model, calibrate_int8_trunk(model, x))
    want = trunk_features_int8(model, x, qw, fused_trunk=True)
    card_model = copy.deepcopy(model).cuda()
    got = trunk_features_int8(card_model, x.cuda(), qw).cpu()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=3e-2 * want.abs().max().item())
    tiles = np.random.default_rng(2).integers(0, 256, (8, 64, 64, 3),
                                              dtype=np.uint8)
    ui = UncertaintyInterface.from_model(card_model, hp, int8_trunk=True,
                                         calib_tiles=8)
    ui(tiles)                                   # calibrates
    assert ui._qw is not None
    before = _build.launch_counts()
    mean, _ = ui(tiles, seed=1)
    after = _build.launch_counts()
    for name in after:
        want_n = 1 if name in ("fused_preprocess", "fused_middle_flow",
                               "mcd_head") else 0
        assert after[name] - before[name] == want_n, name
    assert torch.isfinite(mean).all()


# f32 on the card: rows 1, 2 and 4 take the f32 their Pallas kernels take
# (the preprocess's out_dtype, the middle flow's and the strided block's
# x), so a compute_dtype="float32" Xception runs the kernels. Tolerances:
# the preprocess's f32 output within F32_PREPROCESS_TOL of the plain f32
# chain (its approximate base-2 logarithms and exponentials and its sums
# in another order, with no bf16 rounding after them); the middle flow
# within F32_MIDDLE_TOL of its largest value: a flipped bf16 rounding of
# one pointwise product's input moves an output by about ulp(a)·|pw|, a
# few 1e-5 of the largest value at these widths, while x read as bf16
# (carried to the output by block 0's residual) or the output stored as
# bf16 moves it by about 1e-3, and both must miss the bound; the block
# at the bf16 test's bound, since it rounds at the same points (each
# pointwise product's input, y1), and its residual alone within 1e-4 of
# its largest value, which x rounded to bf16 does not meet.
F32_PREPROCESS_TOL = 1e-3
F32_MIDDLE_TOL = 3e-4


@pytest.mark.parametrize("shape", [(3, 37, 41, 3), (2, 299, 299, 3),
                                   (1, 1, 1, 3), (5, 299, 299, 3)])
def test_fused_preprocess_f32(gen, shape):
    """f32 out: a 299 x 299 image is 1,072,812 bytes, 12 mod 16, so each
    image after the first starts off a 16-byte boundary, as in bf16; the
    output repeats bit for bit and its bf16 form is the bf16 kernel's
    output within one bf16 rounding."""
    x = torch.randint(0, 256, shape, generator=gen, device="cuda",
                      dtype=torch.uint8)
    norm = ReinhardFastNormalizer()
    before = _build.launch_counts()["fused_preprocess"]
    got = fused_preprocess(x, norm, out_dtype=torch.float32)
    assert _build.launch_counts()["fused_preprocess"] == before + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert bool(torch.isfinite(got).all())
    want = fused_preprocess_reference(x, norm)
    assert (got - want).abs().max().item() <= F32_PREPROCESS_TOL
    assert torch.equal(got, fused_preprocess(x, norm,
                                             out_dtype=torch.float32))
    bf = fused_preprocess(x, norm).float()
    assert (got - bf).abs().max().item() <= 2e-2


@pytest.mark.parametrize("n,hw,c,u", [(3, 5, 16, 3), (2, 19, 728, 6),
                                      (1, 45, 16, 3), (2, 7, 8, 3)])
def test_fused_middle_flow_f32(gen, n, hw, c, u):
    x, dw, pw, sc, sh = _middle_inputs(gen, n, hw, c, u, torch.float32)
    before = _build.launch_counts()["fused_middle_flow"]
    got = fused_middle_flow(x, dw, pw, sc, sh)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fused_middle_flow"] == before + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = fused_middle_flow_reference(x, dw, pw, sc, sh)
    assert want.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    tol = F32_MIDDLE_TOL * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    assert torch.equal(got, fused_middle_flow(x, dw, pw, sc, sh))
    rounded = fused_middle_flow_reference(x.to(torch.bfloat16).float(), dw,
                                          pw, sc, sh)
    assert (rounded - want).abs().max().item() > tol
    assert (want.to(torch.bfloat16).float() - want).abs().max().item() > tol


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_fused_block_f32(gen, shape):
    """f32 x through the whole block at the bf16 test's bound, and the
    residual alone (BN1's scale and shift zero: y1 and the pool are exact
    zeros) within 1e-4 of its largest value: the kernel splits x into two
    bf16 terms (2**-16 relative), where x rounded to bf16 (within 2**-8)
    misses that bound, as the plain version on bf16 x shows."""
    n, h, w, cin, f0, f1, relu_first = shape
    wts = _block_weights(gen, cin, f0, f1)
    x = 1.5 * torch.randn((n, h, w, cin), generator=gen, device="cuda")
    before = _build.launch_counts()["fused_block"]
    got = fused_strided_block(x, wts, relu_first)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fused_block"] == before + 1
    want = fused_strided_block_reference(x, wts, relu_first)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (n, -(-h // 2), -(-w // 2), f1)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert torch.equal(got, fused_strided_block(x, wts, relu_first))
    zero = torch.zeros(f1, device="cuda")
    res_only = wts[:6] + (zero, zero) + wts[8:]
    got = fused_strided_block(x, res_only, relu_first)
    want = fused_strided_block_reference(x, res_only, relu_first)
    tol = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    rounded = fused_strided_block_reference(x.to(torch.bfloat16).float(),
                                            res_only, relu_first)
    assert (rounded - want).abs().max().item() > tol


def _f32_tiny():
    """An f32 xception_tiny (32 px, 2 x 32 head, dropout 0, K=4) with
    seeded random weights, its logits spread over 16 random tiles, on the
    CPU; the tiles; the hp."""
    import numpy as np

    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features
    from chip_smoke import decisive_logits_, init_random_

    hp = ModelParams(model="xception_tiny", tile_px=32, hidden_layer_width=32,
                     dropout=0.0, uq=True, uq_samples=4,
                     compute_dtype="float32")
    model = build_model(hp)
    init_random_(torch, model, 0)
    model.eval()
    tiles = np.random.default_rng(0).integers(0, 256, (16, 32, 32, 3),
                                              dtype=np.uint8)
    norm = UncertaintyInterface.from_model(model, hp,
                                           device="cpu").wsi_normalizer
    with torch.no_grad():
        feats = trunk_features(model, inference_preprocess(
            torch.from_numpy(tiles), norm))
    decisive_logits_(torch, model, feats)
    return model, tiles, hp


@pytest.mark.parametrize("fuse_blocks", [False, True])
def test_f32_xception_serves_on_the_card(gen, fuse_blocks):
    """An f32 xception_tiny through ``UncertaintyInterface`` on the card,
    default trunk and ``fuse_blocks=True``: rows 1-3 launch once a call
    (row 4 four times with ``fuse_blocks``); the f32 features of the
    kernels' trunk on the card preprocess's output within 3e-2 of the
    largest of ``model.features`` on the CPU (the kernels round each
    pointwise product's input to bf16, the module trunk does not), and
    the means within 2e-2 of the CPU interface's at dropout 0, spread
    over 0.2 or more."""
    import copy

    import numpy as np

    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    model, tiles, hp = _f32_tiny()
    cpu = UncertaintyInterface.from_model(copy.deepcopy(model), hp,
                                          device="cpu")
    want_m, _ = cpu(tiles, seed=1)
    card = UncertaintyInterface.from_model(copy.deepcopy(model).cuda(), hp,
                                           fuse_blocks=fuse_blocks)
    assert card._fused
    before = _build.launch_counts()
    mean, std = card(tiles, seed=1)
    after = _build.launch_counts()
    for name in after:
        want_n = 1 if name in ("fused_preprocess", "fused_middle_flow",
                               "mcd_head") else 0
        if fuse_blocks and name == "fused_block":
            want_n = 4
        assert after[name] - before[name] == want_n, name
    assert mean.is_cuda and bool(torch.isfinite(mean).all())
    assert np.ptp(want_m[:, 1].numpy()) > 0.2
    torch.testing.assert_close(mean.cpu(), want_m, rtol=0, atol=2e-2)
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        x = inference_preprocess(torch.from_numpy(tiles).cuda(),
                                 card.wsi_normalizer)
        got = trunk_features(card.model, x, True, card._mid_wts, fuse_blocks,
                             card._block_wts)
        want = model.features(x.cpu().float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=3e-2 * want.abs().max().item())


@pytest.mark.parametrize("fuse_blocks", [False, True])
def test_f32_kernels_artifact_equals_the_live_interface(gen, tmp_path,
                                                        fuse_blocks):
    """A kernels servable of an f32 xception_tiny (dropout 0.25) exported
    on the card records f32 where the trunk runs and answers as the live
    interface bit for bit at the same seeds, with rows 1-3 once a call
    (row 4 four times with ``fuse_blocks``)."""
    import io

    from biscuit_torch import serve
    from biscuit_torch.train.uq import UncertaintyInterface

    model_dir, tiles = _servable_model_dir(tmp_path, 0.25, "float32")
    path = serve.export_servable(model_dir, str(tmp_path / "f.biscuit"),
                                 batch_size=16, fuse_blocks=fuse_blocks)
    sv = serve.load_servable(path)
    assert sv.header["use_kernels"] is True
    ep = torch.export.load(io.BytesIO(sv._programs["uq"]))
    trunk_ops = {"fused_middle_flow": 0, "fused_strided_block": 0}
    for node in ep.graph.nodes:
        name = getattr(node.target, "__name__", "").split(".")[0]
        if node.op == "call_function" and name in trunk_ops:
            assert node.meta["val"].dtype == torch.float32, name
            trunk_ops[name] += 1
    assert trunk_ops == {"fused_middle_flow": 1,
                         "fused_strided_block": 4 if fuse_blocks else 0}
    live = UncertaintyInterface(model_dir, fuse_blocks=fuse_blocks)
    assert live.model.compute_dtype == torch.float32
    for seed in (3, 11):
        before = _build.launch_counts()
        got = sv.call_exact(tiles, seed=seed)
        after = _build.launch_counts()
        for name in after:
            want = 1 if name in ("fused_preprocess", "fused_middle_flow",
                                 "mcd_head") else 0
            if fuse_blocks and name == "fused_block":
                want = 4
            assert after[name] - before[name] == want, name
        want = live(tiles, seed=seed)
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g, w)


def test_f32_train_project_on_the_card(gen, tmp_path):
    """``Project.train`` of an f32 xception_tiny (32 px, batch 16, uq=True
    at K=4, dropout 0) on 6 slides of 16 PNG tiles, 3 steps an epoch over
    epochs [1, 2], fold 1 of 3: the f32 model trains on the module path
    (its steps launch only the BatchNorm op's f32 kernels, 22 each way a
    step), its per-epoch predictions run rows
    1-3 once for each of the 2 validation batches of each epoch, and the
    epoch model's ``tile_predictions`` CSV, written on the card, holds
    within 2e-2 of the same model scored on the CPU (the module path
    there)."""
    import os

    import numpy as np
    import pandas as pd

    from biscuit_torch.data.tfrecord import TFRecordWriter
    from biscuit_torch.hp import ModelParams
    from biscuit_torch.project import Project
    from biscuit_torch.train.trainer import score_tiles
    from biscuit_torch.train.uq import UncertaintyInterface
    from chip_smoke import encode_png

    rng = np.random.default_rng(0)
    (tmp_path / "tfr").mkdir()
    for s in range(6):
        with TFRecordWriter(str(tmp_path / "tfr" / f"s{s}.tfrecords")) as w:
            for t in range(16):
                w.write_tile(f"s{s}", encode_png(rng.integers(
                    0, 256, (32, 32, 3), dtype=np.uint8)), loc_x=t, loc_y=s)
    pd.DataFrame({"patient": [f"p{s}" for s in range(6)],
                  "slide": [f"s{s}" for s in range(6)],
                  "cohort": [f"c{s % 2}" for s in range(6)],
                  "site": [f"site{s // 2}" for s in range(6)]}).to_csv(
                      tmp_path / "ann.csv", index=False)
    project = Project(str(tmp_path / "root"),
                      annotations=str(tmp_path / "ann.csv"), create=True)
    project.add_source("SRC", tfrecords=str(tmp_path / "tfr"))
    hp = ModelParams(model="xception_tiny", tile_px=32, tile_um=32,
                     batch_size=16, epochs=[1, 2], early_stop=False,
                     hidden_layer_width=32, dropout=0.0, uq=True,
                     uq_samples=4, augment="xyrjb", compute_dtype="float32")
    before = _build.launch_counts()
    (model_dir,) = project.train("cohort", "f32", params=hp, val_k=[1],
                                 steps_per_epoch_override=3, save_model=True)
    after = _build.launch_counts()
    for name in after:
        want = {"bn_train_fwd": 22 * 6, "bn_train_bwd": 22 * 6}.get(
            name, 2 * 2 if name in ("fused_preprocess", "fused_middle_flow",
                                    "mcd_head") else 0)
        assert after[name] - before[name] == want, name
    ui = UncertaintyInterface(os.path.join(model_dir,
                                           "cohort-f32-HP0-kfold1_epoch2"),
                              device="cpu")
    assert ui.model.compute_dtype == torch.float32
    man = pd.read_csv(os.path.join(model_dir, "slide_manifest.csv"))
    val = sorted(man.loc[man["dataset"] == "validation", "slide"])
    labels = {f"s{s}": s % 2 for s in range(6)}
    _, probs, _ = score_tiles(ui.model, ui.hp, [
        str(tmp_path / "tfr" / f"{s}.tfrecords") for s in val], labels,
        device="cpu")
    csv = pd.read_csv(os.path.join(model_dir,
                                   "tile_predictions_val_epoch2.csv"))
    assert len(csv) == len(probs) == 16 * len(val)
    np.testing.assert_allclose(
        probs, csv[["cohort_y_pred0", "cohort_y_pred1"]], rtol=0, atol=2e-2)
