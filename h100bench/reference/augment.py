"""The training step's random augmentation, a frozen copy of the plain
torch code in ``biscuit_torch/data/augment.py`` (the 'xyrjb' policy: x,
y flips, r cardinal rotation, b Gaussian blur on the standardized batch;
j JPEG re-compression of the raw batch through the 8x8 DCT at IJG
tables). The samplers draw from the step's ``torch.Generator`` in the
order the step draws them, so the reference applies the decisions the
timed step applied. Kept here, unchanged, so that a change to the
program's augmentation shows as a difference from this copy."""

import numpy as np
import torch
import torch.nn.functional as F

BLUR_PROB = 0.1
BLUR_SIGMAS = (0.5, 1.0, 1.5, 2.0)
JPEG_PROB = 0.5
JPEG_QUALITY_RANGE = (50, 100)


def _bcast(mask):
    return mask[:, None, None, None]


def _rot90_batch(imgs, k):
    """Per-image cardinal rotation rot90^k (k in 0..3, as ``jnp.rot90``
    in the H, W plane) of square NHWC images, by a masked transpose and
    two masked flips."""
    if imgs.shape[1] != imgs.shape[2]:
        raise ValueError(
            f"cardinal rotation augmentation needs square tiles, got "
            f"{imgs.shape[1]}x{imgs.shape[2]}")
    x = torch.where(_bcast(k % 2 == 1), imgs.transpose(1, 2), imgs)
    x = torch.where(_bcast((k == 1) | (k == 2)), x.flip(1), x)
    return torch.where(_bcast((k == 2) | (k == 3)), x.flip(2), x)


def _dihedral_batch(imgs, fx, fy, k):
    """Per-image rot90^k . flip_y^fy . flip_x^fx as one masked transpose
    and two masked flips (the JAX package's (t, u, l) decomposition)."""
    odd = k % 2 == 1
    u = ((k == 1) | (k == 2)) ^ (fy & ~odd) ^ (fx & odd)
    lf = ((k == 2) | (k == 3)) ^ (fx & ~odd) ^ (fy & odd)
    x = torch.where(_bcast(odd), imgs.transpose(1, 2), imgs)
    x = torch.where(_bcast(u), x.flip(1), x)
    return torch.where(_bcast(lf), x.flip(2), x)


def _gaussian_kernel(sigma: float, radius: int = 3) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_batch(imgs, sigma_idx, apply):
    """Separable 7-tap Gaussian blur (horizontal, then vertical; zero
    SAME padding) of each NHWC f32 image with its own sigma, kept where
    ``apply``; one grouped convolution per direction over all images."""
    kernels = torch.as_tensor(
        np.stack([_gaussian_kernel(s) for s in BLUR_SIGMAS]),
        device=imgs.device)
    n, h, w, c = imgs.shape
    k = kernels[sigma_idx].repeat_interleave(c, dim=0)      # (N*C, 7)
    t = k.shape[1]
    x = imgs.permute(0, 3, 1, 2).reshape(1, n * c, h, w)
    x = F.conv2d(x, k.reshape(n * c, 1, 1, t), padding=(0, t // 2),
                 groups=n * c)
    x = F.conv2d(x, k.reshape(n * c, 1, t, 1), padding=(t // 2, 0),
                 groups=n * c)
    blurred = x.reshape(n, c, h, w).permute(0, 2, 3, 1)
    return torch.where(_bcast(apply), blurred, imgs)


def sample_augment(n: int, generator, augment: str = "xyrjb", device=None):
    """Per-image decisions of the on-chip policies: ``fx``, ``fy`` (bool
    flips), ``k`` (rotation count) and ``blur`` (bool), ``sigma_idx``
    (index into BLUR_SIGMAS); only the policies named in ``augment``."""
    dev = torch.device("cpu") if device is None else torch.device(device)

    def coin(p):
        return torch.rand(n, generator=generator, device=dev) < p

    out = {}
    if "x" in augment:
        out["fx"] = coin(0.5)
    if "y" in augment:
        out["fy"] = coin(0.5)
    if "r" in augment:
        out["k"] = torch.randint(0, 4, (n,), generator=generator, device=dev)
    if "b" in augment:
        out["blur"] = coin(BLUR_PROB)
        out["sigma_idx"] = torch.randint(0, len(BLUR_SIGMAS), (n,),
                                         generator=generator, device=dev)
    return out


def apply_augment(imgs, decisions):
    """Apply ``sample_augment``'s decisions to an NHWC f32 batch."""
    fx, fy, k = (decisions.get(key) for key in ("fx", "fy", "k"))
    if fx is not None and fy is not None and k is not None \
            and imgs.shape[1] == imgs.shape[2]:
        imgs = _dihedral_batch(imgs, fx, fy, k)
    else:
        if fx is not None:
            imgs = torch.where(_bcast(fx), imgs.flip(2), imgs)
        if fy is not None:
            imgs = torch.where(_bcast(fy), imgs.flip(1), imgs)
        if k is not None:
            imgs = _rot90_batch(imgs, k)
    if "blur" in decisions:
        imgs = _blur_batch(imgs, decisions["sigma_idx"], decisions["blur"])
    return imgs


# ------------------------------------------------------------------ JPEG
# JPEG's lossy core (RGB -> YCbCr, 4:2:0 chroma subsampling, 8x8 DCT,
# quantization at the IJG quality-scaled Annex-K tables, IDCT) as linear
# algebra; the 2-D DCT of a block is one (blocks, 64) x (64, 64) product
# with kron(D8, D8), in f32.

_JPEG_LUMA_BASE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.int64)  # ITU T.81 Annex K.1

_JPEG_CHROMA_BASE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.int64)  # ITU T.81 Annex K.2


def _dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II rows (T.81 section A.3.3 scaling)."""
    n = np.arange(8)
    m = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    m[0] *= 1 / np.sqrt(2)
    return (0.5 * m).astype(np.float32)


def _matmul_f32(a, b):
    """``a @ b`` in full f32 on the card whatever the process's TF32
    setting: with TF32 on, the card would round the operands to 10
    mantissa bits, and quality-99 DC coefficients (~1e3, steps of 1)
    would quantize differently. Only the CUDA matmul's TF32 switch is
    turned off for the call and restored; the process-wide precision is
    neither read nor set (PyTorch refuses to read it once the per-backend
    and the process-wide settings disagree)."""
    if a.device.type != "cuda":
        return torch.matmul(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _jpeg_plane(plane, tbl):
    """Quantize one (N, H, W) f32 sample plane through 8x8 DCT blocks with
    the per-image (N, 64) table; H and W multiples of 8."""
    d8 = _dct8_matrix()
    k64 = torch.as_tensor(np.kron(d8, d8), device=plane.device)
    n, h, w = plane.shape
    b = (plane - 128.0).reshape(n, h // 8, 8, w // 8, 8)
    b = b.permute(0, 1, 3, 2, 4).reshape(n, -1, 64)
    coef = _matmul_f32(b, k64.t())
    deq = torch.round(coef / tbl[:, None, :]) * tbl[:, None, :]
    out = _matmul_f32(deq, k64)
    out = out.reshape(n, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    return torch.clamp(torch.round(out.reshape(n, h, w) + 128.0), 0.0, 255.0)


def _fancy_upsample2(c):
    """2x triangular (3/4, 1/4) upsample in H then W, edge-replicated
    (libjpeg's fancy h2v2 upsampler)."""

    def up_rows(x):
        xp = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
        pairs = torch.stack([0.25 * xp[:, :-2] + 0.75 * xp[:, 1:-1],
                             0.75 * xp[:, 1:-1] + 0.25 * xp[:, 2:]], dim=2)
        return pairs.reshape(x.shape[0], 2 * x.shape[1], x.shape[2])

    c = up_rows(c)
    return up_rows(c.transpose(1, 2)).transpose(1, 2)


def jpeg_tables(q):
    """IJG quality scaling of the Annex-K tables for per-image integer
    qualities ``q`` (N,), in integer arithmetic as libjpeg does -> (luma,
    chroma) f32 tables of shape (N, 64)."""
    q = q.to(torch.int64)
    scale = torch.where(q < 50, 5000 // q, 200 - 2 * q)[:, None]
    luma = torch.as_tensor(_JPEG_LUMA_BASE.reshape(64), device=q.device)
    chroma = torch.as_tensor(_JPEG_CHROMA_BASE.reshape(64), device=q.device)
    tbl_y = torch.clamp(torch.div(luma * scale + 50, 100,
                                  rounding_mode="floor"), 1, 255)
    tbl_c = torch.clamp(torch.div(chroma * scale + 50, 100,
                                  rounding_mode="floor"), 1, 255)
    return tbl_y.float(), tbl_c.float()


def sample_jpeg(n: int, generator, prob: float = JPEG_PROB,
                quality_range: tuple = JPEG_QUALITY_RANGE, device=None):
    """Per-image (apply (N,) bool, quality (N,) int64 in
    [quality_range))."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    apply = torch.rand(n, generator=generator, device=dev) < prob
    q = torch.randint(quality_range[0], quality_range[1], (n,),
                      generator=generator, device=dev)
    return apply, q


def jpeg_apply(imgs, apply, q, subsample: bool = True):
    """Re-compress the images of an (N, H, W, 3) uint8-valued batch where
    ``apply``, at qualities ``q``; the output has the input's dtype."""
    f = imgs.float()
    n, h, w, _ = f.shape
    tbl_y, tbl_c = jpeg_tables(q)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = torch.clamp(torch.round(0.299 * r + 0.587 * g + 0.114 * b), 0.0, 255.0)
    cb = torch.clamp(
        torch.round(128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b),
        0.0, 255.0)
    cr = torch.clamp(
        torch.round(128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b),
        0.0, 255.0)
    mcu = 16 if subsample else 8
    ph, pw = -h % mcu, -w % mcu

    def pad(plane):
        return F.pad(plane[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]

    yq = _jpeg_plane(pad(y), tbl_y)[:, :h, :w]
    if subsample:

        def chroma_plane(c):
            cp = pad(c)
            cd = torch.round(cp.reshape(n, (h + ph) // 2, 2, (w + pw) // 2,
                                        2).mean(dim=(2, 4)))
            return _fancy_upsample2(_jpeg_plane(cd, tbl_c))[:, :h, :w]

        cbq, crq = chroma_plane(cb), chroma_plane(cr)
    else:
        cbq = _jpeg_plane(pad(cb), tbl_c)[:, :h, :w]
        crq = _jpeg_plane(pad(cr), tbl_c)[:, :h, :w]
    cbc, crc = cbq - 128.0, crq - 128.0
    out = torch.stack([yq + 1.402 * crc,
                       yq - 0.344136286 * cbc - 0.714136286 * crc,
                       yq + 1.772 * cbc], dim=-1)
    out = torch.clamp(torch.round(out), 0.0, 255.0)
    out = torch.where(_bcast(apply), out, f)
    return out.to(imgs.dtype)
