"""w8a8 (int8 weights and int8 activations) Xception trunk for inference.

Counterpart of ``biscuit_tpu/ops/int8_trunk.py``: an opt-in serving path
(``BISCUIT_INT8_TRUNK=1`` or ``UncertaintyInterface(..., int8_trunk=True)``)
that quantizes the trunk's dense convs, the two stem convs and every
pointwise and residual conv of the entry and exit flows:

    ... -> relu(bf16) -> dw3x3 (bf16 operands, f32 out) -> quantize
        -> pw1x1 (int8 x int8 -> int32)
        -> dequant (* s_in*s_w[c]*bn_scale[c] + bn_shift[c]) -> bf16 -> ...

Post-training quantization, symmetric: weights per output channel
(absmax/127, the BatchNorm folded into the dequant factor), activations
per tensor with scales calibrated from f32 forwards (the running absmax
at each quantization site, ``Int8Calibrator``). The middle flow keeps the
bf16 fused kernel by default (``_middle_fn``); ``BISCUIT_INT8_MIDDLE=1``
/ ``quant_middle=True`` quantizes its pointwise convs too.

Host side (``_fold_trunk``, ``prepare_int8_trunk``, ``Int8Calibrator.
scales``) is numpy in the JAX package's operation order and dtypes, so
the folded and quantized weights equal the JAX package's bit for bit
from the same scales and parameters. ``place_int8_trunk`` lays them out
for the device once.

Device side, NHWC throughout:

* the int8 product is ``torch._int_mm`` (cuBLASLt on the card) on
  ``(rows, K) x (K, Cout)``: a 1x1 stride-1 conv on the NHWC rows, the
  1x1 stride-2 residual on ``x[:, ::2, ::2]`` (SAME pads nothing for a
  1x1 kernel), the 3x3 VALID stem convs through an im2col in
  (dy, dx, cin) order. On the card its operands must have more than 16
  rows and inner and output sizes that are multiples of 8: the rows,
  the inner size (27 for ``conv1``) and the output channels are
  zero-padded to meet that, which changes no sum. On a CUDA tensor the
  product runs on the card or raises; it never falls back to f32.
* the depthwise takes bf16 operands and returns f32, as the JAX
  package's ``preferred_element_type``: it runs as an f32 grouped conv
  of the bf16-rounded operands (each product is exact in f32 and in
  TF32), and the quantizer reads that f32.
* ``_act`` rounds each dequantized conv output to bf16, in calibrate mode
  too, so calibration sees the bf16 activations the int8 mode quantizes.
* rounding is half to even (``torch.round``, as ``jnp.round``).
* the max-pool is ``models/xception.max_pool_same`` (3x3/2 SAME, -inf
  padding at even sizes).

The first conv quantizes what the preprocess gives, as the JAX package's
path does on each backend: on the card the preprocess kernel's bf16
output (the JAX package's fused preprocess on the TPU is bf16 too), on
the CPU the exact f32 chain.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

_CDTYPE = torch.bfloat16  # dtype of the non-quantized (depthwise/pool) ops
_MIN_ROWS = 17            # the card's int8 GEMM wants more than 16 rows


def use_int8_trunk() -> bool:
    return os.environ.get("BISCUIT_INT8_TRUNK") == "1"


def use_int8_middle() -> bool:
    """Quantize the middle flow's pointwise convs too
    (``BISCUIT_INT8_MIDDLE=1``); by default the middle flow stays the
    bf16 fused kernel."""
    return os.environ.get("BISCUIT_INT8_MIDDLE") == "1"


# ---------------------------------------------------------------------------
# Weight folding: the model's state -> flat per-conv dict, BN folded (host).
# ---------------------------------------------------------------------------


def _fold_trunk(model, arch_cfg, include_middle: bool = False
                ) -> Dict[str, Any]:
    """Flatten stem + entry + exit weights (and the middle's with
    ``include_middle``) with each conv's following BN folded to (scale,
    shift), in host numpy from one copy of the backbone's state. Conv
    kernels are f32 HWIO arrays, as the JAX package's; depthwise kernels
    pass through as bf16 (3, 3, 1, C) tensors (their BN sits after the
    pointwise). The fold is Flax BatchNorm's, eps 1e-5."""
    state = {k: v.detach().float().cpu().numpy()
             for k, v in model.backbone.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    fw: Dict[str, Any] = {}

    def hwio(name):
        return np.ascontiguousarray(state[f"{name}.weight"].transpose(
            2, 3, 1, 0))

    def conv_bn(site, conv, bn):
        scale = (state[f"{bn}.weight"].astype(np.float32) / np.sqrt(
            state[f"{bn}.running_var"].astype(np.float32) + 1e-5))
        shift = (state[f"{bn}.bias"].astype(np.float32)
                 - state[f"{bn}.running_mean"].astype(np.float32) * scale)
        fw[site] = {"k": hwio(conv), "bn_scale": scale, "bn_shift": shift}

    def dw(name):
        return torch.from_numpy(hwio(name)).to(_CDTYPE)

    conv_bn("conv1", "conv1", "conv1_bn")
    conv_bn("conv2", "conv2", "conv2_bn")

    def fold_sep(prefix, j):
        fw[f"{prefix}.dw{j}"] = dw(f"{prefix}.sep{j}.depthwise")
        conv_bn(f"{prefix}.pw{j}", f"{prefix}.sep{j}.pointwise",
                f"{prefix}.bn{j}")

    def block(prefix, n_seps):
        conv_bn(f"{prefix}.res", f"{prefix}.res_conv", f"{prefix}.res_bn")
        for j in range(n_seps):
            fold_sep(prefix, j)

    for i in range(len(arch_cfg["entry_blocks"])):
        block(f"entry{i}", 2)
    if include_middle:
        # _middle_quant hard-codes an identity residual, which holds only
        # when the middle width equals the last entry-block width.
        assert arch_cfg["middle_width"] == arch_cfg["entry_blocks"][-1], (
            "quantized middle flow assumes an identity residual "
            "(middle_width == last entry width)")
        for i in range(arch_cfg["middle_repeats"]):
            for j in range(3):
                fold_sep(f"middle{i}", j)
    block("exit_block", 2)
    for i in range(len(arch_cfg["exit_convs"])):
        fw[f"exit_sep{i}.dw"] = dw(f"exit_sep{i}.depthwise")
        conv_bn(f"exit_sep{i}.pw", f"exit_sep{i}.pointwise", f"exit_bn{i}")
    return fw


def prepare_int8_trunk(model, scales: Dict[str, float]) -> Dict[str, Any]:
    """Quantize weights (per output channel, symmetric) and pre-combine
    the dequant factors ``eff[c] = s_in * s_w[c] * bn_scale[c]``, in host
    numpy. The calibration sites say which convs are quantized: middle
    entries appear iff the calibrator ran with ``quant_middle``."""
    from ..models.xception import ARCHS

    cfg = ARCHS[model.arch]
    quant_middle = any(n.startswith("middle") for n in scales)
    fw = _fold_trunk(model, cfg, include_middle=quant_middle)
    qw: Dict[str, Any] = {}
    for name, w in fw.items():
        if not isinstance(w, dict):  # depthwise kernel: pass through bf16
            qw[name] = w
            continue
        s_in = scales[name]
        k = w["k"]
        s_w = np.maximum(
            np.max(np.abs(k), axis=(0, 1, 2)) / 127.0, 1e-12)
        qk = np.clip(np.round(k / s_w), -127.0, 127.0).astype(np.int8)
        qw[name] = {
            "k": qk,
            "inv_s_in": np.float32(1.0 / s_in),
            "eff": (s_in * s_w * w["bn_scale"]).astype(np.float32),
            "shift": w["bn_shift"].astype(np.float32),
        }
    return qw


def _pad_to(n: int, m: int = 8) -> int:
    return -(-n // m) * m


def place_int8_trunk(weights: Dict[str, Any], device) -> Dict[str, Any]:
    """Lay folded (``_fold_trunk``) or quantized (``prepare_int8_trunk``)
    weights out on ``device``, once: an int8 conv's kernel as a
    contiguous (Cout', K') int8 matrix, K = kh*kw*Cin in (dy, dx, cin)
    order, both zero-padded to multiples of 8; an f32 conv's as OIHW;
    depthwise kernels as bf16 (C, 1, 3, 3)."""
    dev = torch.device(device)
    out: Dict[str, Any] = {"_device": dev}
    for name, w in weights.items():
        if name == "_device":
            continue
        if not isinstance(w, dict):
            out[name] = w.permute(3, 2, 0, 1).contiguous().to(dev)
            continue
        kh, kw, cin, cout = w["k"].shape
        if "inv_s_in" not in w:
            out[name] = {
                "k": torch.from_numpy(np.ascontiguousarray(
                    w["k"].transpose(3, 2, 0, 1))).to(dev),
                "bn_scale": torch.from_numpy(w["bn_scale"]).to(dev),
                "bn_shift": torch.from_numpy(w["bn_shift"]).to(dev),
                "kh": kh,
            }
            continue
        mat = np.zeros((_pad_to(cout), _pad_to(kh * kw * cin)), np.int8)
        mat[:cout, :kh * kw * cin] = w["k"].reshape(-1, cout).T
        out[name] = {
            "wt": torch.from_numpy(mat).to(dev),
            "cout": cout, "kh": kh,
            # An f32 value: multiplying an f32 tensor by it is the f32
            # product the JAX package computes.
            "inv_s_in": float(w["inv_s_in"]),
            "eff": torch.from_numpy(w["eff"]).to(dev),
            "shift": torch.from_numpy(w["shift"]).to(dev),
        }
    return out


# ---------------------------------------------------------------------------
# The shared forward. qw None runs calibrate mode (f32 convs, per-site
# absmax); otherwise each dense conv's input is quantized.
# ---------------------------------------------------------------------------


def int8_matmul(a, wt):
    """(M, K) int8 x (N, K)^T int8 -> (M, N) int32, exact: cuBLASLt's
    int8 GEMM on the card (``torch._int_mm``, its second operand column
    major), the same call on the CPU. On the card M is zero-padded past
    16 rows; K and N must already be multiples of 8."""
    m = a.shape[0]
    if a.is_cuda and m < _MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_MIN_ROWS - m, a.shape[1]))])
    return torch._int_mm(a, wt.t())[:m]


def _im2col(q, k: int, stride: int):
    """VALID k x k patches of NHWC ``q`` as (N*Ho*Wo, k*k*C) rows in
    (dy, dx, c) order."""
    n, h, w, c = q.shape
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    cols = [q[:, dy:dy + stride * (ho - 1) + 1:stride,
              dx:dx + stride * (wo - 1) + 1:stride, :]
            for dy in range(k) for dx in range(k)]
    return torch.stack(cols, dim=3).reshape(n * ho * wo, k * k * c), (
        n, ho, wo)


def _int8_conv(q, w, stride: int):
    """Int32 accumulators of an int8 NHWC conv with a placed kernel: 1x1
    (stride 1 or 2; SAME pads nothing) or k x k VALID."""
    if w["kh"] == 1:
        if stride != 1:
            q = q[:, ::stride, ::stride, :]
        n, h, wd, c = q.shape
        rows, shape = q.reshape(n * h * wd, c), (n, h, wd)
    else:
        rows, shape = _im2col(q, w["kh"], stride)
    k_pad = w["wt"].shape[1]
    if rows.shape[1] != k_pad:
        rows = F.pad(rows, (0, k_pad - rows.shape[1]))
    acc = int8_matmul(rows.contiguous(), w["wt"])[:, :w["cout"]]
    return acc.reshape(*shape, w["cout"])


def _mxu_conv(h, site, fw, qw, sites, *, stride: int = 1):
    """One quantization-wrapped dense conv (+ folded BN). In calibrate
    mode records absmax(h) and computes in f32; in int8 mode quantizes."""
    if qw is None:
        sites[site] = h.abs().amax().float()
        w = fw[site]
        y = F.conv2d(h.float().permute(0, 3, 1, 2), w["k"], None, stride)
        return y.permute(0, 2, 3, 1) * w["bn_scale"] + w["bn_shift"]
    w = qw[site]
    q = torch.clamp(torch.round(h.float() * w["inv_s_in"]),
                    -127.0, 127.0).to(torch.int8)
    y = _int8_conv(q, w, stride)
    return y.float() * w["eff"] + w["shift"]


def _dw_conv(h, kernel):
    """Depthwise 3x3 SAME of bf16-rounded operands, f32 out (NHWC)."""
    x = h.to(_CDTYPE).float().permute(0, 3, 1, 2)
    y = F.conv2d(x, kernel.float(), None, 1, 1, 1, x.shape[1])
    return y.permute(0, 2, 3, 1)


def _maxpool(h):
    from ..models.xception import max_pool_same

    return max_pool_same(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _act(y):
    """Post-dequant cast back to the compute dtype."""
    return y.to(_CDTYPE)


def _dwk(fw, qw, name):
    return (qw if qw is not None else fw)[name]


def _block(h, prefix, fw, qw, sites, *, relu_first):
    """XceptionBlock(features=(f, f), strides=2)."""
    residual = _act(_mxu_conv(h, f"{prefix}.res", fw, qw, sites, stride=2))
    g = h
    for j in range(2):
        if j > 0 or relu_first:
            g = torch.relu(g)
        g = _dw_conv(g, _dwk(fw, qw, f"{prefix}.dw{j}"))
        g = _act(_mxu_conv(g, f"{prefix}.pw{j}", fw, qw, sites))
    return _maxpool(g) + residual


def _middle_quant(h, fw, qw, sites, n_blocks):
    """w8a8 middle flow: identity-residual blocks of relu -> bf16 dw ->
    int8 pw (+ folded BN), XceptionBlock(strides=1, relu_first=True)."""
    for i in range(n_blocks):
        g = h
        for j in range(3):
            g = torch.relu(g)
            g = _dw_conv(g, _dwk(fw, qw, f"middle{i}.dw{j}"))
            g = _act(_mxu_conv(g, f"middle{i}.pw{j}", fw, qw, sites))
        h = g + h
    return h


def _forward(x, fw, qw, arch_cfg, middle_fn, quant_middle: bool = False):
    """stem + entry (+ middle through ``middle_fn``, or quantized here
    with ``quant_middle``) + exit -> pooled f32 features, as
    ``XceptionBackbone.forward`` with inference BN folded. Returns
    (feats, sites)."""
    sites: Dict[str, torch.Tensor] = {}
    h = _act(_mxu_conv(x.float(), "conv1", fw, qw, sites, stride=2))
    h = torch.relu(h)
    h = _act(_mxu_conv(h, "conv2", fw, qw, sites))
    h = torch.relu(h)
    for i in range(len(arch_cfg["entry_blocks"])):
        h = _block(h, f"entry{i}", fw, qw, sites, relu_first=(i != 0))

    if quant_middle:
        h = _middle_quant(h, fw, qw, sites, arch_cfg["middle_repeats"])
    else:
        h = middle_fn(h.contiguous())

    h = _block(h, "exit_block", fw, qw, sites, relu_first=True)
    for i in range(len(arch_cfg["exit_convs"])):
        g = _dw_conv(h, _dwk(fw, qw, f"exit_sep{i}.dw"))
        h = _act(_mxu_conv(g, f"exit_sep{i}.pw", fw, qw, sites))
        h = torch.relu(h)
    # Flax means in f32 and rounds to the compute dtype before .f32.
    return h.float().mean(dim=(1, 2)).to(_CDTYPE).float(), sites


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _middle_fn(model, fused: Optional[bool], on_card: bool,
               mid_wts=None) -> Callable:
    """The middle flow as the bf16 path runs it: the fused kernel
    (through its registered op) on the card, the module middle on the
    CPU; ``fused`` overrides the choice as ``mc_dropout_predict``'s
    ``fused_trunk`` does (on the CPU the kernel's plain version runs)."""
    from ..models.xception import ARCHS

    if fused is None:
        fused = on_card
    if fused:
        from . import library
        from .fused_sepconv import stack_middle_weights

        if mid_wts is None:
            mid_wts = stack_middle_weights(
                model.backbone, ARCHS[model.arch]["middle_repeats"])
        return lambda h: library.fused_middle_flow(h, *mid_wts)
    return lambda h: model.trunk_middle(h.to(_CDTYPE))


class Int8Calibrator:
    """Accumulating activation-range calibration: f32 forwards over
    preprocessed batches, keeping each site's running absmax, so the
    range is built from many batches (``UncertaintyInterface`` feeds it
    the first >= 256 tiles) rather than whichever arrives first."""

    def __init__(self, model, fused_trunk: Optional[bool] = None,
                 quant_middle: Optional[bool] = None, mid_wts=None):
        from ..models.xception import ARCHS

        if quant_middle is None:
            quant_middle = use_int8_middle()
        self._model = model
        self._cfg = ARCHS[model.arch]
        self._quant_middle = quant_middle
        dev = next(model.parameters()).device
        self._fw = place_int8_trunk(
            _fold_trunk(model, self._cfg, include_middle=quant_middle), dev)
        self._mid = (None if quant_middle else
                     _middle_fn(model, fused_trunk, dev.type == "cuda",
                                mid_wts))
        self._absmax: Dict[str, float] = {}
        self.n_tiles = 0

    def update(self, x) -> None:
        """Fold one preprocessed batch into the running per-site absmax
        (one device-to-host copy of all the sites)."""
        with torch.inference_mode():
            sites = _forward(x, self._fw, None, self._cfg, self._mid,
                             quant_middle=self._quant_middle)[1]
            values = torch.stack(list(sites.values())).cpu().tolist()
        for k, v in zip(sites, values):
            self._absmax[k] = max(float(v), self._absmax.get(k, 0.0))
        self.n_tiles += int(x.shape[0])

    def scales(self) -> Dict[str, float]:
        """{site: activation_scale} (absmax/127, floored so a dead site
        cannot divide by zero)."""
        if not self._absmax:
            raise ValueError("Int8Calibrator.scales() before any update()")
        return {k: max(v / 127.0, 1e-8) for k, v in self._absmax.items()}


def calibrate_int8_trunk(model, x_sample, fused_trunk: Optional[bool] = None,
                         quant_middle: Optional[bool] = None
                         ) -> Dict[str, float]:
    """One-shot calibration over a single representative batch (see
    ``Int8Calibrator`` for the accumulating form)."""
    cal = Int8Calibrator(model, fused_trunk, quant_middle)
    cal.update(x_sample)
    return cal.scales()


def trunk_features_int8(model, x, qw, fused_trunk: Optional[bool] = None,
                        mid_wts=None):
    """Pooled trunk features through the w8a8 stem/entry/exit and the
    bf16 middle flow (or the w8a8 middle when ``qw`` carries middle
    entries). ``x`` is the preprocessed batch; ``qw`` is
    ``prepare_int8_trunk``'s result, or ``place_int8_trunk`` of it on
    x's device."""
    from ..models.xception import ARCHS

    cfg = ARCHS[model.arch]
    if "_device" not in qw:
        qw = place_int8_trunk(qw, x.device)
    quant_middle = any(n.startswith("middle") for n in qw)
    mid = (None if quant_middle
           else _middle_fn(model, fused_trunk, x.is_cuda, mid_wts))
    with torch.inference_mode():
        feats, _ = _forward(x, None, qw, cfg, mid, quant_middle=quant_middle)
    return feats
