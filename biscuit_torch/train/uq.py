"""MC-dropout uncertainty: the trunk once per tile, K head passes.

Counterpart of ``biscuit_tpu/train/uq.py``. The published model's dropout
lives only in the hidden head, so the MC posterior over predictions is
reproduced by running the convolutional trunk once per tile and K
dropout-sampled head passes over the pooled features. ``mc_dropout_full``
runs the naive K full passes for cross-checking.

Backends: on the card the middle flow goes through the fused kernel
(``ops/fused_sepconv.py``) and the head through the MC head kernel
(``ops/mcd_head.py``) when its shape fits the kernel
(``head_kernel_applicable``; other heads run the module head);
``fused_trunk=False`` / ``use_kernel=False`` pick the library-conv middle
flow and the module head instead. The kernels run through their
registered ops (``ops/library.py``), as in an exported servable
(``serve.py``), whose plain head is ``mc_dropout_head_philox``. On the
CPU the defaults are the module paths, as the JAX package defaults to
XLA off the TPU; passing ``True`` runs the kernels' plain versions.
``fuse_blocks`` (default False, as the JAX package without
``BISCUIT_FUSED_BLOCKS=1``) opts into the fully fused trunk, whose entry
and exit blocks go through the fused strided-block kernel
(``ops/fused_block.py``); it implies the fused trunk. Both fused trunks
are Xception's: a ResNet model (``models/resnet.py``) runs the module
trunk and the head kernel, and asking it for a fused trunk raises.

The opt-in w8a8 trunk (``ops/int8_trunk.py``; ``int8_qw=`` here,
``int8_trunk=True`` or ``BISCUIT_INT8_TRUNK=1`` on the interface) is
Xception's too: its stem, entry and exit convs run int8 products, its
middle flow the bf16 fused kernel (``fused_trunk`` picks the backend as
above) unless the weights were calibrated with the middle quantized.
The interface calibrates on its first ``_CALIB_MIN_TILES`` tiles, which
it answers through the path it runs without int8, and can save and load
the scales (``calibration_path``) in the JSON the JAX package writes.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..data.normalize import inference_preprocess, make_normalizer
from ..device import resolve_device
from ..models.xception import ARCHS
from ..tracing import span


def _fused(fused_trunk: Optional[bool], fuse_blocks: bool, on_card: bool,
           arch: str):
    """Whether the trunk is the fused one: ``fuse_blocks`` needs it. Only
    an Xception arch has the fused middle flow, so by default it runs on
    the card for those alone (``biscuit_tpu/train/uq.py:77-81``)."""
    if arch not in ARCHS:
        if fuse_blocks or fused_trunk:
            raise ValueError(f"the fused trunk is Xception's; {arch!r} runs "
                             "the module trunk (fused_trunk=False, "
                             "fuse_blocks=False)")
        return False
    if fuse_blocks:
        if fused_trunk is False:
            raise ValueError("fuse_blocks=True runs the fused trunk; it "
                             "cannot be combined with fused_trunk=False")
        return True
    return on_card if fused_trunk is None else fused_trunk


def trunk_features(model, x, fused_trunk: Optional[bool] = None,
                   mid_wts=None, fuse_blocks: bool = False, block_wts=None):
    """Deterministic pooled f32 features of preprocessed NHWC tiles."""
    if _fused(fused_trunk, fuse_blocks, x.is_cuda, model.arch):
        from ..ops.fused_sepconv import trunk_features_fused

        return trunk_features_fused(model, x, mid_wts, fuse_blocks,
                                    block_wts)
    return model.features(x)


def head_kernel_applicable(head, on_card: bool) -> bool:
    """Whether the MC head kernel takes ``head``: two hidden layers,
    F % 8 == H % 8 == 0 and 0 < C <= ``MAX_CLASSES``, on the card. Every
    other head runs the module head on the same device, as the
    reference's ``_pallas_applicable`` routes by shape; the kernel's
    wrapper still raises on a shape it cannot take."""
    from ..ops.mcd_head import MAX_CLASSES

    if not on_card or head.hidden_layers != 2:
        return False
    f, h = head.hidden0.in_features, head.hidden0.out_features
    c = head.logits.out_features
    return f % 8 == 0 and h % 8 == 0 and 0 < c <= MAX_CLASSES


def mc_dropout_head(model, feats, seed: int = 0, k: int = 30,
                    use_kernel: Optional[bool] = None, head_wts=None):
    """K dropout-sampled head passes over precomputed features ->
    (mean (N, C), std (N, C)) of the softmax."""
    if use_kernel is None:
        use_kernel = head_kernel_applicable(model.head, feats.is_cuda)
    if use_kernel:
        from ..ops import library
        from ..ops.mcd_head import head_weights, seed_tensor

        if head_wts is None:
            head_wts = head_weights(model.head)
        if not isinstance(seed, torch.Tensor):
            seed = seed_tensor(seed)
        return library.mcd_head(feats.float().contiguous(), list(head_wts),
                                seed, k, float(model.dropout))
    gen = torch.Generator(device=feats.device).manual_seed(seed)
    probs = torch.stack([
        torch.softmax(model.head_logits(feats, mc_dropout=True,
                                        generator=gen), dim=-1)
        for _ in range(k)
    ])
    return probs.mean(dim=0), probs.std(dim=0, correction=0)


def mc_dropout_head_philox(model, feats, seed, k: int = 30, head_wts=None):
    """The K head passes with every dropout mask drawn from the MC head
    kernel's Philox stream (``ops/mcd_head.philox_dropout_bits``) keyed by
    ``seed``, an int or a 0-d int64 CPU tensor: the plain head of an
    exported program, where a ``torch.Generator`` cannot be an input. A
    head of the kernel's shape runs the kernel's plain version (its masks
    and bf16 roundings); any other runs the module head's f32 arithmetic,
    hidden layer i masked by the stream's layer i. -> (mean, std)."""
    from ..ops.mcd_head import (
        _threshold,
        head_weights,
        mcd_head_reference,
        philox_dropout_bits,
    )

    head = model.head
    if head_kernel_applicable(head, True):
        if head_wts is None:
            head_wts = head_weights(head)
        return mcd_head_reference(feats, *head_wts, k=k,
                                  dropout=head.dropout, seed=seed)
    h = feats.float()
    keep = 1.0 - head.dropout
    for i in range(head.hidden_layers):
        h = torch.relu(getattr(head, f"hidden{i}")(h))
        if head.dropout > 0:
            drawn = philox_dropout_bits(seed, k, i, h.shape[-2], h.shape[-1],
                                        h.device)
            h = torch.where(drawn >= _threshold(head.dropout), h / keep,
                            torch.zeros_like(h))
    probs = torch.softmax(head.logits(h), dim=-1)
    if probs.ndim == 2:                 # no dropout: every pass is the same
        probs = probs.expand(k, *probs.shape)
    return probs.mean(dim=0), probs.std(dim=0, correction=0)


def mc_dropout_predict(model, x, seed: int = 0, k: int = 30,
                       use_kernel: Optional[bool] = None,
                       fused_trunk: Optional[bool] = None,
                       mid_wts=None, head_wts=None, fuse_blocks: bool = False,
                       block_wts=None, int8_qw=None):
    """(mean softmax, std softmax) over k dropout samples; trunk runs once.
    ``x`` is a preprocessed (normalized + standardized) NHWC batch.
    ``int8_qw``: calibrated w8a8 trunk weights (``ops/int8_trunk.py``,
    ``prepare_int8_trunk`` or ``place_int8_trunk`` of it); the trunk then
    runs int8, ``fused_trunk`` still choosing the middle flow's
    backend. Spans ``serve.trunk`` and ``serve.head`` (``tracing``)."""
    with span("serve.trunk"):
        if int8_qw is not None:
            from ..ops.int8_trunk import trunk_features_int8

            if model.arch not in ARCHS:
                raise ValueError("int8 trunk requires an Xception arch")
            if fuse_blocks:
                raise ValueError(_INT8_FUSE_BLOCKS)
            feats = trunk_features_int8(model, x, int8_qw, fused_trunk,
                                        mid_wts)
        else:
            feats = trunk_features(model, x, fused_trunk, mid_wts,
                                   fuse_blocks, block_wts)
    with span("serve.head"):
        return mc_dropout_head(model, feats, seed, k, use_kernel, head_wts)


_INT8_FUSE_BLOCKS = ("the int8 trunk runs its own strided blocks; it cannot "
                     "be combined with fuse_blocks=True")


def mc_dropout_full(model, x, seed: int = 0, k: int = 30):
    """Naive K full forward passes (reference-equivalent control path)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    probs = torch.stack([
        torch.softmax(model(x, mc_dropout=True, generator=gen), dim=-1)
        for _ in range(k)
    ])
    return probs.mean(dim=0), probs.std(dim=0, correction=0)


class UncertaintyInterface:
    """Per-tile UQ inference over a saved model: callable on a batch of
    RGB tiles, returns (mean softmax, uncertainty); carries
    ``wsi_normalizer``, ``k`` and ``hp``.

    Each call draws its dropout stream from (seed, call number), so calls
    differ and a run repeats from the same seed.

    ``int8_trunk`` (default ``BISCUIT_INT8_TRUNK=1``) serves through the
    w8a8 trunk once calibrated: the first ``calib_tiles`` tiles (default
    ``_CALIB_MIN_TILES``) accumulate the activation ranges and are
    answered exactly as without it. With ``calibration_path``, scales
    saved there for these weights (and the current
    ``BISCUIT_INT8_MIDDLE``) are loaded and the int8 trunk answers from
    the first call; otherwise the frozen scales are saved there.
    """

    _CALIB_MIN_TILES = 256

    def __init__(self, model_path: str, k: Optional[int] = None,
                 device=None, seed: int = 0,
                 use_kernel: Optional[bool] = None,
                 fused_trunk: Optional[bool] = None,
                 fuse_blocks: bool = False,
                 int8_trunk: Optional[bool] = None,
                 calib_tiles: Optional[int] = None,
                 calibration_path: Optional[str] = None):
        from .trainer import load_checkpoint

        model, hp, meta = load_checkpoint(model_path, device)
        self._model_path = model_path
        self._setup(model, hp, meta, k, seed, use_kernel, fused_trunk,
                    fuse_blocks, int8_trunk, calib_tiles, calibration_path)

    @classmethod
    def from_model(cls, model, hp, k: Optional[int] = None, device=None,
                   seed: int = 0, use_kernel: Optional[bool] = None,
                   fused_trunk: Optional[bool] = None,
                   fuse_blocks: bool = False,
                   int8_trunk: Optional[bool] = None,
                   calib_tiles: Optional[int] = None,
                   calibration_path: Optional[str] = None):
        """Build from an in-memory model and its ModelParams (no model
        dir, so a saved calibration carries no weights digest)."""
        obj = cls.__new__(cls)
        obj._model_path = None
        obj._setup(model.to(resolve_device(device)).eval(), hp, {}, k, seed,
                   use_kernel, fused_trunk, fuse_blocks, int8_trunk,
                   calib_tiles, calibration_path)
        return obj

    def _setup(self, model, hp, meta, k, seed, use_kernel, fused_trunk,
               fuse_blocks, int8_trunk, calib_tiles, calibration_path):
        from ..ops.int8_trunk import use_int8_trunk

        self.model, self.hp, self.meta = model, hp, meta
        self.device = next(model.parameters()).device
        self.k = k if k is not None else hp.uq_samples
        self.wsi_normalizer = make_normalizer(hp.normalizer)
        self.seed = int(seed)
        self._calls = 0
        on_card = self.device.type == "cuda"
        self._int8 = bool(use_int8_trunk() if int8_trunk is None
                          else int8_trunk)
        if self._int8 and model.arch not in ARCHS:
            raise ValueError(f"the int8 trunk is Xception's; {model.arch!r} "
                             "runs the module trunk (int8_trunk=False)")
        if self._int8 and fuse_blocks:
            raise ValueError(_INT8_FUSE_BLOCKS)
        self._fused = _fused(fused_trunk, fuse_blocks, on_card, model.arch)
        self._fuse_blocks = bool(fuse_blocks)
        self._use_kernel = (head_kernel_applicable(model.head, on_card)
                            if use_kernel is None else use_kernel)
        # Kernel-layout weights, made once instead of on every call.
        self._mid_wts = self._head_wts = self._block_wts = None
        with torch.no_grad():
            if self._fused:
                from ..ops.fused_sepconv import stack_middle_weights

                self._mid_wts = stack_middle_weights(
                    model.backbone, ARCHS[model.arch]["middle_repeats"])
            if self._fuse_blocks:
                from ..ops.fused_block import stack_block_weights, trunk_blocks

                self._block_wts = [stack_block_weights(b)
                                   for b in trunk_blocks(model.backbone)]
            if self._use_kernel:
                from ..ops.mcd_head import head_weights

                self._head_wts = head_weights(model.head)
        self._qw = self._calib = self._scales = None
        self._digest = None
        self._calibration_path = calibration_path
        if calib_tiles is not None:
            self._CALIB_MIN_TILES = int(calib_tiles)
        if self._int8 and calibration_path is not None and os.path.exists(
                calibration_path):
            scales = self._load_calibration(calibration_path)
            if scales is not None:
                self._freeze(scales, save=False)

    def _freeze(self, scales, save: bool) -> None:
        """Quantize the weights at ``scales`` and serve int8 from now on;
        a saved blob that passed the format and digest checks can still
        lack a site or hold a non-number, and is then recalibrated."""
        from ..ops.int8_trunk import place_int8_trunk, prepare_int8_trunk
        from ..utils_log import log

        try:
            qw = prepare_int8_trunk(self.model, scales)
        except (KeyError, TypeError, ValueError) as e:
            if save:
                raise
            log.warning("int8 calibration at %s is unusable (%s); "
                        "recalibrating", self._calibration_path, e)
            return
        self._scales = scales
        self._qw = place_int8_trunk(qw, self.device)
        self._calib = None
        if save and self._calibration_path is not None:
            try:
                self.save_calibration(self._calibration_path)
            except OSError as e:
                # An unwritable path must not stop serving: the weights
                # are frozen in memory either way.
                log.warning("could not save int8 calibration to %s: %s",
                            self._calibration_path, e)

    def _int8_weights(self, x):
        """Accumulating w8a8 calibration over preprocessed batches
        (``ops/int8_trunk.Int8Calibrator``). Returns None while this
        batch calibrates (the caller answers it without int8)."""
        if self._qw is not None:
            return self._qw
        from ..ops.int8_trunk import Int8Calibrator

        if self._calib is None:
            self._calib = Int8Calibrator(self.model, fused_trunk=self._fused,
                                         mid_wts=self._mid_wts)
        self._calib.update(x)
        if self._calib.n_tiles >= self._CALIB_MIN_TILES:
            self._freeze(self._calib.scales(), save=True)
        return None

    def _weights_digest(self) -> Optional[str]:
        """blake2b of the checkpoint weights (``model.msgpack``), which
        ties saved scales to the weights they were derived from."""
        if self._digest is None and self._model_path is not None:
            from ..serve import _weights_digest

            self._digest = _weights_digest(self._model_path)
        return self._digest

    def _load_calibration(self, path: str):
        """The saved scales, or None (recalibrate) if the file is
        unreadable or unrecognized, was made for other weights, or
        disagrees with the current ``BISCUIT_INT8_MIDDLE``."""
        from ..ops.int8_trunk import use_int8_middle
        from ..utils_log import log

        try:
            with open(path) as f:
                blob = json.load(f)
        except (OSError, ValueError, UnicodeDecodeError) as e:
            log.warning("could not read int8 calibration at %s (%s); "
                        "recalibrating", path, e)
            return None
        if (not isinstance(blob, dict) or
                not isinstance(blob.get("scales"), dict)):
            log.warning("unrecognized int8 calibration format at %s; "
                        "recalibrating", path)
            return None
        if blob.get("weights_blake2b") != self._weights_digest():
            log.warning("int8 calibration at %s was made for different "
                        "weights; recalibrating", path)
            return None
        saved_middle = any(n.startswith("middle") for n in blob["scales"])
        if saved_middle != use_int8_middle():
            log.warning("int8 calibration at %s was made with "
                        "quant_middle=%s but BISCUIT_INT8_MIDDLE is %s; "
                        "recalibrating", path, saved_middle,
                        use_int8_middle())
            return None
        return blob["scales"]

    def save_calibration(self, path: str) -> None:
        """Write the frozen activation scales as JSON (atomically), tagged
        with the weights' digest, for ``calibration_path=`` of another
        process (of either package)."""
        if self._scales is None:
            raise ValueError("int8 calibration has not been frozen yet")
        blob = {
            "version": 1,
            "arch": self.model.arch,
            "weights_blake2b": self._weights_digest(),
            "scales": self._scales,
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(blob, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __call__(self, tiles, seed: Optional[int] = None):
        """tiles: (B, H, W, 3) or (H, W, 3) uint8/float RGB [0,255] ->
        (probs, uncertainty), each (B, C) f32 on the model's device.
        Under a profiler the call records the spans ``serve.copy``,
        ``serve.preprocess``, ``serve.trunk`` and ``serve.head``
        (``tracing``)."""
        if seed is None:
            seed = (self.seed << 32) | (self._calls & 0xFFFFFFFF)
            self._calls += 1
        with span("serve.copy"):
            tiles = torch.as_tensor(tiles).to(self.device)
        if tiles.ndim == 3:
            tiles = tiles[None]
        with torch.inference_mode():
            with span("serve.preprocess"):
                x = inference_preprocess(tiles, self.wsi_normalizer)
            qw = self._int8_weights(x) if self._int8 else None
            return mc_dropout_predict(
                self.model, x, seed, self.k, use_kernel=self._use_kernel,
                fused_trunk=self._fused, mid_wts=self._mid_wts,
                head_wts=self._head_wts, fuse_blocks=self._fuse_blocks,
                block_wts=self._block_wts, int8_qw=qw)
