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
(``ops/fused_block.py``); it implies the fused trunk. The opt-in int8
trunk is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.normalize import inference_preprocess, make_normalizer
from ..device import resolve_device
from ..models.xception import ARCHS


def _fused(fused_trunk: Optional[bool], fuse_blocks: bool, on_card: bool):
    """Whether the trunk is the fused one: ``fuse_blocks`` needs it."""
    if fuse_blocks:
        if fused_trunk is False:
            raise ValueError("fuse_blocks=True runs the fused trunk; it "
                             "cannot be combined with fused_trunk=False")
        return True
    return on_card if fused_trunk is None else fused_trunk


def trunk_features(model, x, fused_trunk: Optional[bool] = None,
                   mid_wts=None, fuse_blocks: bool = False, block_wts=None):
    """Deterministic pooled f32 features of preprocessed NHWC tiles."""
    if _fused(fused_trunk, fuse_blocks, x.is_cuda):
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
                       block_wts=None):
    """(mean softmax, std softmax) over k dropout samples; trunk runs once.
    ``x`` is a preprocessed (normalized + standardized) NHWC batch."""
    feats = trunk_features(model, x, fused_trunk, mid_wts, fuse_blocks,
                           block_wts)
    return mc_dropout_head(model, feats, seed, k, use_kernel, head_wts)


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
    """

    def __init__(self, model_path: str, k: Optional[int] = None,
                 device=None, seed: int = 0,
                 use_kernel: Optional[bool] = None,
                 fused_trunk: Optional[bool] = None,
                 fuse_blocks: bool = False):
        from .trainer import load_checkpoint

        model, hp, meta = load_checkpoint(model_path, device)
        self._setup(model, hp, meta, k, seed, use_kernel, fused_trunk,
                    fuse_blocks)

    @classmethod
    def from_model(cls, model, hp, k: Optional[int] = None, device=None,
                   seed: int = 0, use_kernel: Optional[bool] = None,
                   fused_trunk: Optional[bool] = None,
                   fuse_blocks: bool = False):
        """Build from an in-memory model and its ModelParams."""
        obj = cls.__new__(cls)
        obj._setup(model.to(resolve_device(device)).eval(), hp, {}, k, seed,
                   use_kernel, fused_trunk, fuse_blocks)
        return obj

    def _setup(self, model, hp, meta, k, seed, use_kernel, fused_trunk,
               fuse_blocks):
        self.model, self.hp, self.meta = model, hp, meta
        self.device = next(model.parameters()).device
        self.k = k if k is not None else hp.uq_samples
        self.wsi_normalizer = make_normalizer(hp.normalizer)
        self.seed = int(seed)
        self._calls = 0
        on_card = self.device.type == "cuda"
        self._fused = _fused(fused_trunk, fuse_blocks, on_card)
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

    def __call__(self, tiles, seed: Optional[int] = None):
        """tiles: (B, H, W, 3) or (H, W, 3) uint8/float RGB [0,255] ->
        (probs, uncertainty), each (B, C) f32 on the model's device."""
        if seed is None:
            seed = (self.seed << 32) | (self._calls & 0xFFFFFFFF)
            self._calls += 1
        tiles = torch.as_tensor(tiles).to(self.device)
        if tiles.ndim == 3:
            tiles = tiles[None]
        with torch.inference_mode():
            x = inference_preprocess(tiles, self.wsi_normalizer)
            return mc_dropout_predict(
                self.model, x, seed, self.k, use_kernel=self._use_kernel,
                fused_trunk=self._fused, mid_wts=self._mid_wts,
                head_wts=self._head_wts, fuse_blocks=self._fuse_blocks,
                block_wts=self._block_wts)
