"""Single-file servables: the whole UQ inference program in one artifact
(``torch.export``).

Counterpart of ``biscuit_tpu/serve.py``. The program

    uint8 tiles -> stain normalize + standardize -> Xception trunk
    -> K MC-dropout head passes -> (softmax mean, uncertainty)

is traced once with the trained weights in it and written, with a JSON
header, into one file. A later process loads it and scores tiles with no
checkpoint and no model code: ``load_servable(path)(tiles)``.

Kernels or portable:

* ``use_kernels=None`` (default) puts the serving kernels in the program
  when exporting on the card: the preprocess, the middle flow and the MC
  head (and the strided blocks with ``fuse_blocks=True``), each as its
  registered op (``ops/library.py``). Such an artifact runs only on the
  device it was exported on, and loading it needs ``biscuit_torch``
  importable, which registers the ops.
* ``use_kernels=False`` puts in no custom op: the exact f32 preprocess,
  the module trunk and the head's plain Philox version
  (``train/uq.mc_dropout_head_philox``). That artifact runs on the CPU
  and on the card (``platforms=["cuda", "cpu"]``); it is exported on the
  CPU and moved to the card when loaded there.
* ``use_kernels=True`` on the CPU exports the op graph, whose ops run
  their plain versions there.

The program has a static batch, ``(tiles (batch_size, px, px, 3) uint8
on the export device, seed 0-d int64 on the CPU)``: ``Servable`` pads the
last partial batch and strips the padding, so callers keep the
``UncertaintyInterface`` contract (any n tiles in, n rows out). The seed
is an input of the program, so each call draws its own masks.

The container is the JAX package's (magic, 8-byte header length, JSON
header with the programs' offsets and blake2b checksums, then the
bodies), each body a ``torch.export.save``. Its ``format_version`` is
the string ``"torch-1"``, so the JAX package's reader refuses a port
artifact, and this one refuses the JAX package's versions 1 and 2.
``torch.export``'s file format is not promised across PyTorch versions:
export where you serve, or with the same PyTorch.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_MAGIC = b"BISCUIT-SERVABLE\n"
FORMAT_VERSION = "torch-1"
_JAX_VERSIONS = (1, 2)
_ITEM_9 = ("is not ported yet (ROADMAP.md Queue 1 item 9, parallelism): "
           "use load_servable and predict_tfrecords/predict_slides in one "
           "process")


def _weights_digest(model_path: str) -> Optional[str]:
    """blake2b of the checkpoint weights (``model.msgpack``)."""
    p = os.path.join(model_path, "model.msgpack")
    if not os.path.exists(p):
        return None
    h = hashlib.blake2b(digest_size=16)
    with open(p, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class _Program(torch.nn.Module):
    """What an artifact's program computes; the kernels' weights are
    stacked once, here, and held as buffers (constants of the export)."""

    def __init__(self, model, normalizer, k: int, use_kernels: bool,
                 fuse_blocks: bool, features: bool):
        from .data.normalize import ReinhardFastNormalizer
        from .models.xception import ARCHS
        from .train.uq import head_kernel_applicable

        super().__init__()
        self.model = model
        self.normalizer = normalizer
        self.k = int(k)
        self.features = features
        self.use_kernels = use_kernels
        self.fuse_blocks = fuse_blocks
        self.kernel_preprocess = (use_kernels and type(normalizer)
                                  is ReinhardFastNormalizer)
        self.kernel_head = use_kernels and head_kernel_applicable(
            model.head, True)
        dev = next(model.parameters()).device
        with torch.no_grad():
            if self.kernel_preprocess:
                from .ops.fused_preprocess import coefficients

                self.register_buffer("coef",
                                     coefficients(normalizer, dev).clone())
            self.mid_wts = self.block_wts = self.head_wts = None
            if use_kernels:
                from .ops.fused_sepconv import stack_middle_weights

                self.mid_wts = self._hold("mid", stack_middle_weights(
                    model.backbone, ARCHS[model.arch]["middle_repeats"]))
            if fuse_blocks:
                from .ops.fused_block import stack_block_weights, trunk_blocks

                self.block_wts = [
                    self._hold(f"block{i}", stack_block_weights(b))
                    for i, b in enumerate(trunk_blocks(model.backbone))]
            if head_kernel_applicable(model.head, True):
                from .ops.mcd_head import head_weights

                self.head_wts = self._hold("head", head_weights(model.head))

    def _hold(self, prefix: str, tensors):
        names = []
        for i, t in enumerate(tensors):
            self.register_buffer(f"{prefix}_{i}", t.contiguous().clone())
            names.append(f"{prefix}_{i}")
        return names

    def _get(self, names):
        return [getattr(self, n) for n in names]

    def preprocess(self, tiles):
        from .data.normalize import per_image_standardization

        if self.kernel_preprocess:
            from .ops import library

            return library.fused_preprocess(tiles, self.coef)
        x = tiles.float()
        if self.normalizer is not None:
            x = self.normalizer(x)
        return per_image_standardization(x)

    def forward(self, tiles, seed):
        from .train.uq import mc_dropout_head, mc_dropout_head_philox

        x = self.preprocess(tiles)
        if self.use_kernels:
            from .ops.fused_sepconv import trunk_features_fused

            blocks = (None if self.block_wts is None
                      else [self._get(b) for b in self.block_wts])
            feats = trunk_features_fused(self.model, x,
                                         self._get(self.mid_wts),
                                         self.fuse_blocks, blocks)
        else:
            feats = self.model.features(x)
        head = None if self.head_wts is None else self._get(self.head_wts)
        if self.kernel_head:
            mean, std = mc_dropout_head(self.model, feats, seed, self.k,
                                        use_kernel=True, head_wts=head)
        else:
            mean, std = mc_dropout_head_philox(self.model, feats, seed,
                                               self.k, head)
        return (feats, mean, std) if self.features else (mean, std)


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its card's index ("cuda" -> "cuda:0"), as a program's
    constants record it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def export_servable(
    model_path: str,
    out_path: Optional[str] = None,
    batch_size: int = 64,
    k: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    use_kernels: Optional[bool] = None,
    fuse_blocks: bool = False,
    with_features: bool = True,
    features_k: int = 8,
    device=None,
) -> str:
    """Export a saved model dir to a single-file UQ servable.

    Args:
        model_path: trained model directory (params.json + model.msgpack).
        out_path: artifact file (default ``<model_path>/servable.biscuit``).
        batch_size: static batch of the exported program; ``Servable``
            pads and chunks around it.
        k: MC-dropout samples (default: the model's ``hp.uq_samples``).
        platforms: the device types the artifact runs on: ``["cuda"]``,
            ``["cpu"]`` or both. Default: the export device's. An
            artifact with the kernels lists only its export device.
        use_kernels: put the serving kernels' ops in the program (None:
            when exporting on the card; False: a portable program).
        fuse_blocks: run the strided blocks through their kernel too
            (needs the kernels).
        with_features: also export a feature program ``(tiles, seed) ->
            (pooled trunk features, mean, std)``, so that
            ``mosaic.generate_features`` runs off the artifact.
        features_k: MC-dropout samples of the feature program's head.
        device: where the program is traced and its weights live (the
            card unless ``device="cpu"``).

    Returns the artifact path.
    """
    from .data.normalize import make_normalizer
    from .device import resolve_device
    from .ops.mcd_head import seed_tensor
    from .train.trainer import load_checkpoint

    dev = _indexed(resolve_device(device))
    if use_kernels is None:
        use_kernels = dev.type == "cuda"
    platforms = [dev.type] if platforms is None else list(platforms)
    unknown = [p for p in platforms if p not in ("cuda", "cpu")]
    if unknown or not platforms:
        raise ValueError(f"platforms are 'cuda' and/or 'cpu', got {platforms}")
    if use_kernels and platforms != [dev.type]:
        raise ValueError(
            f"an artifact with the kernels runs only on its export device "
            f"({dev.type}); got platforms={platforms}: pass "
            "use_kernels=False for a portable artifact")
    if fuse_blocks and not use_kernels:
        raise ValueError("fuse_blocks=True runs the strided-block kernel; "
                         "it cannot be combined with use_kernels=False")
    model, hp, meta = load_checkpoint(model_path, dev)
    k = int(k if k is not None else hp.uq_samples)
    normalizer = make_normalizer(hp.normalizer)
    tiles = torch.zeros((batch_size, hp.tile_px, hp.tile_px, 3),
                        dtype=torch.uint8, device=dev)
    args = (tiles, seed_tensor(0))

    def export(n_passes, features):
        prog = _Program(model, normalizer, n_passes, use_kernels,
                        fuse_blocks, features).eval()
        with torch.no_grad():
            ep = torch.export.export(prog, args, strict=False)
        # The example batch would be saved with the program (68 MB at
        # 256 tiles of 299 px); the loader needs only its shapes.
        ep.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        return buf.getvalue()

    blobs = {"uq": export(k, False)}
    if with_features:
        blobs["features"] = export(int(features_k), True)

    header = {
        "format_version": FORMAT_VERSION,
        "arch": model.arch,
        "tile_px": hp.tile_px,
        "tile_um": hp.tile_um,
        "batch_size": batch_size,
        "k": k,
        "features_k": int(features_k) if with_features else None,
        "normalizer": hp.normalizer,
        "platforms": platforms,
        "device": str(dev),
        "seed_dtype": "int64",
        "torch_version": torch.__version__,
        "weights_blake2b": _weights_digest(model_path),
        "use_kernels": bool(use_kernels),
        "fuse_blocks": bool(fuse_blocks),
        # The training-time class order, where the checkpoint recorded it
        # (cli/predict.py validates label derivation against it).
        "outcome_labels": meta.get("outcome_labels"),
    }
    programs, checksums, off = {}, {}, 0
    for name, blob in blobs.items():
        programs[name] = [off, len(blob)]
        checksums[name] = hashlib.blake2b(blob, digest_size=16).hexdigest()
        off += len(blob)
    header["programs"] = programs
    header["checksums"] = checksums
    if out_path is None:
        out_path = os.path.join(model_path, "servable.biscuit")
    hdr = json.dumps(header).encode()
    tmp = f"{out_path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(len(hdr).to_bytes(8, "little"))
            f.write(hdr)
            for blob in blobs.values():
                f.write(blob)
        os.replace(tmp, out_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return out_path


def is_servable_artifact(path) -> bool:
    """True if ``path`` is a servable container: the magic bytes, whatever
    the name (cli/export.py ``-o``)."""
    if not isinstance(path, (str, os.PathLike)) or not os.path.isfile(path):
        return False
    try:
        with open(path, "rb") as f:
            return f.read(len(_MAGIC)) == _MAGIC
    except OSError:
        return False


def _read_container(path: str) -> Tuple[dict, dict]:
    """(header, {program name: serialized program})."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a biscuit servable "
                             f"(bad magic {magic!r})")
        n = int.from_bytes(f.read(8), "little")
        if n <= 0 or n > (1 << 20):
            raise ValueError(f"{path}: implausible header length {n}")
        header = json.loads(f.read(n))
        version = header.get("format_version")
        if version in _JAX_VERSIONS:
            raise ValueError(
                f"{path}: servable format {version} is the JAX package's "
                "(biscuit_tpu.serve, jax.export); load it with "
                "biscuit_tpu.serve.load_servable, or export the model dir "
                "with biscuit_torch.serve.export_servable")
        if version != FORMAT_VERSION:
            raise ValueError(
                f"{path}: servable format {version!r} not supported "
                f"(this build reads {FORMAT_VERSION!r})")
        body = f.read()
    index = header.get("programs") or {}
    if "uq" not in index:
        raise ValueError(f"{path}: servable missing the 'uq' program")
    programs = {}
    checksums = header.get("checksums") or {}
    for name, (off, length) in index.items():
        if off < 0 or off + length > len(body):
            raise ValueError(
                f"{path}: program {name!r} spans [{off}, {off + length}) "
                f"outside the {len(body)}-byte body: artifact truncated "
                "or corrupt; re-export the servable")
        blob = body[off:off + length]
        got = hashlib.blake2b(blob, digest_size=16).hexdigest()
        if got != checksums.get(name):
            raise ValueError(
                f"{path}: program {name!r} checksum mismatch ({got} != "
                f"{checksums.get(name)}): artifact corrupt; re-export the "
                "servable")
        programs[name] = blob
    return header, programs


def _unpack_header(obj, header: dict) -> None:
    obj.header = header
    obj.batch_size = int(header["batch_size"])
    obj.tile_px = int(header["tile_px"])
    obj.tile_um = header.get("tile_um")
    obj.k = int(header["k"])
    fk = header.get("features_k")
    obj.features_k = int(fk) if fk is not None else None


def _chunked_call(call_exact, step: int, tiles, seed):
    """Any-n driver over a static-batch program: zero-pad each partial
    chunk to ``step`` and strip the padding rows. ``n == 0`` still runs
    one all-padding batch, so the outputs keep their trailing dimensions
    ((0, C) out). An explicit ``seed`` applies to every chunk."""
    if not isinstance(tiles, torch.Tensor):
        tiles = torch.from_numpy(np.ascontiguousarray(tiles))
    if tiles.ndim == 3:
        tiles = tiles[None]
    n = tiles.shape[0]
    outs = None
    for i in range(0, max(n, 1), step):
        chunk = tiles[i:i + step]
        n_real = chunk.shape[0]
        if n_real < step:
            chunk = torch.cat([chunk, chunk.new_zeros(
                (step - n_real,) + tuple(chunk.shape[1:]))])
        res = call_exact(chunk, seed=seed)
        if outs is None:
            outs = [[] for _ in res]
        for acc, r in zip(outs, res):
            acc.append(r[:n_real])
    return tuple(torch.cat(acc) for acc in outs)


def _serving_device(header: dict, device) -> torch.device:
    from .device import resolve_device

    platforms = header["platforms"]
    if device is None:
        device = "cuda" if "cuda" in platforms else "cpu"
    if torch.device(device).type not in platforms:
        raise ValueError(f"the artifact runs on {platforms}, not on "
                         f"{torch.device(device).type}")
    return _indexed(resolve_device(device))


class Servable:
    """A loaded UQ servable: ``(tiles) -> (mean, uncertainty)``.

    Keeps the port's ``UncertaintyInterface.__call__`` contract: any n
    uint8 RGB tiles in, n rows out as tensors on ``device``; each call
    without ``seed`` draws from the internal stream ``(0 << 32) | calls``,
    and an explicit seed pins every chunk. ``call_exact`` skips the
    padding when the caller batches at the exported size.

    ``device=None`` serves on the card when the artifact lists ``cuda``,
    else on the CPU; a device the artifact does not list raises. A
    portable artifact is moved to the device it serves on.
    """

    def __init__(self, path: str, device=None):
        header, programs = _read_container(path)
        _unpack_header(self, header)
        self.device = _serving_device(header, device)
        self._programs = programs
        self._calls = 0
        self._call = self._load("uq")
        self._features_call = None

    def _load(self, name: str):
        # Registers the kernels' ops, which a program with them needs.
        from .ops import library  # noqa: F401

        ep = torch.export.load(io.BytesIO(self._programs[name]))
        if torch.device(self.header["device"]) != self.device:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, self.device)
        return ep.module()

    @property
    def platforms(self):
        return tuple(self.header["platforms"])

    @property
    def has_features(self) -> bool:
        """True if the artifact carries the feature program (exported with
        ``with_features=True``)."""
        return "features" in self._programs

    def _seed(self, seed):
        from .ops.mcd_head import seed_tensor

        if seed is None:
            seed = self._calls & 0xFFFFFFFF
            self._calls += 1
        return seed_tensor(seed)

    def _check_exact(self, tiles):
        tiles = torch.as_tensor(tiles)
        want = (self.batch_size, self.tile_px, self.tile_px, 3)
        if tuple(tiles.shape) != want or tiles.dtype != torch.uint8:
            raise ValueError(
                f"servable expects uint8 tiles of shape {want}, got "
                f"{tuple(tiles.shape)} {tiles.dtype}; use __call__ for "
                "any-n batches")
        return tiles.to(self.device)

    def call_exact(self, tiles, seed=None):
        """The exported program: tiles must be (batch_size, px, px, 3)
        uint8 -> (mean, std), each (batch_size, C) f32."""
        tiles = self._check_exact(tiles)
        with torch.no_grad():
            return tuple(self._call(tiles, self._seed(seed)))

    def __call__(self, tiles, seed=None):
        return _chunked_call(self.call_exact, self.batch_size, tiles, seed)

    def features_exact(self, tiles, seed=None):
        """The feature program: (batch_size, px, px, 3) uint8 -> (pooled
        trunk features, mean, std)."""
        if not self.has_features:
            raise ValueError(
                "this artifact was exported without the feature program; "
                "re-export with export_servable(..., with_features=True)")
        if self._features_call is None:
            self._features_call = self._load("features")
        tiles = self._check_exact(tiles)
        with torch.no_grad():
            return tuple(self._features_call(tiles, self._seed(seed)))

    def features(self, tiles, seed=None):
        """Any-n feature extraction: (feats (n, F), mean (n, C), std)."""
        return _chunked_call(self.features_exact, self.batch_size, tiles,
                             seed)


def load_servable(path: str, device=None) -> Servable:
    """Load a servable exported by :func:`export_servable`."""
    return Servable(path, device=device)


class ShardedServable:
    """Data-parallel fan-out of a servable over several cards: not ported
    yet (ROADMAP.md Queue 1 item 9)."""

    def __init__(self, path: str, *args, **kwargs):
        raise NotImplementedError(f"ShardedServable {_ITEM_9}")


def load_sharded_servable(path: str, *args, **kwargs):
    raise NotImplementedError(f"load_sharded_servable {_ITEM_9}")


def _batch_seed(seed, b: int):
    """Batch ``b``'s seed from the caller's, as the interface's stream."""
    return None if seed is None else ((int(seed) << 32) | b) & ((1 << 64) - 1)


def predict_tfrecords(servable, tfrecords, labels=None, outcome="cohort",
                      max_tiles=None, seed=None):
    """Score tile tfrecords with a servable -> the tile-predictions frame
    (slide, loc_x, loc_y, ``{outcome}_y_true0``, ``{outcome}_y_pred{i}``,
    ``{outcome}_uncertainty{i}``), as ``trainer.predict_tiles`` writes it.

    Args:
        servable: a loaded servable (``load_servable``).
        tfrecords: per-slide ``{slide}.tfrecords`` paths.
        labels: optional slide -> int label map; other slides get -1.
        outcome: outcome name for the column prefix.
        max_tiles: per-tfrecord cap.
        seed: pins the dropout streams: batch b draws from ``(seed << 32)
            | b``; default the servable's internal stream.
    """
    from .data.pipeline import PrefetchBatcher, TileBatcher
    from .utils import scored_tile_rows, tile_predictions_frame

    batcher = PrefetchBatcher(
        TileBatcher(
            list(tfrecords), labels or {}, batch_size=servable.batch_size,
            shuffle=False, infinite=False, max_tiles=max_tiles,
            tile_px=servable.tile_px,
        ),
        depth=3,
    )
    batches = [0]

    def score(batch):
        # TileBatcher pads the last batch to the static size, so the
        # exported program runs as it is; the mask strips the padding.
        mean, std = servable.call_exact(
            torch.from_numpy(batch["image"]),
            seed=_batch_seed(seed, batches[0]))
        batches[0] += 1
        return mean.float().cpu().numpy(), std.float().cpu().numpy()

    try:
        df, probs, unc = scored_tile_rows(batcher, score)
    finally:
        batcher.close()
    return tile_predictions_frame(outcome, df, probs, unc)


def predict_tfrecords_distributed(*args, **kwargs):
    raise NotImplementedError(f"predict_tfrecords_distributed {_ITEM_9}")


def predict_slides(servable, slides, tile_um=None, mpp=None, qc="both",
                   stride_div=1, roi_method="ignore", outcome="cohort",
                   max_tiles=None, seed=None):
    """Score whole-slide images directly with a servable, with no
    extraction step: the frame of :func:`predict_tfrecords` with the grid
    (i, j) in loc_x/loc_y and ``y_true0 = -1``.

    Args:
        slides: slide paths (.svs/.tif through the native tiled reader,
            or any image PIL reads).
        tile_um: tile size in microns (default: the artifact's).
        mpp: microns per pixel, for files without resolution metadata.
        qc: 'both' (Otsu + blur), 'otsu', 'blur', or None.
        stride_div: grid stride divisor.
        max_tiles: per-slide tile cap, in grid order.
        seed: pins the dropout streams, batch b drawing from ``(seed <<
            32) | b``; default the servable's internal stream.
    """
    import pandas as pd

    from .data.slide import WSI
    from .utils import tile_predictions_frame

    tile_um = tile_um if tile_um is not None else servable.tile_um
    if tile_um is None:
        raise ValueError("this artifact records no tile_um; pass tile_um=")
    step = servable.batch_size
    rows = {"slide": [], "loc_x": [], "loc_y": [], "y_true": []}
    probs_all, unc_all = [], []
    batches = 0

    def flush(imgs, locs, slide_name):
        nonlocal batches
        if not imgs:
            return
        mean, std = servable(np.stack(imgs), seed=_batch_seed(seed, batches))
        batches += 1
        probs_all.append(mean.float().cpu().numpy())
        unc_all.append(std.float().cpu().numpy())
        for loc in locs:
            rows["slide"].append(slide_name)
            rows["loc_x"].append(int(loc[0]))
            rows["loc_y"].append(int(loc[1]))
            rows["y_true"].append(-1)

    for path in slides:
        wsi = WSI(path, tile_px=servable.tile_px, tile_um=tile_um, mpp=mpp,
                  qc=qc, stride_div=stride_div, roi_method=roi_method)
        try:
            imgs, locs, taken = [], [], 0
            for item in wsi.build_generator(shuffle=False,
                                            include_loc="grid")():
                if max_tiles is not None and taken >= max_tiles:
                    break
                taken += 1
                imgs.append(item["image"])
                locs.append(item["loc"])
                if len(imgs) == step:
                    flush(imgs, locs, wsi.name)
                    imgs, locs = [], []
            flush(imgs, locs, wsi.name)
        finally:
            wsi.close()

    probs = (np.concatenate(probs_all) if probs_all
             else np.zeros((0, 2), np.float32))
    unc = np.concatenate(unc_all) if unc_all else None
    return tile_predictions_frame(outcome, pd.DataFrame(rows), probs, unc)


def predict_slides_distributed(*args, **kwargs):
    raise NotImplementedError(f"predict_slides_distributed {_ITEM_9}")
