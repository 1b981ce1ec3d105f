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

Several devices and processes: ``ShardedServable`` loads one artifact
on each device of a process-local mesh (``parallel/mesh.py``) and splits
each padded batch over them; ``predict_tfrecords_distributed`` and
``predict_slides_distributed`` score a list across processes that claim
its items through the store of ``parallel/distributed.py``.
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
            # The fused middle flow is Xception's; a ResNet program holds
            # the preprocess and head ops only.
            if use_kernels and model.arch in ARCHS:
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
        if self.mid_wts is not None:
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
    from .models.xception import ARCHS

    if fuse_blocks and model.arch not in ARCHS:
        raise ValueError(f"fuse_blocks=True runs Xception's strided blocks; "
                         f"{model.arch!r} has none")
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
        self._init(*_read_container(path), device)

    @classmethod
    def _from_container(cls, header: dict, programs: dict, device):
        obj = cls.__new__(cls)
        obj._init(header, programs, device)
        return obj

    def _init(self, header: dict, programs: dict, device) -> None:
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


def _fold_seed(seed: int, i: int) -> int:
    """An independent 32-bit seed for part ``i`` of the work seeded by
    ``seed`` (shard i of a batch, item i of a list), the counterpart of
    ``jax.random.fold_in(key, i)``."""
    digest = hashlib.blake2b(f"{int(seed)}/{int(i)}".encode(),
                             digest_size=4).digest()
    return int.from_bytes(digest, "little")


class ShardedServable:
    """Data-parallel fan-out of a servable over the devices of a
    process-local ``parallel.mesh.Mesh``.

    One artifact (static per-device batch ``batch_size``) is loaded once
    on each device of the mesh and serves ``batch_size x n_devices``
    tiles a dispatch: the padded global batch is split over the mesh's
    devices in order, each part runs its device's program, and the rows
    are gathered back in order on the mesh's first device. The program
    holds no collective, so the same artifact serves one card or many.

    Shard ``i`` of a call draws its dropout masks from ``_fold_seed(seed,
    i)``, so shards draw independent streams; passing ``seed=`` pins the
    whole global batch. A call without one takes the next number of the
    internal stream, as ``Servable`` does.

    Over a mesh that spans processes (every process of the runtime builds
    it with its own devices, ``parallel/lockstep.py``'s rule), the shards
    are every process's: each process passes the same global batch, runs
    its own shards (process p's device i is shard ``p * n_local + i``) at
    their seeds, and receives every row, gathered on the host through a
    gloo group of the processes. The result is one process's call over
    as many shards.
    """

    def __init__(self, path: str, mesh=None, axis: str = "data"):
        from .parallel import distributed
        from .parallel.lockstep import mesh_ranks, process_group
        from .parallel.mesh import data_parallel_mesh

        header, programs = _read_container(path)
        _unpack_header(self, header)  # batch_size is per device
        if mesh is None:
            mesh = data_parallel_mesh(axis=axis)
        self._first, self.n_shards = mesh_ranks(mesh)
        self._processes = (process_group()
                           if distributed.mesh_spans_processes(mesh)
                           else None)
        self.mesh = mesh
        self.axis = axis
        self.global_batch = self.batch_size * self.n_shards
        self._programs = programs
        self._calls = 0
        loaded = {}
        for dev in mesh.devices:
            if dev not in loaded:
                loaded[dev] = Servable._from_container(header, programs, dev)
        self._shards = [loaded[dev] for dev in mesh.devices]
        self.device = self._shards[0].device

    @property
    def platforms(self):
        return tuple(self.header["platforms"])

    @property
    def has_features(self) -> bool:
        return "features" in self._programs

    def _shard_seeds(self, seed):
        """The seeds of this process's shards."""
        if seed is None:
            seed = self._calls & 0xFFFFFFFF
            self._calls += 1
        return [_fold_seed(seed, self._first + i)
                for i in range(self.mesh.size)]

    def _check_exact(self, tiles):
        tiles = torch.as_tensor(tiles)
        want = (self.global_batch, self.tile_px, self.tile_px, 3)
        if tuple(tiles.shape) != want or tiles.dtype != torch.uint8:
            raise ValueError(
                f"sharded servable expects uint8 tiles of shape {want} "
                f"({self.n_shards} shards x batch {self.batch_size}), got "
                f"{tuple(tiles.shape)} {tiles.dtype}; use __call__ for "
                "any-n batches")
        return tiles

    def _fan_out(self, method: str, tiles, seed):
        from .parallel.mesh import batch_sharding

        tiles = self._check_exact(tiles)
        rows = self.batch_size * self.mesh.size
        mine = tiles[self._first * self.batch_size:][:rows]
        parts = batch_sharding(self.mesh).place(mine)
        outs = [getattr(shard, method)(part, seed=s) for shard, part, s in
                zip(self._shards, parts, self._shard_seeds(seed))]
        outs = tuple(torch.cat([o[j].to(self.device) for o in outs])
                     for j in range(len(outs[0])))
        if self._processes is None:
            return outs
        return tuple(torch.cat(self._processes.all_gather(o)) for o in outs)

    def call_exact(self, tiles, seed=None):
        """The program on every shard: tiles must be (global_batch, px,
        px, 3) uint8 -> (mean, std), each (global_batch, C)."""
        return self._fan_out("call_exact", tiles, seed)

    def __call__(self, tiles, seed=None):
        return _chunked_call(self.call_exact, self.global_batch, tiles, seed)

    def features_exact(self, tiles, seed=None):
        """The feature program on every shard: (global_batch, px, px, 3)
        -> (feats, mean, std)."""
        if not self.has_features:
            raise ValueError(
                "this artifact was exported without the feature program; "
                "re-export with export_servable(..., with_features=True)")
        return self._fan_out("features_exact", tiles, seed)

    def features(self, tiles, seed=None):
        """Any-n sharded feature extraction: (feats, mean, std)."""
        return _chunked_call(self.features_exact, self.global_batch, tiles,
                             seed)


def load_sharded_servable(path: str, mesh=None,
                          axis: str = "data") -> ShardedServable:
    """Load a servable and fan it out over ``mesh`` (default: a 1-D mesh
    over every card of this process)."""
    return ShardedServable(path, mesh=mesh, axis=axis)


def _batch_seed(seed, b: int):
    """Batch ``b``'s seed from the caller's, as the interface's stream."""
    return None if seed is None else ((int(seed) << 32) | b) & ((1 << 64) - 1)


def predict_tfrecords(servable, tfrecords, labels=None, outcome="cohort",
                      max_tiles=None, seed=None):
    """Score tile tfrecords with a servable -> the tile-predictions frame
    (slide, loc_x, loc_y, ``{outcome}_y_true0``, ``{outcome}_y_pred{i}``,
    ``{outcome}_uncertainty{i}``), as ``trainer.predict_tiles`` writes it.

    Args:
        servable: a loaded servable (``load_servable``), or a
            ``ShardedServable``, which scores ``global_batch`` tiles a
            dispatch.
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
            list(tfrecords), labels or {},
            batch_size=int(getattr(servable, "global_batch",
                                   servable.batch_size)),
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


def predict_tfrecords_distributed(servable, tfrecords, workdir, labels=None,
                                  outcome="cohort", max_tiles=None,
                                  seed=None, timeout_ms=600_000):
    """Score tfrecords across the processes of a multi-process runtime
    (``parallel.distributed.initialize``).

    Every process calls this with the SAME tfrecord list: claims and the
    output order key on the list index. Each process claims whole
    tfrecords (``parallel.distributed.try_claim``), scores its claims
    through its own servable and writes one shard into ``workdir``, a
    path all processes share. A status exchange closes the scoring, so
    one process's failure aborts every process instead of leaving them
    waiting at the merge; then every process reads all shards and
    returns the same merged frame, in the input list's order.

    With ``seed``, tfrecord ``i`` is scored with ``_fold_seed(seed, i)``
    (its batch b from ``(that << 32) | b``) whichever process claims it,
    so the merged frame is the same at any number of processes.
    Single-process every claim is won here and the merge reads back the
    one shard.
    """
    from .data.tfrecord import load_index

    def score_one(i, path, sub):
        if len(load_index(path)) == 0:
            # A tfrecord that QC left empty contributes no rows (scored
            # alone it would raise TileBatcher's no-tiles error).
            return None
        return predict_tfrecords(servable, [path], labels=labels,
                                 outcome=outcome, max_tiles=max_tiles,
                                 seed=sub)

    return _distributed_claim_map(servable, tfrecords, workdir, score_one,
                                  outcome, seed, timeout_ms)


def _distributed_claim_map(servable, items, workdir, score_one, outcome,
                           seed, timeout_ms):
    """The claim, score and merge loop behind ``predict_*_distributed``:
    item ``i`` is claimed across the processes and scored here by
    ``score_one(i, item, _fold_seed(seed, i))`` (None: no rows); shards
    meet in ``workdir``; a status exchange aborts every process when one
    fails; every process returns the same merged frame, in list order.

    Shards are pandas pickles (exact dtypes, no extra dependency) named
    by a per-call nonce from main, so a reused workdir cannot leak an
    earlier call's shards into the merge."""
    import time
    import uuid
    from glob import glob

    import pandas as pd

    from .parallel import distributed as dist
    from .utils import tile_predictions_frame

    mesh = getattr(servable, "mesh", None)
    if mesh is not None and dist.mesh_spans_processes(mesh):
        raise ValueError(
            "distributed scoring runs independent claims in each process; "
            "a ShardedServable here must fan out over this process's "
            "devices only (load_sharded_servable(path, "
            "mesh=data_parallel_mesh(local_devices())))")
    items = [str(p) for p in items]
    os.makedirs(workdir, exist_ok=True)
    # Claim tokens are namespaced per call: the store's counters outlive
    # one call, and an earlier call's claims must not starve this one.
    ns = dist.broadcast_from_main(
        "predict_nonce", uuid.uuid4().hex[:12] if dist.is_main() else None,
        timeout_ms=timeout_ms)
    pid = dist.process_index()

    err = None
    wrote_shard = False
    try:
        frames = []
        for i, item in enumerate(items):
            if not dist.try_claim(f"{ns}_item{i}"):
                continue
            sub = None if seed is None else _fold_seed(seed, i)
            df = score_one(i, item, sub)
            if df is None:
                continue
            df.insert(0, "_src", i)
            frames.append(df)
        if frames:
            shard = pd.concat(frames, ignore_index=True)
            tmp = os.path.join(workdir, f".{ns}_shard_{pid}.tmp")
            shard.to_pickle(tmp)
            os.replace(tmp, os.path.join(workdir, f"{ns}_shard_{pid}.pkl"))
            wrote_shard = True
    except Exception as e:
        err = e
    all_ok = dist.exchange_ok(f"{ns}_scored", err is None, timeout_ms)
    if err is not None:
        raise err
    if not all_ok:
        raise RuntimeError("a peer process failed distributed scoring")
    # Each process says whether it wrote a shard, so the merge checks the
    # count instead of trusting a listing that a shared filesystem's
    # attribute cache can leave short for a moment.
    n_expect = sum(int(v) for v in dist.exchange_values(
        f"{ns}_wrote", "1" if wrote_shard else "0", timeout_ms))
    pattern = os.path.join(workdir, f"{ns}_shard_*.pkl")
    deadline = time.monotonic() + 30.0
    shards = sorted(glob(pattern))
    while len(shards) < n_expect and time.monotonic() < deadline:
        time.sleep(0.2)
        shards = sorted(glob(pattern))
    if len(shards) != n_expect:
        raise RuntimeError(
            f"distributed scoring merge expected {n_expect} shard files "
            f"under {workdir} but sees {len(shards)}: is workdir shared "
            "by every process?")
    if not shards:
        empty = pd.DataFrame({"slide": [], "loc_x": [], "loc_y": [],
                              "y_true": []})
        return tile_predictions_frame(outcome, empty,
                                      np.zeros((0, 2), np.float32), None)
    merged = pd.concat([pd.read_pickle(p) for p in shards],
                       ignore_index=True)
    merged = merged.sort_values("_src", kind="stable").drop(columns="_src")
    return merged.reset_index(drop=True)


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
    step = int(getattr(servable, "global_batch", servable.batch_size))
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


def predict_slides_distributed(servable, slides, workdir, tile_um=None,
                               mpp=None, qc="both", stride_div=1,
                               roi_method="ignore", outcome="cohort",
                               max_tiles=None, seed=None,
                               timeout_ms=600_000):
    """Score whole-slide images across processes: the
    :func:`predict_slides` loop with the claim, merge and abort protocol
    of :func:`predict_tfrecords_distributed`, one claim a slide. Every
    process returns the same merged frame, in the input list's order,
    independent of the number of processes (slide ``i`` is scored with
    ``_fold_seed(seed, i)``)."""

    def score_one(i, path, sub):
        return predict_slides(servable, [path], tile_um=tile_um, mpp=mpp,
                              qc=qc, stride_div=stride_div,
                              roi_method=roi_method, outcome=outcome,
                              max_tiles=max_tiles, seed=sub)

    return _distributed_claim_map(servable, slides, workdir, score_one,
                                  outcome, seed, timeout_ms)
