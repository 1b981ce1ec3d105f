"""Host-side tile input pipeline: tfrecords -> uint8 numpy batches.

Counterpart of ``biscuit_tpu/data/pipeline.py`` (the stand-in for the
reference stack's slideflow/tf.data pipeline). Reads per-slide tfrecords
through their index sidecars, decodes each tile on the host and yields
fixed-shape batches with a mask of the real rows; everything downstream
(stain normalization, standardization, the model) runs on the card.

By default tiles are read and decoded in Python: by Pillow, imported
only when a tile is decoded, where it is installed, and otherwise, for
PNGs of the usual kinds, by ``data/png.py`` (zlib and numpy; on a
Pillow-written 299-px tile about ten times slower than Pillow). With
``use_native=True`` each batch is read, parsed and decoded by the native
library's threaded reader (``data/native_loader.py``) with the GIL
released, and a tile its decoder rejects is decoded in Python, as the
JAX package's ``_gather_native`` does; both give the same bytes. Under
lockstep data parallelism each rank reads its shard of the tile stream
(``shard``, ``num_shards``), as the JAX package's processes do. With
``jpeg_aug`` each
training tile is re-compressed on the host after decoding
(``data/augment.py`` ``jpeg_augment_host``, drawing from the batcher's
shuffle generator, as the JAX package's Python path does), always in
Python.
"""

from __future__ import annotations

import io
import queue
import threading
from os.path import basename, splitext
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..tracing import span
from .png import decode_png, describe
from .tfrecord import load_index, read_example_at


def decode_image(raw: bytes) -> np.ndarray:
    """Decode a tile to HWC uint8 RGB, as Pillow's ``convert("RGB")``.

    Pillow decodes it where it is installed. Without Pillow, 8-bit
    non-interlaced grey/RGB(A) PNGs decode by ``data/png.py`` and any
    other image raises ImportError naming its format."""
    try:
        from PIL import Image
    except ImportError:
        img = decode_png(raw)
        if img is None:
            raise ImportError(
                f"cannot decode a {describe(raw)} tile: data/png.py takes "
                "8-bit non-interlaced grey or RGB(A) PNGs, and Pillow, which "
                "decodes the rest, is not installed") from None
        return img
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


class TileBatcher:
    """Batched iterator over tile tfrecords with slide-level labels.

    Args:
        tfrecords: per-slide tfrecord paths ({slide}.tfrecords).
        labels: slide -> int label (tiles inherit their slide's label).
        batch_size: fixed batch size; final partial batch is padded and a
            mask marks valid rows (static shapes for the card).
        shuffle: shuffle the global tile index each epoch.
        infinite: loop forever (training); otherwise one epoch.
        seed: seed of the shuffle (and ``jpeg_aug``) generator.
        jpeg_aug: random JPEG re-compression of each tile on the host.
        max_tiles: read at most this many tiles of each tfrecord.
        tile_px: when given, every decoded tile must be this size.
        use_native: read and decode through the native library's
            threaded reader (built and loaded here, or raising) where
            ``tile_px`` is given and ``jpeg_aug`` is off; the default
            decodes in Python. Either way the batches are the same.
        shard, num_shards: read every ``num_shards``-th tile from the
            ``shard``-th (``entries[shard::num_shards]``, after
            ``max_tiles``); every shard shuffles with ``seed``.
    """

    def __init__(
        self,
        tfrecords: List[str],
        labels: Optional[Dict[str, int]] = None,
        batch_size: int = 128,
        shuffle: bool = True,
        infinite: bool = False,
        seed: int = 0,
        jpeg_aug: bool = False,
        max_tiles: Optional[int] = None,
        tile_px: Optional[int] = None,
        use_native: bool = False,
        shard: int = 0,
        num_shards: int = 1,
    ):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} outside [0, {num_shards})")
        if use_native:
            from .native_loader import load

            load()
        self.use_native = use_native
        self.paths = list(tfrecords)
        self.labels = labels or {}
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.infinite = infinite
        self.jpeg_aug = jpeg_aug
        self.rng = np.random.default_rng(seed)
        self.tile_px = tile_px

        entries: List[Tuple[int, int]] = []
        for pi, path in enumerate(self.paths):
            offsets = load_index(path)
            if max_tiles is not None:
                offsets = offsets[:max_tiles]
            entries.extend((pi, int(off)) for off in offsets)
        entries = entries[shard::num_shards]
        self.entries = np.asarray(entries, dtype=np.int64).reshape(-1, 2)
        self._slide_names = [splitext(basename(p))[0] for p in self.paths]
        self._files = {}

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def num_batches(self) -> int:
        return -(-len(self.entries) // self.batch_size)

    def _file(self, pi: int):
        if pi not in self._files:
            self._files[pi] = open(self.paths[pi], "rb")
        return self._files[pi]

    def _read_tile(self, pi: int, offset: int):
        ex = read_example_at(self._file(pi), offset)
        img = decode_image(ex["image_raw"])
        if self.jpeg_aug:
            from .augment import jpeg_augment_host

            img = jpeg_augment_host(img, self.rng)
        px = self.tile_px
        if px is not None and img.shape[:2] != (px, px):
            raise ValueError(
                f"tile at byte {offset} of {self.paths[pi]} is "
                f"{img.shape[1]}x{img.shape[0]} px, expected {px}x{px}")
        slide = (
            ex["slide"].decode()
            if isinstance(ex.get("slide"), bytes)
            else self._slide_names[pi]
        )
        loc_x = ex.get("loc_x", [0])
        loc_y = ex.get("loc_y", [0])
        return img, slide, int(loc_x[0]), int(loc_y[0])

    def _gather_native(self, idx):
        """Threaded native read + parse + decode, grouped per source
        file; a tile the native decoder rejects takes the Python path."""
        from .native_loader import native_read_decode_batch

        n = len(idx)
        imgs = np.empty((n, self.tile_px, self.tile_px, 3), np.uint8)
        slides = [""] * n
        locs = np.zeros((n, 2), np.int64)
        by_file: Dict[int, list] = {}
        for row, i in enumerate(idx):
            pi, off = self.entries[i]
            by_file.setdefault(int(pi), []).append((row, int(off)))
        for pi, items in by_file.items():
            rows = [r for r, _ in items]
            offsets = np.asarray([o for _, o in items], np.int64)
            b_imgs, b_slides, b_locs, _labels, _ok = native_read_decode_batch(
                self.paths[pi], offsets, self.tile_px
            )
            for j, row in enumerate(rows):
                if b_locs[j, 0] == -1:  # native decode failed: python path
                    img, slide, lx, ly = self._read_tile(pi, offsets[j])
                    imgs[row] = img
                    slides[row] = slide
                    locs[row] = (lx, ly)
                else:
                    imgs[row] = b_imgs[j]
                    slides[row] = b_slides[j] or self._slide_names[pi]
                    locs[row] = b_locs[j]
        return imgs, slides, locs

    def _gather(self, idx):
        if (self.use_native and not self.jpeg_aug
                and self.tile_px is not None):
            return self._gather_native(idx)
        imgs, slides, locs = [], [], []
        for i in idx:
            pi, off = self.entries[i]
            img, slide, lx, ly = self._read_tile(pi, off)
            imgs.append(img)
            slides.append(slide)
            locs.append((lx, ly))
        return np.stack(imgs), slides, np.asarray(locs, np.int64)

    def __iter__(self) -> Iterator[dict]:
        if not len(self.entries):
            # An empty infinite stream would otherwise spin forever.
            raise ValueError(
                "TileBatcher has no tiles (empty tfrecord list or all "
                "slides filtered out)"
            )
        while True:
            order = np.arange(len(self.entries))
            if self.shuffle:
                self.rng.shuffle(order)
            for start in range(0, len(order), self.batch_size):
                idx = order[start:start + self.batch_size]
                imgs, slides, locs = self._gather(idx)
                n_valid = len(idx)
                labels = np.asarray(
                    [self.labels.get(s, -1) for s in slides], np.int32
                )
                if n_valid < self.batch_size:
                    # Pad to a static batch size (mask marks real rows).
                    pad = self.batch_size - n_valid
                    imgs = np.concatenate(
                        [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)]
                    )
                    slides = list(slides) + [""] * pad
                    labels = np.concatenate(
                        [labels, np.full(pad, -1, np.int32)]
                    )
                    locs = np.concatenate([locs, np.zeros((pad, 2), np.int64)])
                yield {
                    "image": imgs,
                    "label": labels,
                    "slide": slides,
                    "loc": locs.astype(np.int32),
                    "mask": np.arange(self.batch_size) < n_valid,
                }
            if not self.infinite:
                return

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


class PrefetchBatcher:
    """Background-thread prefetch wrapper: reads and decodes the next
    batches while the card computes the current one.

    Wraps any iterable of batches (normally a TileBatcher). ``depth`` is
    the queue size; 2-3 suffices to hide decode latency behind a step
    that takes longer than decoding a batch. Under a profiler the
    consumer's wait for each batch is the span ``batcher.wait``
    (``tracing``).
    """

    _SENTINEL = object()

    def __init__(self, batcher, depth: int = 3):
        self.batcher = batcher
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None

        def worker():
            try:
                for batch in batcher:
                    # put with timeout so a full queue can't deadlock close()
                    # on an infinite batcher.
                    while not self._stop.is_set():
                        try:
                            self._q.put(batch, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # re-raised in the consumer
                self._error = e
            finally:
                # The sentinel MUST be delivered (a lost sentinel deadlocks
                # the consumer); retry until it lands or close() is called.
                while not self._stop.is_set():
                    try:
                        self._q.put(self._SENTINEL, timeout=0.25)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            with span("batcher.wait"):
                item = self._q.get()
            if item is self._SENTINEL:
                if self._error is not None:
                    # A worker-thread failure must surface, not masquerade
                    # as a clean (truncated) end of stream.
                    raise RuntimeError(
                        "prefetch worker failed"
                    ) from self._error
                return
            yield item

    def __len__(self):
        return len(self.batcher)

    @property
    def num_batches(self):
        return self.batcher.num_batches

    def close(self):
        self._stop.set()
        # Drain so the worker can observe the stop flag and exit.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        self.batcher.close()
