"""The port's data plane against the JAX package's: tfrecords written
byte for byte alike, the same batches from the same files, and PNG
decoding that equals Pillow's bit for bit.

Exact comparisons throughout: the copies do the same integer work, and
``data/png.py`` must return what ``PIL.Image.open(...).convert("RGB")``
returns. The PNGs with forced row filters come from ``chip_smoke.py``'s
encoder; Pillow writes the others and chooses its own filters.
"""

import io
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from biscuit_torch.data import tfrecord as port_tfrecord
from biscuit_torch.data.pipeline import (
    PrefetchBatcher,
    TileBatcher,
    decode_image,
)
from biscuit_torch.data.png import decode_png
from biscuit_tpu.data import tfrecord as jax_tfrecord
from biscuit_tpu.data.pipeline import TileBatcher as JaxTileBatcher
from chip_smoke import encode_png

torch.set_num_threads(1)


def _pil_png(img, mode) -> bytes:
    pil = Image.fromarray(img)
    assert pil.mode == mode
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    return buf.getvalue()


def _pil_rgb(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def _smooth(rng, h, w, ch):
    """Smooth ramps with noise, so Pillow's adaptive filtering picks
    predicting filters (Sub and Paeth here)."""
    steps = rng.integers(0, 9, (h, w, ch))
    return (np.cumsum(steps, axis=1) + np.arange(h)[:, None, None]) % 256


def _row_filters(raw: bytes):
    """The set of row filters a PNG of ours or Pillow's uses."""
    w, _, _, ctype = struct.unpack(">IIBB", raw[16:26])
    pos, idat = 8, b""
    while pos < len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        if kind == b"IDAT":
            idat += raw[pos + 8:pos + 8 + length]
        pos += length + 12
    data = zlib.decompress(idat)
    return set(data[::w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] + 1])


EXAMPLES = [
    {"slide": b"s0", "image_raw": b"\x89PNG", "loc_x": [3], "loc_y": [-7]},
    {"slide": b"s1", "f": [1.5, -2.25], "i": [-3, 2 ** 40, 0],
     "b": [b"a", b"bc"], "empty": []},
]


def test_tfrecords_are_byte_identical(tmp_path):
    paths = {}
    for name, mod in (("jax", jax_tfrecord), ("port", port_tfrecord)):
        paths[name] = str(tmp_path / f"{name}.tfrecords")
        with mod.TFRecordWriter(paths[name]) as w:
            for ex in EXAMPLES:
                w.write_example(ex)
            w.write_tile("slide9", b"\x00" * 300, loc_x=5, loc_y=6, label=1)
            w.write_tile("slide9", b"raw")
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    want = np.load(paths["jax"] + ".index.npy")
    np.testing.assert_array_equal(np.load(paths["port"] + ".index.npy"), want)
    # Without its sidecar the index is rebuilt from the framing.
    (tmp_path / "port.tfrecords.index.npy").unlink()
    np.testing.assert_array_equal(port_tfrecord.load_index(paths["port"]),
                                  want)
    assert port_tfrecord.count_records(paths["port"]) == 4
    with open(paths["port"], "rb") as f:
        for off in want:
            assert (port_tfrecord.read_example_at(f, int(off))
                    == jax_tfrecord.read_example_at(f, int(off)))
    assert port_tfrecord.crc32c(b"123456789") == 0xE3069283


@pytest.fixture(scope="module")
def tile_set(tmp_path_factory):
    """3 slides of 5, 4 and 6 PIL-written 32-px PNG tiles."""
    tmp = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(0)
    paths = []
    for s, n in enumerate((5, 4, 6)):
        path = str(tmp / f"sl{s}.tfrecords")
        with port_tfrecord.TFRecordWriter(path) as w:
            for t in range(n):
                img = _smooth(rng, 32, 32, 3).astype(np.uint8)
                w.write_tile(f"sl{s}", _pil_png(img, "RGB"), loc_x=t,
                             loc_y=2 * s)
        paths.append(path)
    return paths, {"sl0": 1, "sl2": 0}


@pytest.mark.parametrize("shuffle,max_tiles", [(False, None), (True, None),
                                               (False, 3)])
def test_tile_batcher_matches_jax(tile_set, shuffle, max_tiles):
    """Same batches as the JAX TileBatcher's Python path, the last one
    padded (15 or 9 tiles at batch 4), sl1 unlabelled (-1)."""
    paths, labels = tile_set
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, max_tiles=max_tiles)
    want = list(JaxTileBatcher(paths, labels, use_native=False, **kw))
    port = TileBatcher(paths, labels, tile_px=32, **kw)
    prefetch = PrefetchBatcher(TileBatcher(paths, labels, **kw), depth=2)
    try:
        for got in (list(port), list(prefetch)):
            assert len(got) == len(want) == port.num_batches
            for g, w in zip(got, want):
                assert g["slide"] == w["slide"]
                for key in ("image", "label", "loc", "mask"):
                    assert g[key].dtype == w[key].dtype
                    np.testing.assert_array_equal(g[key], w[key])
    finally:
        port.close()
        prefetch.close()
    assert not want[-1]["mask"].all()
    assert -1 in np.concatenate([b["label"] for b in want])


def test_tile_batcher_checks_the_tile_size(tile_set):
    paths, labels = tile_set
    with pytest.raises(ValueError, match="expected 299x299"):
        next(iter(TileBatcher(paths, labels, batch_size=4, tile_px=299)))


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "each"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_filters_match_pil(channels, filters):
    """Every filter forced on every row, and the five in turn row by
    row, at each colour type (grey, grey + alpha, RGB, RGBA)."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 19, channels), dtype=np.uint8)
    kinds = np.arange(23) % 5 if filters == "each" else filters
    raw = encode_png(img, kinds)
    assert _row_filters(raw) == set(np.atleast_1d(kinds).tolist())
    got = decode_png(raw)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, _pil_rgb(raw))


@pytest.mark.parametrize("mode,px", [("RGB", 40), ("RGBA", 40), ("L", 40),
                                     ("LA", 40), ("RGB", 299)])
def test_png_written_by_pil(mode, px):
    rng = np.random.default_rng(px)
    channels = len(mode)
    img = _smooth(rng, px, px + 3, channels).astype(np.uint8)
    raw = _pil_png(img[..., 0] if channels == 1 else img, mode)
    assert len(_row_filters(raw)) >= 2
    np.testing.assert_array_equal(decode_png(raw), _pil_rgb(raw))
    np.testing.assert_array_equal(decode_image(raw), _pil_rgb(raw))


def _interlaced(raw: bytes) -> bytes:
    """``raw`` with its IHDR interlace byte set (and its CRC fixed)."""
    ihdr = raw[12:28] + b"\x01"            # chunk type and data
    return (raw[:12] + ihdr + struct.pack(">I", zlib.crc32(ihdr))
            + raw[33:])


def test_other_images_go_to_pil():
    rng = np.random.default_rng(0)
    img = _smooth(rng, 24, 24, 3).astype(np.uint8)
    jpeg = io.BytesIO()
    Image.fromarray(img).save(jpeg, format="JPEG")
    palette = io.BytesIO()
    Image.fromarray(img).convert("P").save(palette, format="PNG")
    deep = _pil_png(img[..., 0].astype(np.uint16) * 257, "I;16")
    for raw in (jpeg.getvalue(), palette.getvalue(), deep):
        assert decode_png(raw) is None
        np.testing.assert_array_equal(decode_image(raw), _pil_rgb(raw))
    assert decode_png(_interlaced(encode_png(img))) is None


def test_without_pil_png_decodes_and_jpeg_raises(monkeypatch):
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3), np.uint8)
    jpeg = io.BytesIO()
    Image.fromarray(img).save(jpeg, format="JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(decode_image(encode_png(img, 4)), img)
    with pytest.raises(ImportError, match="JPEG"):
        decode_image(jpeg.getvalue())


def _idat(raw: bytes, data: bytes) -> bytes:
    """``raw`` (one IDAT chunk) with ``data`` as its IDAT chunk's data."""
    n = struct.unpack(">I", raw[33:37])[0]
    chunk = b"IDAT" + data
    return (raw[:33] + struct.pack(">I", len(data)) + chunk
            + struct.pack(">I", zlib.crc32(chunk)) + raw[33 + 12 + n:])


def test_corrupt_png_raises():
    raw = encode_png(np.zeros((4, 4, 3), np.uint8))
    flipped = bytearray(raw)
    flipped[45] ^= 0xFF                      # a byte of the IDAT data
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(flipped))
    with pytest.raises(ValueError, match="corrupt PNG"):
        decode_png(_idat(raw, b"not zlib"))
    with pytest.raises(ValueError, match="expected"):
        decode_png(_idat(raw, zlib.compress(b"\0" * 10)))
    assert decode_png(raw[:20]) is None


def test_the_predict_path_imports_no_pandas_or_pil():
    """The card's machine may lack pandas and Pillow: the tile reader and
    score_tiles import neither."""
    code = ("import sys\n"
            "import biscuit_torch.train.trainer, biscuit_torch.data.pipeline\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('pandas', 'PIL')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parent.parent, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
