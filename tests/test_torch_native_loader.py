"""The port's native data plane (``biscuit_torch/data/native_loader.py``
over ``biscuit_torch/csrc/native/biscuit_native.cpp``) against the JAX
package's library and Python paths, on inputs made from seeds.

Exact comparisons throughout: the two libraries are the same C++ over the
same system libpng, libjpeg, libtiff and OpenJPEG, so CRCs, decoded tiles,
indexes, TIFF files and regions agree bit for bit, and the port's
``TileBatcher`` gives the same batches with and without ``use_native``.
The build's own rules are held too: a codec whose header is missing is
left out and rejected, a failed build raises with the compiler's log, and
processes that build at once do not collide.
"""

import ctypes
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from biscuit_torch.data import native_loader as port_nl
from biscuit_torch.data import tfrecord as port_tfrecord
from biscuit_torch.data.pipeline import TileBatcher
from biscuit_tpu.data import native_loader as jax_nl
from biscuit_tpu.data import tfrecord as jax_tfrecord
from biscuit_tpu.data.pipeline import TileBatcher as JaxTileBatcher

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _encode(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


def _smooth(rng, h, w):
    """JPEG-representable content: ramps with a little noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w, 1), yy * 255 // max(h, 1),
                     (xx + yy) * 255 // max(h + w, 1)], -1)
    return np.clip(base + rng.integers(-8, 9, base.shape), 0,
                   255).astype(np.uint8)


def test_library_builds_and_reports_its_parts():
    port_nl.load()
    assert port_nl.loaded()
    assert port_nl.lib_path().exists()
    assert port_nl.version() == jax_nl.version()
    caps = port_nl.capabilities()
    cmd, _ = port_nl._build_plan()
    # The codecs are in where g++ found their headers; libtiff and
    # libopenjp2 load where the JAX package's library found them.
    assert caps == {"png": "-DBN_HAVE_PNG=1" in cmd,
                    "jpeg": "-DBN_HAVE_JPEG=1" in cmd, "tiff": True,
                    "j2k": bool(jax_nl._load().bn_j2k_available()),
                    "sse42_crc32c": caps["sse42_crc32c"]}


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 10007])
def test_crc32c_equals_jax_library_and_python_table(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    tab = port_tfrecord._CRC_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    want = crc ^ 0xFFFFFFFF
    assert port_nl.native_crc32c(data) == jax_nl.native_crc32c(data) == want
    port_nl.load()
    assert port_tfrecord.crc32c(data) == want
    assert port_nl.native_crc32c(b"123456789") == 0xE3069283


def test_tfrecords_with_the_library_crc_equal_jax(tmp_path):
    port_nl.load()
    rng = np.random.default_rng(1)
    for name, mod in (("jax", jax_tfrecord), ("port", port_tfrecord)):
        with mod.TFRecordWriter(str(tmp_path / f"{name}.tfrecords")) as w:
            for i in range(5):
                w.write_tile(f"s{i}", rng.bytes(100 + 37 * i), loc_x=i,
                             loc_y=-i, label=i % 2)
        rng = np.random.default_rng(1)
    assert ((tmp_path / "jax.tfrecords").read_bytes()
            == (tmp_path / "port.tfrecords").read_bytes())


@pytest.mark.parametrize("mode,shape", [
    ("RGB", (48, 64, 3)), ("RGBA", (33, 17, 4)), ("L", (20, 31)),
    ("P", (16, 16))])
def test_png_decode_bit_exact(mode, shape):
    rng = np.random.default_rng(len(mode))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    pil = Image.fromarray(img)
    if mode == "P":
        pil = pil.convert("P")
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    raw = buf.getvalue()
    got = port_nl.native_decode(raw)
    np.testing.assert_array_equal(got, jax_nl.native_decode(raw))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")))


@pytest.mark.parametrize("quality", [60, 90])
def test_jpeg_decode_equals_jax_library(quality):
    img = _smooth(np.random.default_rng(quality), 40, 56)
    raw = _encode(img, "JPEG", quality=quality)
    got = port_nl.native_decode(raw)
    assert got.shape == (40, 56, 3)
    np.testing.assert_array_equal(got, jax_nl.native_decode(raw))


def test_garbage_returns_none():
    assert port_nl.native_decode(b"not an image at all") is None
    assert port_nl.native_decode(_encode(np.zeros((4, 4, 3), np.uint8),
                                         "BMP")) is None


def _tfrecord(path, tiles, fmt="PNG"):
    with jax_tfrecord.TFRecordWriter(str(path), index=False) as w:
        for i, img in enumerate(tiles):
            w.write_tile(f"slide{i % 3}", _encode(img, fmt), loc_x=i * 7,
                         loc_y=i, label=i % 2)


def test_index_parity(tmp_path):
    path = str(tmp_path / "t.tfrecords")
    with jax_tfrecord.TFRecordWriter(path, index=False) as w:
        for i in range(20):
            w.write_tile(f"s{i}", bytes(10 + i))
    got = port_nl.native_index_tfrecord(path)
    np.testing.assert_array_equal(got, jax_nl.native_index_tfrecord(path))
    np.testing.assert_array_equal(got, port_tfrecord.load_index(path))


@pytest.mark.parametrize("threads", [1, 4, 0])
def test_batch_read_decode_equals_jax(tmp_path, threads):
    rng = np.random.default_rng(3)
    tiles = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
             for _ in range(10)]
    path = str(tmp_path / "b.tfrecords")
    _tfrecord(path, tiles)
    offsets = port_nl.native_index_tfrecord(path)[::-1].copy()
    got = port_nl.native_read_decode_batch(path, offsets, 32,
                                           verify_crc=True, threads=threads)
    want = jax_nl.native_read_decode_batch(path, offsets, 32,
                                           verify_crc=True, threads=threads)
    assert got[4] == want[4] == 10
    assert got[1] == want[1] == [f"slide{i % 3}" for i in range(9, -1, -1)]
    for g, w in zip(got[:1] + got[2:4], want[:1] + want[2:4]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], np.stack(tiles[::-1]))
    np.testing.assert_array_equal(got[2][:, 0], np.arange(9, -1, -1) * 7)
    np.testing.assert_array_equal(got[3], np.arange(9, -1, -1) % 2)


def test_batch_wrong_tile_size_flagged(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "w.tfrecords")
    _tfrecord(path, [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                     rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)])
    offsets = port_nl.native_index_tfrecord(path)
    imgs, _, locs, _, ok = port_nl.native_read_decode_batch(path, offsets,
                                                            32)
    assert ok == 1
    assert locs[1, 0] == -1 and not imgs[1].any()
    np.testing.assert_array_equal(
        locs, jax_nl.native_read_decode_batch(path, offsets, 32)[2])


def test_batch_read_refuses_a_bad_crc(tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "c.tfrecords"
    _tfrecord(path, [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)])
    raw = bytearray(path.read_bytes())
    raw[-5] ^= 0xFF  # the payload's last byte
    path.write_bytes(bytes(raw))
    offsets = port_nl.native_index_tfrecord(str(path))
    with pytest.raises(IOError, match="rc=-3"):
        port_nl.native_read_decode_batch(str(path), offsets, 8,
                                         verify_crc=True)


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_tile_batcher_native_equals_default_and_jax(tmp_path, fmt, shuffle):
    """``use_native=True`` gives the default decode's batches and the JAX
    native path's, bit for bit; a tile the native decoder rejects (a TIFF
    tile here) is decoded in Python on both packages' native paths."""
    rng = np.random.default_rng(6)
    paths = []
    for s, n in enumerate((7, 5, 6)):
        p = str(tmp_path / f"sl{s}.tfrecords")
        with port_tfrecord.TFRecordWriter(p) as w:
            for t in range(n):
                img = _smooth(rng, 32, 32)
                w.write_tile(f"sl{s}", _encode(img, "TIFF" if (s, t) == (
                    1, 2) else fmt), loc_x=t, loc_y=s)
        paths.append(p)
    kw = dict(labels={"sl0": 0, "sl2": 1}, batch_size=8, shuffle=shuffle,
              seed=2, tile_px=32)
    got = list(TileBatcher(paths, use_native=True, **kw))
    for want in (list(TileBatcher(paths, **kw)),
                 list(JaxTileBatcher(paths, use_native=True, **kw))):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["slide"] == w["slide"]
            for key in ("image", "label", "loc", "mask"):
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])


def test_built_as_on_a_host_without_codec_headers_or_libtiff(tmp_path):
    """The source built as on a host without png.h, jpeglib.h and a
    system libtiff: both codecs are out and their tiles are rejected
    (-11), the TIFF reader is out until ``bn_tiff_load`` is given
    Pillow's copy of libtiff, which then reads what the system's does;
    the rest works."""
    out = tmp_path / "libbare.so"
    subprocess.run([port_nl._cxx(), *port_nl.CXX_FLAGS, "-DBN_HAVE_PNG=0",
                    "-DBN_HAVE_JPEG=0", "-DBN_SYSTEM_TIFF=0", "-o",
                    str(out), str(port_nl.SOURCE), "-ldl", "-lpthread"],
                   check=True)
    lib = ctypes.CDLL(str(out))
    assert lib.bn_capabilities() & 7 == 0
    img = np.zeros((4, 4, 3), np.uint8)
    dst = np.empty(48, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    for fmt in ("PNG", "JPEG"):
        raw = _encode(img, fmt)
        assert lib.bn_decode_image(raw, ctypes.c_size_t(len(raw)),
                                   dst.ctypes.data_as(ctypes.c_void_p),
                                   ctypes.c_size_t(48), ctypes.byref(w),
                                   ctypes.byref(h)) == -11
    lib.bn_crc32c.restype = ctypes.c_uint32
    assert lib.bn_crc32c(b"123456789", ctypes.c_size_t(9)) == 0xE3069283

    vendored = [p for p in port_nl._pillow_libs("libtiff")
                if p.parent.name == "pillow.libs"][0]
    assert lib.bn_tiff_load(str(vendored).encode()) == 1
    assert lib.bn_capabilities() & 4
    base, _ = _pyramid(9, 70, 90)
    path = str(tmp_path / "t.tif")
    port_nl.write_tiled_tiff(path, base, tile=32)
    lib.bn_tiff_open.restype = ctypes.c_void_p
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    dims = [i64(), i64(), i32(), i32(), i32()]
    handle = lib.bn_tiff_open(path.encode(), i32(0),
                              *[ctypes.byref(d) for d in dims])
    assert handle and [d.value for d in dims] == [90, 70, 32, 32, 1]
    got = np.empty((70, 90, 3), np.uint8)
    assert lib.bn_tiff_read_region(
        ctypes.c_void_p(handle), i64(0), i64(0), i64(90), i64(70),
        got.ctypes.data_as(ctypes.c_void_p)) == 0
    lib.bn_tiff_close(ctypes.c_void_p(handle))
    np.testing.assert_array_equal(got, base)


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(port_nl, "SOURCE", bad)
    monkeypatch.setattr(port_nl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_nl, "_plan", None)
    monkeypatch.setattr(port_nl, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        port_nl.load()
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_two_processes_build_at_once_and_neither_loads_the_jax_library(
        tmp_path):
    code = (
        "import sys\nfrom pathlib import Path\n"
        "from biscuit_torch.data import native_loader as nl\n"
        f"nl.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "assert nl.native_crc32c(b'123456789') == 0xE3069283\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'native/libbiscuit_native.so' not in maps\n"
        "assert str(nl.lib_path()) in maps\n"
        "print(nl.lib_path())\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    assert [p.name for p in tmp_path.iterdir() if p.suffix in (".so",
                                                              ".tmp")] == [
        Path(outs[0][0].strip()).name]


# --- Tiled TIFF ---------------------------------------------------------


def _pyramid(seed, h=200, w=300):
    base = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    lvl1 = base[:h // 2 * 2, :w // 2 * 2].reshape(
        h // 2, 2, w // 2, 2, 3).mean((1, 3)).astype(np.uint8)
    return base, lvl1


REGIONS = [(0, 0, 64, 64), (50, 40, 128, 100), (63, 63, 2, 2),
           (0, 0, 300, 200), (250, 150, 100, 100), (-10, -5, 30, 20)]


@pytest.mark.parametrize("jpeg", [False, True])
def test_tiffs_written_by_either_read_alike_in_both(tmp_path, jpeg):
    base, lvl1 = _pyramid(7)
    if jpeg:
        base = _smooth(np.random.default_rng(7), 200, 300)
    files = {}
    for name, mod in (("port", port_nl), ("jax", jax_nl)):
        files[name] = str(tmp_path / f"{name}.svs")
        mod.write_tiled_tiff(files[name], base, tile=64, jpeg=jpeg)
        mod.write_tiled_tiff(files[name], lvl1, tile=64, append=True)
    assert (Path(files["port"]).read_bytes()
            == Path(files["jax"]).read_bytes())
    for path in files.values():
        assert (port_nl.TiledTiff.levels(path)
                == jax_nl.TiledTiff.levels(path) == [(300, 200), (150, 100)])
        assert (port_nl.TiledTiff.description(path)
                == jax_nl.TiledTiff.description(path))
        for level in (0, 1):
            p, j = port_nl.TiledTiff(path, level), jax_nl.TiledTiff(path,
                                                                    level)
            assert (p.width, p.height, p.tile_size) == (j.width, j.height,
                                                        j.tile_size)
            for region in REGIONS:
                np.testing.assert_array_equal(p.read_region(*region),
                                              j.read_region(*region))
            for max_px in (100, 150, 64):
                np.testing.assert_array_equal(p.thumbnail(max_px),
                                              j.thumbnail(max_px))
            p.close()
            j.close()
    t = port_nl.TiledTiff(files["jax"])
    if not jpeg:
        np.testing.assert_array_equal(t.read_region(0, 0, 300, 200), base)
        edge = t.read_region(250, 150, 100, 100)
        np.testing.assert_array_equal(edge[:50, :50], base[150:, 250:])
        assert not edge[50:].any() and not edge[:, 50:].any()
    np.testing.assert_array_equal(t.thumbnail(150), lvl1)
    t.close()


def test_striped_tiff_rejected(tmp_path):
    p = str(tmp_path / "striped.tiff")
    Image.fromarray(_pyramid(8)[0]).save(p)  # PIL writes striped TIFF
    with pytest.raises(OSError, match="tiled"):
        port_nl.TiledTiff(p)


def test_garbage_file_raises(tmp_path):
    p = str(tmp_path / "junk.svs")
    Path(p).write_bytes(b"definitely not a tiff" * 100)
    with pytest.raises(OSError):
        port_nl.TiledTiff(p)
    with pytest.raises(OSError):
        port_nl.TiledTiff.levels(p)
    assert port_nl.TiledTiff.description(p) is None


@pytest.mark.skipif(not jax_nl._load().bn_j2k_available(),
                    reason="libopenjp2 not present")
@pytest.mark.parametrize("compression,photometric", [(33005, 2),
                                                     (33003, 6)])
def test_j2k_tiles_equal_jax(tmp_path, compression, photometric):
    """Aperio JPEG2000 tiles (as tests/test_j2k.py builds them: PIL's
    lossless codestreams in a hand-assembled tiled TIFF) read alike."""
    from test_j2k import _build_tiff, _encode_j2k

    rng = np.random.default_rng(compression)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    tile = 64
    payloads = [_encode_j2k(img[y:y + tile, x:x + tile].copy(),
                            raw_codestream=True, tmp_path=tmp_path)
                for y in range(0, 96, tile) for x in range(0, 128, tile)]
    path = tmp_path / "j2k.svs"
    _build_tiff(path, 128, 96, tile, payloads, compression, photometric,
                desc="Aperio Image|MPP = 0.2520")
    assert port_nl.capabilities()["j2k"]
    path = str(path)
    p, j = port_nl.TiledTiff(path), jax_nl.TiledTiff(path)
    for region in REGIONS[:4]:
        np.testing.assert_array_equal(p.read_region(*region),
                                      j.read_region(*region))
    if compression == 33005:
        np.testing.assert_array_equal(p.read_region(0, 0, 128, 96), img)
    assert "MPP = 0.2520" in port_nl.TiledTiff.description(path)
    p.close()
    j.close()
