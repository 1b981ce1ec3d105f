"""ctypes bindings for the port's native data-plane library.

Counterpart of ``biscuit_tpu/data/native_loader.py`` over the port's own
copy of the C++ source, ``csrc/native/biscuit_native.cpp``: hardware
CRC32C, libpng/libjpeg tile decode, tfrecord indexing, the threaded batch
read + decode, and the tiled-TIFF region reader (libtiff and OpenJPEG,
both loaded by the library with dlopen: the system's libtiff, or where
the system has none, the copy that Pillow's extension loads, such as
the one its wheel ships in ``pillow.libs/``).

The library is built with ``g++`` at first use into
``_build/libbiscuit_native-<hash>.so``; the hash covers the source, the
flags, the compiler's version and which codec headers the compiler finds,
so an edited source or another machine's build never loads. The build
writes under a temporary name and renames into place, so processes that
build at once do not collide. PNG and JPEG decode are compiled in only
where ``png.h`` / ``jpeglib.h`` are installed (``capabilities()`` says
which are in); a tile whose codec is not in is rejected by the native
decoder and decoded in Python by the callers. A library that fails to
build or to load raises ``RuntimeError`` with the compiler's log: nothing
falls back to Python in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "native" / "biscuit_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_CODEC_LIBS = {"BN_HAVE_PNG": "-lpng", "BN_HAVE_JPEG": "-ljpeg"}
_CAPS = {"png": 1, "jpeg": 2, "j2k": 8, "sse42_crc32c": 16}  # bn_capabilities

_lib = None
_plan: Optional[Tuple[List[str], Path]] = None
_tiff_from: Optional[str] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native data plane is built "
                           "with it at first use (or set CXX)")
    return cxx


def _build_plan() -> Tuple[List[str], Path]:
    """(compile command without its output, library path), worked out
    once a process: which codec headers the compiler finds decides the
    defines, the link libraries and the hash."""
    global _plan
    if _plan is not None:
        return _plan
    cxx = _cxx()
    probe = subprocess.run([cxx, "-E", "-dM", "-std=c++17", str(SOURCE)],
                           capture_output=True, text=True)
    if probe.returncode != 0:
        raise RuntimeError(f"{cxx} could not preprocess {SOURCE}:\n"
                           + probe.stderr[-4000:])
    macros = dict(line.split()[1:3] for line in probe.stdout.splitlines()
                  if line.startswith("#define BN_HAVE_"))
    have = {name: macros.get(name) == "1" for name in _CODEC_LIBS}
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[:1]
    defines = [f"-D{name}={int(on)}" for name, on in have.items()]
    libs = [lib for name, lib in _CODEC_LIBS.items() if have[name]]
    cmd = [cxx, *CXX_FLAGS, *defines, str(SOURCE), *libs, "-ldl",
           "-lpthread"]
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in cmd[1:] + version:
        h.update(part.encode())
    _plan = cmd, BUILD_DIR / f"libbiscuit_native-{h.hexdigest()[:16]}.so"
    return _plan


def lib_path() -> Path:
    """Where this machine's build of the library lives."""
    return _build_plan()[1]


def build() -> Path:
    """Compile the library unless this machine's build exists; returns
    its path. Raises RuntimeError with the compiler's log on failure."""
    cmd, out = _build_plan()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cmd[0], "-o", str(tmp), *cmd[1:]],
                         capture_output=True, text=True)
    (BUILD_DIR / "biscuit_native.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native data plane failed (exit "
            f"{res.returncode}):\n{' '.join(cmd)}\n"
            + (res.stdout + res.stderr)[-4000:])
    os.replace(tmp, out)
    return out


def _proto(fn, restype, argtypes) -> None:
    fn.restype = restype
    fn.argtypes = argtypes


def load() -> ctypes.CDLL:
    """The library, built first if needed, its prototypes set."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading {path} failed: {e}") from e
    c = ctypes
    i64p = c.POINTER(c.c_int64)
    _proto(lib.bn_crc32c, c.c_uint32, [c.c_char_p, c.c_size_t])
    _proto(lib.bn_decode_image, c.c_int,
           [c.c_char_p, c.c_size_t, c.c_void_p, c.c_size_t,
            c.POINTER(c.c_int), c.POINTER(c.c_int)])
    _proto(lib.bn_index_tfrecord, c.c_long, [c.c_char_p, i64p, c.c_long])
    _proto(lib.bn_read_decode_batch, c.c_long,
           [c.c_char_p, i64p, c.c_long, c.c_int, c.c_void_p, c.c_char_p,
            c.c_int, i64p, i64p, c.c_int, c.c_int])
    _proto(lib.bn_j2k_available, c.c_int32, [])
    _proto(lib.bn_j2k_decode, c.c_int,
           [c.c_char_p, c.c_int64, c.c_void_p, c.c_int64, i64p, i64p,
            c.c_int32])
    _proto(lib.bn_tiff_available, c.c_int32, [])
    _proto(lib.bn_tiff_load, c.c_int32, [c.c_char_p])
    _proto(lib.bn_tiff_open, c.c_void_p,
           [c.c_char_p, c.c_int32, i64p, i64p, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32)])
    _proto(lib.bn_tiff_levels, c.c_int32, [c.c_char_p, i64p, i64p, c.c_int32])
    _proto(lib.bn_tiff_read_region, c.c_int,
           [c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_int64,
            c.c_void_p])
    _proto(lib.bn_tiff_close, None, [c.c_void_p])
    _proto(lib.bn_tiff_description, c.c_int32,
           [c.c_char_p, c.c_char_p, c.c_int32])
    _proto(lib.bn_tiff_write_tiled, c.c_int,
           [c.c_char_p, c.c_int64, c.c_int64, c.c_int32, c.c_int32,
            c.c_void_p, c.c_int, c.c_int])
    _proto(lib.bn_capabilities, c.c_int32, [])
    _proto(lib.bn_version, c.c_char_p, [])
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library loads in this process, built first where it
    is not yet: False when g++ fails or the result does not load."""
    try:
        load()
        return True
    except (OSError, RuntimeError):
        return False


def loaded() -> bool:
    """Whether this process has loaded the library (nothing is built)."""
    return _lib is not None


def _pillow_libs(stem: str) -> List[Path]:
    """The copies of ``stem`` (e.g. "libtiff") that Pillow's extension
    loads: the files of this process's mappings after ``PIL._imaging`` is
    imported, then any in ``pillow.libs/`` beside the ``PIL`` package
    (where a wheel keeps them)."""
    import importlib.util

    found = []
    try:
        import PIL._imaging  # noqa: F401  (maps Pillow's libraries)

        with open("/proc/self/maps") as f:
            for line in f:
                path = Path(line.split()[-1])
                if path.name.startswith((stem + "-", stem + ".")):
                    found.append(path)
    except (ImportError, OSError):
        pass
    spec = importlib.util.find_spec("PIL")
    if spec is not None and spec.submodule_search_locations:
        libs = Path(list(spec.submodule_search_locations)[0]).parent / \
            "pillow.libs"
        found += sorted(libs.glob(f"{stem}-*.so*"))
    return list(dict.fromkeys(found))


def tiff_library() -> Optional[str]:
    """Which libtiff the TIFF reader uses: "system", the path of the copy
    Pillow loads where the system has none, or None without either."""
    global _tiff_from
    if _tiff_from is None:
        lib = load()
        if lib.bn_tiff_available():
            _tiff_from = "system"
        else:
            for path in _pillow_libs("libtiff"):
                if lib.bn_tiff_load(str(path).encode()):
                    _tiff_from = str(path)
                    break
    return _tiff_from


def capabilities() -> Dict[str, bool]:
    """Which parts the library has here: the PNG and JPEG codecs (built
    in where their headers were found), the tiled-TIFF reader (a libtiff
    found at run time, ``tiff_library()``), JPEG2000 tiles (libopenjp2
    found) and CRC32C on SSE4.2."""
    caps = int(load().bn_capabilities())
    out = {name: bool(caps & bit) for name, bit in _CAPS.items()}
    return {**out, "tiff": tiff_library() is not None}


def version() -> str:
    return load().bn_version().decode()


def native_crc32c(data: bytes) -> int:
    return int(load().bn_crc32c(data, len(data)))


def native_decode(raw: bytes) -> Optional[np.ndarray]:
    """Decode a PNG/JPEG tile to HWC uint8 RGB; None if undecodable (or
    its codec is not built in)."""
    lib = load()
    # Start with a 1-megapixel buffer (covers 299/512px tiles); grow 4x on
    # rc=-4 (buffer too small) up to a 20k x 20k safety cap.
    cap = 1024 * 1024 * 3
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.bn_decode_image(
            raw, len(raw), out.ctypes.data_as(ctypes.c_void_p), cap,
            ctypes.byref(w), ctypes.byref(h),
        )
        if rc != -4:  # -4 = buffer too small: grow geometrically
            break
        cap *= 4
        if cap > 20_000 * 20_000 * 3:
            return None
    if rc != 0:
        return None
    return out[: w.value * h.value * 3].reshape(h.value, w.value, 3).copy()


def native_index_tfrecord(path: str) -> np.ndarray:
    lib = load()
    cap = 1 << 16
    while True:
        offsets = np.zeros(cap, np.int64)
        n = lib.bn_index_tfrecord(
            path.encode(), offsets.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)), cap,
        )
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            raise IOError(f"failed to index {path}")
        return offsets[:n].copy()


def native_read_decode_batch(
    path: str,
    offsets: np.ndarray,
    tile_px: int,
    verify_crc: bool = False,
    threads: int = 0,
    slide_width: int = 128,
) -> Tuple[np.ndarray, List[str], np.ndarray, np.ndarray, int]:
    """Threaded read+parse+decode of `len(offsets)` tiles from one tfrecord
    (``threads`` workers, 0 for one a core), with the GIL released.

    Returns (images (N,tile,tile,3) uint8, slides, locs (N,2) int64,
    labels (N,) int64, n_ok). Failed tiles are zero-filled with loc_x=-1.
    """
    lib = load()
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets)
    images = np.empty((n, tile_px, tile_px, 3), np.uint8)
    slides = ctypes.create_string_buffer(n * slide_width)
    locs = np.zeros((n, 2), np.int64)
    labels = np.full((n,), -1, np.int64)
    ok = lib.bn_read_decode_batch(
        path.encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, tile_px,
        images.ctypes.data_as(ctypes.c_void_p),
        slides, slide_width,
        locs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        1 if verify_crc else 0, threads,
    )
    if ok < 0:
        raise IOError(f"native batch read failed for {path} (rc={ok})")
    slide_names = [
        slides.raw[i * slide_width:(i + 1) * slide_width]
        .split(b"\x00")[0].decode()
        for i in range(n)
    ]
    return images, slide_names, locs, labels, int(ok)


def _tiff_lib() -> ctypes.CDLL:
    """The library, with libtiff found: a machine without libtiff raises
    here rather than have every TIFF rejected as if by its format."""
    if tiff_library() is None:
        raise RuntimeError("the tiled-TIFF reader needs libtiff: dlopen "
                           "found neither libtiff.so.6 / libtiff.so nor "
                           "the copy Pillow loads: "
                           f"{_pillow_libs('libtiff') or 'none'}")
    return load()


class TiledTiff:
    """Bounded-memory region reader for tiled TIFF/SVS slides.

    Decodes only the TIFF tiles intersecting each requested region, so
    reading a 100k x 100k slide never materializes the full image (PIL
    would). Aperio JPEG2000 levels (compression 33003 YCbCr / 33005 RGB)
    decode through OpenJPEG (dlopen'd libopenjp2; raw tile reads +
    bn_j2k_decode). Unsupported containers (striped TIFF; J2K when
    libopenjp2 is absent) raise OSError at open, and ``data/slide.py``
    reads them through PIL. Not thread-safe per handle (libtiff's TIFF*
    is stateful)."""

    def __init__(self, path: str, level: int = 0):
        lib = _tiff_lib()
        w = ctypes.c_int64()
        h = ctypes.c_int64()
        tw = ctypes.c_int32()
        th = ctypes.c_int32()
        sup = ctypes.c_int32()
        self._h = lib.bn_tiff_open(
            path.encode(), int(level), ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(tw), ctypes.byref(th), ctypes.byref(sup))
        if not self._h or not sup.value:
            self._h = None
            raise OSError(
                f"not a supported tiled TIFF (striped or JPEG2000?): "
                f"{path} level {level}")
        self._lib = lib
        self.level = level
        self.width = int(w.value)
        self.height = int(h.value)
        self.tile_size = (int(tw.value), int(th.value))
        self.path = path

    @staticmethod
    def levels(path: str):
        """[(width, height)] per pyramid level (TIFF directory)."""
        lib = _tiff_lib()
        cap = 32
        ws = (ctypes.c_int64 * cap)()
        hs = (ctypes.c_int64 * cap)()
        n = lib.bn_tiff_levels(path.encode(), ws, hs, cap)
        if n < 0:
            raise OSError(f"cannot open TIFF: {path}")
        return [(int(ws[i]), int(hs[i])) for i in range(min(n, cap))]

    @staticmethod
    def description(path: str):
        """ImageDescription (tag 270) of directory 0, or None. Carries
        Aperio's 'MPP = x' metadata; used when PIL cannot open the
        container at all (J2K-compressed .svs)."""
        lib = _tiff_lib()
        buf = ctypes.create_string_buffer(65536)
        n = lib.bn_tiff_description(path.encode(), buf, 65536)
        if n < 0:
            return None
        return buf.value.decode(errors="ignore")

    def read_region(self, x: int, y: int, w: int, h: int) -> np.ndarray:
        """(h, w, 3) uint8 RGB at this level; out-of-image is zero."""
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.bn_tiff_read_region(
            self._h, int(x), int(y), int(w), int(h),
            out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise OSError(f"tiff read_region failed (rc={rc}): {self.path}")
        return out

    def thumbnail(self, max_px: int = 2048) -> np.ndarray:
        """Downsampled full-slide RGB (for QC masks). Reads from the
        smallest pyramid level that still meets max_px (decoding a
        low-res level beats band-scanning the base by the downsample
        factor squared); within the chosen level, bands bound memory."""
        if self.level == 0:
            try:
                lv = self.levels(self.path)
            except OSError:
                lv = []
            best = None
            for i, (w, h) in enumerate(lv[1:], start=1):
                # Keep only true pyramid levels (aspect preserved, smaller),
                # skipping label/macro images common in .svs directories.
                if not w or not h:
                    continue
                if abs((w / h) - (self.width / self.height)) > 0.05:
                    continue
                if max(w, h) >= max_px and (best is None or w < best[1]):
                    best = (i, w)
            if best is not None:
                try:
                    sub = TiledTiff(self.path, level=best[0])
                    try:
                        return sub.thumbnail(max_px)
                    finally:
                        sub.close()
                except OSError:
                    pass
        ds = max(1, int(np.ceil(max(self.width, self.height) / max_px)))
        ow = max(1, self.width // ds)
        oh = max(1, self.height // ds)
        # Bands must start on multiples of ds so pooled rows land exactly.
        band_rows = -(-max(self.tile_size[1], ds) // ds) * ds
        thumb = np.empty((oh, ow, 3), np.uint8)
        for y0 in range(0, oh * ds, band_rows):
            # Band heights are positive ds-multiples by construction.
            band = self.read_region(0, y0, ow * ds, min(band_rows,
                                                        oh * ds - y0))
            pooled = band.reshape(
                band.shape[0] // ds, ds, ow, ds, 3).mean(axis=(1, 3))
            r0 = y0 // ds
            thumb[r0:r0 + pooled.shape[0]] = pooled.astype(np.uint8)
        return thumb

    def close(self):
        if self._h is not None:
            self._lib.bn_tiff_close(self._h)
            self._h = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass


def write_tiled_tiff(path: str, rgb: np.ndarray, tile: int = 64,
                     jpeg: bool = False, append: bool = False) -> None:
    """Write a tiled RGB TIFF (the .svs-style layout when jpeg=True).
    append=True adds a new TIFF directory — i.e. a pyramid level — to an
    existing file."""
    lib = _tiff_lib()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    rc = lib.bn_tiff_write_tiled(
        path.encode(), w, h, tile, tile,
        rgb.ctypes.data_as(ctypes.c_void_p), int(jpeg), int(append))
    if rc != 0:
        raise OSError(f"tiff write failed (rc={rc}): {path}")
