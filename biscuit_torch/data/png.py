"""PNG decoding with ``zlib`` and numpy, so tiles decode where Pillow is
not installed.

Counterpart of the PNG half of the JAX package's native decoder
(``biscuit_tpu/data/native_loader.py`` ``native_decode``, libpng). It
takes the PNGs that tile archives hold: 8-bit, non-interlaced, grey (0),
RGB (2), grey + alpha (4) or RGBA (6), with any of the five row filters,
and returns what Pillow's ``Image.open(...).convert("RGB")`` gives, bit
for bit: grey replicated to three channels, alpha dropped. ``decode_png``
returns None for any other image. ``data/pipeline.decode_image`` calls
it only where Pillow is not installed: Pillow decodes a Pillow-written
299-px tile about ten times faster.

The None, Sub and Up filters vectorize along a row. Average and Paeth
predict each byte from the reconstructed byte to its left, so an image
with such a row is reconstructed along anti-diagonals of pixels (a
wavefront: pixel (r, c) needs (r, c - 1), (r - 1, c) and (r - 1, c - 1),
all on earlier diagonals), rows + columns - 1 vector steps of slices.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels, for the types decoded here.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(raw: bytes):
    """(type, data) of each chunk after the signature; checks each CRC."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(raw):
            raise ValueError("truncated PNG chunk")
        data = raw[pos + 8:end]
        (crc,) = struct.unpack(">I", raw[end:end + 4])
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG ends before its IEND chunk")


def header(raw: bytes):
    """(width, height, bit depth, colour type, interlace) of a PNG, or None
    if ``raw`` is not one."""
    if (not raw.startswith(SIGNATURE) or raw[12:16] != b"IHDR"
            or len(raw) < 29):
        return None
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
        ">IIBBBBB", raw[16:29])
    return w, h, depth, ctype, interlace


def describe(raw: bytes) -> str:
    """The image format of ``raw``, in words, for error messages."""
    hdr = header(raw)
    if hdr is not None:
        _, _, depth, ctype, interlace = hdr
        return (f"PNG (bit depth {depth}, colour type {ctype}, "
                f"interlace {interlace})")
    if raw.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    return f"unrecognized image (first bytes {raw[:8].hex()})"


def _rows(raw, kinds, out):
    """None, Sub and Up rows, one vector step a row."""
    prior = np.zeros(raw.shape[1:], np.uint8)
    for r, kind in enumerate(kinds):
        if kind == 0:
            out[r] = raw[r]
        elif kind == 1:                      # running sum mod 256
            np.cumsum(raw[r], axis=0, dtype=np.uint8, out=out[r])
        else:
            np.add(raw[r], prior, out=out[r])
        prior = out[r]


def _wavefront(raw, kinds, out):
    """All rows, any filters, along anti-diagonals of pixels: one vector
    step a diagonal, h + w - 1 steps.

    The bytes are held skewed, diagonal d = r + c in row d + 2 and image
    row r in column r + 1, with zeros around the image. Then a
    diagonal's left (a), upper (b) and upper-left (c) neighbours are
    slices of the two rows before it, so a step indexes nothing. The
    None, Sub, Up and Average predictions are one formula,
    (wa * a + wb * b) >> 1, with (wa, wb) = (0, 0), (2, 0), (0, 2) or
    (1, 1) by the row's filter."""
    h, w, bpp = raw.shape
    r, c = np.divmod(np.arange(h * w), w)
    skew = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    x = np.zeros_like(skew)
    x[r + c + 2, r + 1] = raw.reshape(h * w, bpp)
    weights = np.array([[0, 0], [2, 0], [0, 2], [1, 1], [0, 0]], np.int16)
    wa, wb = weights[kinds].T[:, :, None]
    paeth_rows = (kinds == 4)[:, None]
    any_paeth, all_paeth = paeth_rows.any(), paeth_rows.all()
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = skew[d + 1, lo + 1:hi + 1]
        b = skew[d + 1, lo:hi]
        ul = skew[d, lo:hi]
        if any_paeth:
            t1 = b - ul
            t2 = a - ul
            pa, pb, pc = np.abs(t1), np.abs(t2), np.abs(t1 + t2)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, ul))
        if not all_paeth:
            lin = (wa[lo:hi] * a + wb[lo:hi] * b) >> 1
            pred = np.where(paeth_rows[lo:hi], pred, lin) if any_paeth else lin
        skew[d + 2, lo + 1:hi + 1] = (x[d + 2, lo + 1:hi + 1] + pred) & 0xFF
    out[:] = skew[r + c + 2, r + 1].reshape(h, w, bpp)


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, w, bpp) uint8. An image with an
    Average or Paeth row takes the wavefront; else one step a row."""
    rows = np.frombuffer(data, np.uint8).reshape(h, w * bpp + 1)
    kinds = rows[:, 0]
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    raw = rows[:, 1:].reshape(h, w, bpp)
    out = np.empty((h, w, bpp), np.uint8)
    if kinds.size and int(kinds.max()) >= 3:
        _wavefront(raw, kinds, out)
    else:
        _rows(raw, kinds, out)
    return out


def decode_png(raw: bytes) -> Optional[np.ndarray]:
    """HWC uint8 RGB of an 8-bit non-interlaced grey/RGB(A) PNG; None for
    any other image (not a PNG, a palette, 1-, 2-, 4- or 16-bit samples,
    Adam7 interlace). Raises ValueError on a corrupt PNG."""
    hdr = header(raw)
    if hdr is None:
        return None
    w, h, depth, ctype, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        return None
    bpp = _CHANNELS[ctype]
    idat = b"".join(data for kind, data in _chunks(raw) if kind == b"IDAT")
    try:
        data = zlib.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if len(data) != h * (w * bpp + 1):
        raise ValueError(f"PNG data holds {len(data)} bytes, expected "
                         f"{h * (w * bpp + 1)} for {w}x{h}x{bpp}")
    img = _unfilter(data, h, w, bpp)
    if bpp < 3:                              # grey (+ alpha): replicate
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
