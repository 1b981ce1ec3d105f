"""TFRecord container I/O with no TensorFlow (the port's copy of
``biscuit_tpu/data/tfrecord.py``).

The TFRecord on-disk framing, ``uint64le length, uint32le
masked_crc32c(length), payload, uint32le masked_crc32c(payload)``, so
tile archives written by either package (or by slideflow) load in the
other. The readers by index skip the CRCs, and a ``.index.npy`` sidecar
of record offsets gives O(1) random access, as slideflow's index files
do; the sequential readers (``read_records``, ``read_examples``) check
them on request.

CRC32C (Castagnoli) runs through the native library
(``data/native_loader.py``, SSE4.2 or slicing-by-8) once this process has
loaded it, as the JAX package's runs through its own where built; before
that, a per-byte table loop in Python, which writes at a few MB/s.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

from .proto import decode_example, encode_example


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``: the native library's where this process has
    loaded it (nothing is built here), else the Python table loop. The
    CRC has a sequential dependency from byte to byte, so numpy cannot
    vectorize the loop."""
    from . import native_loader

    if native_loader.loaded():
        return native_loader.native_crc32c(data)
    tab = _CRC_TABLE
    crc_val = 0xFFFFFFFF
    for b in data:
        crc_val = tab[(crc_val ^ b) & 0xFF] ^ (crc_val >> 8)
    return crc_val ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
    """Streaming TFRecord writer with automatic .index sidecar."""

    def __init__(self, path: str, index: bool = True):
        self.path = path
        self._f = open(path, "wb")
        self._offsets: List[int] = []
        self._index = index
        self._pos = 0

    def write(self, payload: bytes) -> None:
        self._offsets.append(self._pos)
        header = struct.pack("<Q", len(payload))
        rec = (
            header
            + struct.pack("<I", masked_crc(header))
            + payload
            + struct.pack("<I", masked_crc(payload))
        )
        self._f.write(rec)
        self._pos += len(rec)

    def write_example(self, features: Dict) -> None:
        self.write(encode_example(features))

    def write_tile(
        self,
        slide: str,
        image_raw: bytes,
        loc_x: Optional[int] = None,
        loc_y: Optional[int] = None,
        label: Optional[int] = None,
    ) -> None:
        """Write a tile in the slideflow feature schema."""
        feats: Dict = {"slide": slide.encode(), "image_raw": image_raw}
        if loc_x is not None:
            feats["loc_x"] = [int(loc_x)]
        if loc_y is not None:
            feats["loc_y"] = [int(loc_y)]
        if label is not None:
            feats["label"] = [int(label)]
        self.write_example(feats)

    def close(self) -> None:
        self._f.close()
        if self._index:
            np.save(self.path + ".index.npy", np.asarray(self._offsets, np.int64))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify: bool = False) -> Iterator[bytes]:
    """Each record's payload in file order; with ``verify``, each header
    and payload CRC is checked, and a mismatch raises ``IOError``."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (crc_h,) = struct.unpack("<I", f.read(4))
            payload = f.read(length)
            (crc_p,) = struct.unpack("<I", f.read(4))
            if verify:
                if masked_crc(header) != crc_h:
                    raise IOError(f"Corrupt record header in {path}")
                if masked_crc(payload) != crc_p:
                    raise IOError(f"Corrupt record payload in {path}")
            yield payload


def read_examples(path: str, verify: bool = False) -> Iterator[Dict]:
    """Each record decoded (``proto.decode_example``), in file order."""
    for payload in read_records(path, verify=verify):
        yield decode_example(payload)


def load_index(path: str) -> np.ndarray:
    """Record byte-offsets for random access; builds sidecar if missing."""
    idx_path = path + ".index.npy"
    if os.path.exists(idx_path):
        return np.load(idx_path)
    offsets = []
    pos = 0
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            offsets.append(pos)
            # Skip header CRC (4) + payload + payload CRC (4).
            f.seek(4 + length + 4, os.SEEK_CUR)
            pos += 8 + 4 + length + 4
    arr = np.asarray(offsets, np.int64)
    try:
        np.save(idx_path, arr)
    except OSError:
        pass
    return arr


def read_example_at(f, offset: int) -> Dict:
    """Read one example from an open file handle at a byte offset."""
    f.seek(offset)
    (length,) = struct.unpack("<Q", f.read(8))
    f.read(4)
    payload = f.read(length)
    return decode_example(payload)


def count_records(path: str) -> int:
    return int(load_index(path).shape[0])
