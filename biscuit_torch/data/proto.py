"""Minimal protobuf wire-format codec for tf.train.Example (the port's
copy of ``biscuit_tpu/data/proto.py``).

The reference stack stores tiles in slideflow-written TFRecords of
``tf.train.Example`` protos with features ``slide`` (bytes), ``image_raw``
(bytes, PNG/JPEG-encoded tile) and optionally ``loc_x``/``loc_y`` (int64)
(SURVEY.md §2.3 E3). TensorFlow is not a dependency of this framework, so we
speak the wire format directly; the schema is tiny and fixed:

    Example    { Features features = 1; }
    Features   { map<string, Feature> feature = 1; }
    Feature    { oneof { BytesList bytes_list = 1; FloatList float_list = 2;
                         Int64List int64_list = 3; } }
    BytesList  { repeated bytes value = 1; }
    FloatList  { repeated float value = 1 [packed]; }
    Int64List  { repeated int64 value = 1 [packed]; }

Values round-trip with TensorFlow's own serialization (same bytes for the
canonical field ordering TF uses).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[bytes, List[bytes], List[int], List[float]]

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


# --- Encoding ----------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_varint_i64(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    return _varint(v)


def _len_delim(field_num: int, payload: bytes) -> bytes:
    return _varint((field_num << 3) | _WT_LEN) + _varint(len(payload)) + payload


def _encode_feature(value: FeatureValue) -> bytes:
    """Encode one Feature message from a python value."""
    if isinstance(value, bytes):
        value = [value]
    if not isinstance(value, (list, tuple)):
        value = [value]
    if len(value) and isinstance(value[0], bytes):
        inner = b"".join(_len_delim(1, v) for v in value)
        return _len_delim(1, inner)  # bytes_list = field 1
    if len(value) and isinstance(value[0], float):
        payload = struct.pack(f"<{len(value)}f", *value)
        inner = _len_delim(1, payload)  # packed floats
        return _len_delim(2, inner)  # float_list = field 2
    # default: int64 list (also for empty lists)
    payload = b"".join(_encode_varint_i64(int(v)) for v in value)
    inner = _len_delim(1, payload)  # packed varints
    return _len_delim(3, inner)  # int64_list = field 3


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize a dict of feature values into a tf.train.Example proto."""
    entries = b""
    for key in features:
        feat = _encode_feature(features[key])
        entry = _len_delim(1, key.encode()) + _len_delim(2, feat)
        entries += _len_delim(1, entry)  # Features.feature map entry
    return _len_delim(1, entries)  # Example.features


# --- Decoding ----------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_num, wire_type, value_bytes_or_int) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field_num, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == _WT_I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == _WT_I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"Unsupported wire type {wt}")
        yield field_num, wt, val


def _decode_feature(buf: bytes) -> FeatureValue:
    for fnum, _wt, val in _iter_fields(buf):
        if fnum == 1:  # BytesList
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if fnum == 2:  # FloatList
            out: List[float] = []
            for f, wt, v in _iter_fields(val):
                if f != 1:
                    continue
                if wt == _WT_LEN:  # packed
                    out.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:  # unpacked fixed32
                    out.extend(struct.unpack("<f", v))
            return out
        if fnum == 3:  # Int64List
            ints: List[int] = []
            for f, wt, v in _iter_fields(val):
                if f != 1:
                    continue
                if wt == _WT_LEN:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        if x >= 1 << 63:
                            x -= 1 << 64
                        ints.append(x)
                else:
                    x = v
                    if x >= 1 << 63:
                        x -= 1 << 64
                    ints.append(x)
            return ints
    return []


def decode_example(buf: bytes) -> Dict[str, FeatureValue]:
    """Parse a tf.train.Example proto into {name: value-list}.

    BytesList features of length 1 are returned as raw ``bytes`` for
    ergonomic access to 'image_raw'/'slide'.
    """
    features: Dict[str, FeatureValue] = {}
    for fnum, _wt, val in _iter_fields(buf):
        if fnum != 1:
            continue
        for f2, _wt2, entry in _iter_fields(val):
            if f2 != 1:
                continue
            key = None
            feat: FeatureValue = []
            for f3, _wt3, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:
                    feat = _decode_feature(v3)
            if key is not None:
                if (
                    isinstance(feat, list)
                    and len(feat) == 1
                    and isinstance(feat[0], bytes)
                ):
                    feat = feat[0]
                features[key] = feat
    return features
