"""TFRecord files and `tf.train.Example` messages without TensorFlow.

What `tf.io.TFRecordWriter`, `tf.data.TFRecordDataset` and
`tf.train.Example` do for the native episode shards
(`openvla_oft_tpu/data/rlds/pipeline.py:19-24, 50-114`):

  - framing: each record is a little-endian uint64 length, the masked
    CRC-32C of those 8 bytes (uint32), the data, then the masked CRC-32C of
    the data. The reader checks both and raises on a mismatch or a
    truncated record. The CRC runs in the host library
    (`hostsrc/crc32c.cc`); `crc32c_plain` is its plain version.
  - Example: protobuf wire format, `Example{features: Features{feature:
    map<string, Feature>}}`, a Feature one of BytesList (1), FloatList (2)
    or Int64List (3). The parser takes packed and unpacked repeated fields;
    the writer packs floats and ints and orders the map by key.

Parsed features are (kind, values): ("bytes", list of bytes), ("float",
float32 array) or ("int64", int64 array).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from openvla_oft_tpu_torch.processing.sentencepiece import _iter_fields, _read_varint

_MASK_DELTA = 0xA282EAD8


def _table() -> List[int]:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 & -(c & 1))
        out.append(c)
    return out


_CRC_TABLE = _table()


def crc32c_plain(data: bytes) -> int:
    """CRC-32C (Castagnoli) in Python, byte by byte."""
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ _CRC_TABLE[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """CRC-32C by the host library."""
    from openvla_oft_tpu_torch._host_build import library

    return library().openvla_crc32c(data, len(data), 0)


def masked_crc(crc: int) -> int:
    """TFRecord's mask: rotate right by 15, add a constant."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def write_tfrecords(path: str, records) -> None:
    """Write each bytes record of `records` to `path`, framed."""
    with open(path, "wb") as f:
        for data in records:
            head = struct.pack("<Q", len(data))
            f.write(head + struct.pack("<I", masked_crc(crc32c(head))))
            f.write(data)
            f.write(struct.pack("<I", masked_crc(crc32c(data))))


def read_tfrecords(path: str) -> Iterator[bytes]:
    """The records of a TFRecord file, each one's two CRCs checked."""
    with open(path, "rb") as f:
        offset = 0
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"{path}: truncated record header at byte {offset}")
            length, crc = struct.unpack("<QI", head)
            if masked_crc(crc32c(head[:8])) != crc:
                raise ValueError(f"{path}: corrupted record length at byte {offset}")
            data = f.read(length)
            tail = f.read(4)
            if len(data) < length or len(tail) < 4:
                raise ValueError(f"{path}: truncated record at byte {offset}")
            if masked_crc(crc32c(data)) != struct.unpack("<I", tail)[0]:
                raise ValueError(f"{path}: corrupted record data at byte {offset}")
            offset += 16 + length
            yield data


# === tf.train.Example ===
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                     # int64 as two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def _feature(kind: str, values) -> bytes:
    if kind == "bytes":
        body = b"".join(_field(1, bytes(v)) for v in values)
        return _field(1, body)
    if kind == "float":
        packed = np.asarray(values, "<f4").tobytes()
        return _field(2, _field(1, packed) if packed else b"")
    if kind == "int64":
        packed = b"".join(_varint(int(v)) for v in np.asarray(values, np.int64))
        return _field(3, _field(1, packed) if packed else b"")
    raise ValueError(f"unknown feature kind {kind!r}")


def serialize_example(features: Dict[str, Tuple[str, object]]) -> bytes:
    """{name: (kind, values)} -> a serialized tf.train.Example."""
    entries = b"".join(_field(1, _field(1, name.encode()) + _field(2, _feature(*features[name])))
                       for name in sorted(features))
    return _field(1, entries)


def _signed(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


def _parse_feature(data: bytes) -> Tuple[str, object]:
    kind, body = "none", b""
    for field, wire, val in _iter_fields(data):
        if wire != 2 or field not in (1, 2, 3):
            raise ValueError(f"bad Feature field {field} (wire type {wire})")
        kind, body = {1: "bytes", 2: "float", 3: "int64"}[field], val
    if kind == "bytes":
        return kind, [v for f, w, v in _iter_fields(body) if f == 1 and w == 2]
    if kind == "float":
        parts = []
        for f, w, v in _iter_fields(body):
            if f != 1:
                continue
            if w == 2:                                   # packed
                parts.append(np.frombuffer(v, "<f4"))
            elif w == 5:                                 # one unpacked float
                parts.append(np.asarray([v], "<u4").view("<f4"))
            else:
                raise ValueError(f"bad FloatList wire type {w}")
        return kind, (np.concatenate(parts) if parts else np.zeros(0, "<f4")).astype(np.float32)
    if kind == "int64":
        out = []
        for f, w, v in _iter_fields(body):
            if f != 1:
                continue
            if w == 0:                                   # one unpacked varint
                out.append(_signed(v))
            elif w == 2:                                 # packed varints
                i = 0
                while i < len(v):
                    n, i = _read_varint(v, i)
                    out.append(_signed(n))
            else:
                raise ValueError(f"bad Int64List wire type {w}")
        return kind, np.asarray(out, np.int64)
    return "none", []                                    # a Feature with no list set


def parse_example(data: bytes) -> Dict[str, Tuple[str, object]]:
    """A serialized tf.train.Example -> {name: (kind, values)}."""
    out = {}
    for field, wire, features in _iter_fields(data):
        if field != 1 or wire != 2:
            continue
        for f, w, entry in _iter_fields(features):
            if f != 1 or w != 2:
                continue
            name, value = b"", b""
            for ef, ew, ev in _iter_fields(entry):
                if ef == 1 and ew == 2:
                    name = ev
                elif ef == 2 and ew == 2:
                    value = ev
            out[name.decode()] = _parse_feature(value)
    return out
