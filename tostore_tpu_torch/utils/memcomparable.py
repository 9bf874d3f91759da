"""Order-preserving binary key encoding.

Parity with the reference's universal index key format
(handler/memcomparable.dart:1-368): typed values encode to byte strings
whose lexicographic order equals the values' logical order, so multi-field
index keys are just concatenations and range scans are byte-range scans.

Layout per value: [type:1][payload]; tuples concatenate encoded parts with
a 0x00 terminator per part escape-free via length-prefix-by-type:
  0x01 null (sorts first)
  0x02 false / 0x03 true
  0x04 int64: sign-flipped big-endian (reference :53-61)
  0x05 float64: IEEE bits with sign-dependent flip (total order)
  0x06 text: utf8 with 0x00 -> 0x00 0xFF escape, 0x00 0x00 terminator
  0x07 bytes: same escape as text
"""

from __future__ import annotations

import struct


def _enc_int(n: int) -> bytes:
    return struct.pack(">Q", (n + (1 << 63)) & ((1 << 64) - 1))


def _dec_int(b: bytes) -> int:
    return struct.unpack(">Q", b)[0] - (1 << 63)


def _enc_float(x: float) -> bytes:
    bits = struct.unpack(">Q", struct.pack(">d", x))[0]
    if bits & (1 << 63):
        bits = ~bits & ((1 << 64) - 1)  # negative: flip all
    else:
        bits |= 1 << 63  # positive: flip sign bit
    return struct.pack(">Q", bits)


def _dec_float(b: bytes) -> float:
    bits = struct.unpack(">Q", b)[0]
    if bits & (1 << 63):
        bits &= ~(1 << 63) & ((1 << 64) - 1)
    else:
        bits = ~bits & ((1 << 64) - 1)
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def _enc_blob(b: bytes) -> bytes:
    return b.replace(b"\x00", b"\x00\xff") + b"\x00\x00"


def _dec_blob(data: bytes, pos: int) -> tuple[bytes, int]:
    out = bytearray()
    while True:
        i = data.index(b"\x00", pos)
        out += data[pos:i]
        nxt = data[i + 1]
        pos = i + 2
        if nxt == 0x00:
            return bytes(out), pos
        if nxt == 0xFF:
            out.append(0)
        else:
            raise ValueError("bad escape")


def encode_value(v) -> bytes:
    if v is None:
        return b"\x01"
    if isinstance(v, bool):
        return b"\x03" if v else b"\x02"
    if isinstance(v, int):
        return b"\x04" + _enc_int(v)
    if isinstance(v, float):
        return b"\x05" + _enc_float(v)
    if isinstance(v, str):
        return b"\x06" + _enc_blob(v.encode())
    if isinstance(v, (bytes, bytearray)):
        return b"\x07" + _enc_blob(bytes(v))
    raise TypeError(f"not memcomparable: {type(v)}")


def encode_tuple(values) -> bytes:
    return b"".join(encode_value(v) for v in values)


def decode_tuple(data: bytes):
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        if tag == 0x01:
            out.append(None)
        elif tag == 0x02:
            out.append(False)
        elif tag == 0x03:
            out.append(True)
        elif tag == 0x04:
            out.append(_dec_int(data[pos : pos + 8]))
            pos += 8
        elif tag == 0x05:
            out.append(_dec_float(data[pos : pos + 8]))
            pos += 8
        elif tag == 0x06:
            s, pos = _dec_blob(data, pos)
            out.append(s.decode())
        elif tag == 0x07:
            b, pos = _dec_blob(data, pos)
            out.append(b)
        else:
            raise ValueError(f"bad tag {tag}")
    return tuple(out)


def prefix_upper_bound(prefix: bytes) -> bytes:
    """Smallest byte string greater than every string with this prefix
    (reference [prefix, prefix+0xFF) range scans, index_manager.dart:3299)."""
    b = bytearray(prefix)
    while b and b[-1] == 0xFF:
        b.pop()
    if not b:
        return b"\xff" * 9
    b[-1] += 1
    return bytes(b)
