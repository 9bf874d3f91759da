"""Compact binary value codec + CRC framing.

The parity layer for the reference's binary codecs
(handler/binary_map_codec.dart, binary_schema_codec.dart,
wal_encoder.dart, platform_byte_data.dart): a msgpack-like tagged encoding
for the JSON-ish value universe plus bytes and float32 arrays (vectors),
used by the WAL and snapshots. The byte stream equals the JAX package's
`tostore_tpu/utils/codec.py` for the same values, in both directions:
bfloat16 arrays (dtype code 8) are carried as `BF16Array` here and as
`ml_dtypes` arrays there. A C++ accelerator (native/) can replace the
hot loops; this pure-Python module is the reference implementation and
fallback.

Wire format (one value):
  tag u8, then payload:
    0 None | 1 True | 2 False
    3 int (zigzag varint) | 4 float64 (8B LE)
    5 str (varint len + utf8) | 6 bytes (varint len)
    7 list (varint count + values) | 8 dict (varint count + key/value pairs)
    9 f32 array (varint count + raw LE floats)   -- vectors
    10 typed ndarray (dtype u8, ndim u8, varint dims..., raw LE bytes)
       -- columnar snapshots / WAL batch frames: a 10M-row int64 column is
       one memcpy, not 10M boxed Python ints (the round-4 scale soak spent
       most of its 43 s clean-open decoding exactly that)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .bf16 import BFLOAT16, BF16Array, is_bf16

# tag-10 dtype codes (FROZEN wire values; native/tostore_native.cpp mirrors)
_DTYPE_CODES = {
    np.dtype(np.bool_): 0,
    np.dtype(np.int8): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int16): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.int64): 5,
    np.dtype(np.float32): 6,
    np.dtype(np.float64): 7,
    BFLOAT16: 8,  # bits ride in a BF16Array (utils/bf16.py); no numpy dtype
    np.dtype(np.uint16): 9,
    np.dtype(np.uint32): 10,
    np.dtype(np.uint64): 11,
    np.dtype(np.float16): 12,
}
_CODE_DTYPES = {c: dt for dt, c in _DTYPE_CODES.items()}


def _write_varint(buf: bytearray, n: int):
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(mv: memoryview, pos: int) -> tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = mv[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out, pos
        shift += 7


def _enc_int(buf: bytearray, n: int):
    u = (n << 1) if n >= 0 else ((-n << 1) - 1)  # zigzag
    _write_varint(buf, u)


def _dec_int(u: int) -> int:
    return (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)


def encode_value(v, buf: bytearray | None = None) -> bytearray:
    if buf is None:
        buf = bytearray()
    if v is None:
        buf.append(0)
    elif v is True:
        buf.append(1)
    elif v is False:
        buf.append(2)
    elif isinstance(v, int):
        buf.append(3)
        _enc_int(buf, v)
    elif isinstance(v, float):
        buf.append(4)
        buf += struct.pack("<d", v)
    elif isinstance(v, str):
        raw = v.encode()
        buf.append(5)
        _write_varint(buf, len(raw))
        buf += raw
    elif isinstance(v, (bytes, bytearray)):
        buf.append(6)
        _write_varint(buf, len(v))
        buf += v
    elif isinstance(v, np.ndarray) and v.dtype == np.float32 and v.ndim == 1:
        buf.append(9)
        _write_varint(buf, v.shape[0])
        buf += v.astype("<f4").tobytes()
    elif isinstance(v, np.ndarray) and v.ndim == 0:
        encode_value(v.item(), buf)  # 0-d array -> plain scalar
    elif is_bf16(v):
        _bf16_header(v, buf)
        buf += _bf16_bits(v).tobytes()
    elif isinstance(v, np.ndarray) and v.dtype in _DTYPE_CODES and v.ndim <= 255:
        a = np.ascontiguousarray(v)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        buf.append(10)
        buf.append(_DTYPE_CODES[v.dtype])
        buf.append(a.ndim)
        for s in a.shape:
            _write_varint(buf, s)
        buf += a.tobytes()
    elif isinstance(v, (list, tuple, np.ndarray)):
        if isinstance(v, np.ndarray):
            v = v.tolist()
        buf.append(7)
        _write_varint(buf, len(v))
        for x in v:
            encode_value(x, buf)
    elif isinstance(v, dict):
        buf.append(8)
        _write_varint(buf, len(v))
        for k, x in v.items():
            encode_value(str(k), buf)
            encode_value(x, buf)
    elif isinstance(v, (np.integer,)):
        encode_value(int(v), buf)
    elif isinstance(v, (np.floating,)):
        encode_value(float(v), buf)
    elif isinstance(v, np.bool_):
        encode_value(bool(v), buf)
    else:
        raise TypeError(f"cannot encode {type(v)}")
    return buf


def decode_value(mv: memoryview, pos: int = 0):
    tag = mv[pos]
    pos += 1
    if tag == 0:
        return None, pos
    if tag == 1:
        return True, pos
    if tag == 2:
        return False, pos
    if tag == 3:
        u, pos = _read_varint(mv, pos)
        return _dec_int(u), pos
    if tag == 4:
        return struct.unpack_from("<d", mv, pos)[0], pos + 8
    if tag == 5:
        n, pos = _read_varint(mv, pos)
        return bytes(mv[pos : pos + n]).decode(), pos + n
    if tag == 6:
        n, pos = _read_varint(mv, pos)
        return bytes(mv[pos : pos + n]), pos + n
    if tag == 7:
        n, pos = _read_varint(mv, pos)
        out = []
        for _ in range(n):
            x, pos = decode_value(mv, pos)
            out.append(x)
        return out, pos
    if tag == 8:
        n, pos = _read_varint(mv, pos)
        out = {}
        for _ in range(n):
            k, pos = decode_value(mv, pos)
            x, pos = decode_value(mv, pos)
            out[k] = x
        return out, pos
    if tag == 9:
        n, pos = _read_varint(mv, pos)
        arr = np.frombuffer(mv[pos : pos + 4 * n], dtype="<f4").copy()
        return arr, pos + 4 * n
    if tag == 10:
        dt = _CODE_DTYPES.get(mv[pos])
        bf16 = dt is BFLOAT16
        if bf16:
            dt = np.dtype("<u2")
        if dt is None:
            raise ValueError(f"bad ndarray dtype code {mv[pos]} at {pos}")
        ndim = mv[pos + 1]
        pos += 2
        shape = []
        for _ in range(ndim):
            s, pos = _read_varint(mv, pos)
            shape.append(s)
        count = 1
        for s in shape:
            count *= s
        nbytes = dt.itemsize * count
        if pos + nbytes > len(mv):
            raise ValueError("truncated ndarray payload")
        # .copy(): decoded arrays are writable and own their memory (column
        # loads mutate them in place; exactly one copy from the file bytes)
        arr = np.frombuffer(mv[pos : pos + nbytes], dtype=dt).reshape(shape).copy()
        return (BF16Array(arr) if bf16 else arr), pos + nbytes
    raise ValueError(f"bad tag {tag} at {pos - 1}")


def _bf16_bits(v) -> np.ndarray:
    """The little-endian uint16 bits of a bfloat16 array of either kind."""
    return np.ascontiguousarray(v.view(np.uint16)).astype("<u2", copy=False)


def _bf16_header(v, buf: bytearray):
    buf.append(10)
    buf.append(_DTYPE_CODES[BFLOAT16])
    buf.append(v.ndim)
    for s in v.shape:
        _write_varint(buf, s)


def _py_dumps(v) -> bytes:
    return bytes(encode_value(v))


def _py_loads(b: bytes):
    v, _ = decode_value(memoryview(b), 0)
    return v


def dumps(v) -> bytes:
    native = _native()
    if native is not None:
        try:
            return native.dumps(v)
        except (TypeError, OverflowError):
            pass  # exotic value (e.g. big int): pure-Python handles it
    return _py_dumps(v)


# streamed parts: ndarray payloads at least this big ride as zero-copy views
_STREAM_BIG = 1 << 20
# flush the glue buffer to the consumer at this size
_STREAM_CHUNK = 8 << 20


def dump_parts(v):
    """Yield buffers whose concatenation is byte-identical to dumps(v).

    Why: a multi-GB snapshot through dumps() materializes the whole
    payload at least twice (encode buffer + frame copy) — on hosts with
    ~180 us page faults (ROUND_NOTES "Environment facts") every redundant
    pass over a checkpoint-sized buffer costs seconds, and the transient
    doubles peak RSS at the 10M-row soak. Here big contiguous ndarrays
    (>= 1 MB) are yielded as zero-copy memoryviews of their own memory
    and everything else accumulates into small glue buffers, so a
    streaming writer (Storage.write_atomic_framed) can put a snapshot on
    disk with O(chunk) extra memory. Containers recurse; leaf values
    reuse encode_value, which keeps the wire format defined in exactly
    one place."""
    buf = bytearray()
    yield from _enc_parts(v, buf)
    if buf:
        yield bytes(buf)


def _enc_parts(v, buf: bytearray):
    if (
        isinstance(v, np.ndarray)
        and v.ndim == 1
        and v.dtype == np.float32
        and v.nbytes >= _STREAM_BIG
    ):
        # tag 9 (legacy f32-vector fast path) — mirror encode_value's order
        buf.append(9)
        _write_varint(buf, v.shape[0])
        yield bytes(buf)
        buf.clear()
        a = np.ascontiguousarray(v.astype("<f4", copy=False))
        yield memoryview(a).cast("B")
    elif is_bf16(v) and v.ndim >= 1 and v.nbytes >= _STREAM_BIG:
        # bfloat16 has no buffer export; its uint16 bits share the bytes
        _bf16_header(v, buf)
        yield bytes(buf)
        buf.clear()
        yield memoryview(_bf16_bits(v)).cast("B")
    elif (
        isinstance(v, np.ndarray)
        and 1 <= v.ndim <= 255
        and v.dtype in _DTYPE_CODES
        and v.nbytes >= _STREAM_BIG
    ):
        a = np.ascontiguousarray(v)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        buf.append(10)
        buf.append(_DTYPE_CODES[v.dtype])
        buf.append(a.ndim)
        for s in a.shape:
            _write_varint(buf, s)
        yield bytes(buf)
        buf.clear()
        yield memoryview(a).cast("B")
    elif isinstance(v, dict):
        buf.append(8)
        _write_varint(buf, len(v))
        for k, x in v.items():
            encode_value(str(k), buf)
            yield from _enc_parts(x, buf)
            if len(buf) >= _STREAM_CHUNK:
                yield bytes(buf)
                buf.clear()
    elif isinstance(v, (list, tuple)) or (
        isinstance(v, np.ndarray) and v.dtype == object
    ):
        if isinstance(v, np.ndarray):
            v = v.tolist()
        buf.append(7)
        _write_varint(buf, len(v))
        for x in v:
            # leaf-encode small elements; recurse so a big array nested in
            # a list still streams (element format is context-free)
            if isinstance(x, (dict, list, tuple, np.ndarray)):
                yield from _enc_parts(x, buf)
            else:
                encode_value(x, buf)
            if len(buf) >= _STREAM_CHUNK:
                yield bytes(buf)
                buf.clear()
    else:
        encode_value(v, buf)


def loads(b: bytes):
    native = _native()
    if native is not None:
        try:
            return native.loads(b)
        except ValueError:
            pass  # e.g. >64-bit varint: the pure decoder handles it
    return _py_loads(b)


_native_mod = False


def _native():
    global _native_mod
    if _native_mod is False:
        from ..native import get

        _native_mod = get()
    return _native_mod


# --- CRC-framed records (WAL entries / snapshot sections) --------------------
# Frame: [magic u8 = 0xA7][len u32 LE][crc32 u32 LE][payload]

FRAME_MAGIC = 0xA7
FRAME_HEADER = struct.Struct("<BII")


def frame(payload: bytes) -> bytes:
    return FRAME_HEADER.pack(FRAME_MAGIC, len(payload), zlib.crc32(payload)) + payload


def iter_frames(data: bytes):
    """Yield payloads as MEMORYVIEW slices of `data` (zero-copy — on hosts
    with slow page faults a redundant copy of a multi-hundred-MB snapshot
    frame costs whole seconds); stops cleanly at the first torn/corrupt
    frame (crash-recovery semantics: a partial tail write is discarded,
    reference WAL recover wal_manager.dart:608). Callers needing bytes
    wrap with bytes(); loads() accepts the view directly."""
    mv = memoryview(data)
    pos = 0
    n = len(data)
    while pos + FRAME_HEADER.size <= n:
        magic, ln, crc = FRAME_HEADER.unpack_from(mv, pos)
        if magic != FRAME_MAGIC or pos + FRAME_HEADER.size + ln > n:
            return
        payload = mv[pos + FRAME_HEADER.size : pos + FRAME_HEADER.size + ln]
        if zlib.crc32(payload) != crc:
            return
        yield payload
        pos += FRAME_HEADER.size + ln
