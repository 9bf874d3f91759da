"""Compression for host artifacts — snapshots, WAL entries, backups
(reference core/data_compressor.dart: zlib levels). Self-describing: a
magic prefix + 1-byte algo tag, so legacy uncompressed artifacts pass
through decompress-detection untouched; level 0 = store."""

from __future__ import annotations

import zlib

MAGIC = b"TZ01"
TAG_STORE = 0
TAG_ZLIB = 1


def compress(data: bytes, level: int = 6) -> bytes:
    if level <= 0:
        return MAGIC + bytes([TAG_STORE]) + data
    return MAGIC + bytes([TAG_ZLIB]) + zlib.compress(data, level)


def is_compressed(blob: bytes) -> bool:
    return blob[: len(MAGIC)] == MAGIC


def decompress(blob: bytes) -> bytes:
    if not is_compressed(blob):
        raise ValueError("not a compressed artifact")
    tag = blob[len(MAGIC)]
    body = blob[len(MAGIC) + 1 :]
    if tag == TAG_STORE:
        return body
    if tag == TAG_ZLIB:
        return zlib.decompress(body)
    raise ValueError(f"unknown compression tag {tag}")
