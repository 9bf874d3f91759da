"""Storage seam — pluggable byte I/O under the durability layer.

The TPU-native equivalent of the reference's `StorageInterface`
(storage_interface.dart:22-159: readAsBytesAt / writeManyAsBytesAt /
flushAll / replaceFileAtomic with file, web and memory backends): every
byte the engine persists (manifest, table snapshots, WAL segments,
backup enumeration) flows through a `Storage` implementation, so an
object store (GCS — the natural TPU-pod checkpoint target) or any other
backend can be plugged in without touching wal.py/database.py.

Differences from the reference are deliberate: no page-granular
readAsBytesAt/writeManyAsBytesAt (the engine snapshots whole tables and
streams WAL frames — there are no 16 KB pages to patch in place), and
`write_atomic` IS the commit point (the reference needs replaceFileAtomic
plus journal machinery because it mutates pages in place).

Backends:
- FileStorage: POSIX files, fsync-honest — the default for file mode.
- MemoryStorage: a path->bytes dict with the same atomic/append/list
  semantics; reopening an engine on the SAME MemoryStorage instance
  recovers state, which is how tests prove the seam end-to-end.
- ObjectStorage: maps the layout onto a flat key/value object client
  (put/get/delete/list_keys) with no appender requirement — WAL appends
  are staged locally and each fsync uploads the full segment object
  (object stores have no append). The default client is in-memory; a
  GCS/S3 client only needs the same four methods.
"""

from __future__ import annotations

import glob as _glob
import os
import posixpath
import threading


def _norm(path: str) -> str:
    return posixpath.normpath(path.replace(os.sep, "/"))


class Storage:
    """Abstract byte store. Paths are plain strings (the engine builds
    them with os.path.join); backends normalize internally."""

    def read(self, path: str) -> bytes:
        raise FileNotFoundError(path)

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def write_atomic(self, path: str, data: bytes) -> None:
        """Full-file replace; the durability commit point (reference
        replaceFileAtomic, storage_interface.dart:94)."""
        raise NotImplementedError

    def write_atomic_framed(self, path: str, parts) -> None:
        """Atomically write one CRC frame whose payload is the
        concatenation of `parts` (an iterable of buffers, e.g.
        codec.dump_parts). Equivalent to
        write_atomic(path, codec.frame(b"".join(parts))) — backends that
        can stream (FileStorage) override this to avoid materializing a
        checkpoint-sized payload; this default keeps object/memory
        backends trivially correct."""
        from ..utils import codec

        self.write_atomic(path, codec.frame(b"".join(parts)))

    def appender(self, path: str):
        """Open `path` for create-or-append streaming (WAL segments)."""
        raise NotImplementedError

    def list(self, dir_path: str) -> list[str]:
        """File names directly inside dir_path (no dirs, non-recursive)."""
        raise NotImplementedError

    def walk(self, dir_path: str) -> list[str]:
        """All file paths under dir_path, relative to it, recursive."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        """Remove a file; missing paths are a no-op."""
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError


class _FileAppender:
    __slots__ = ("_f",)

    def __init__(self, path: str):
        self._f = open(path, "ab")

    def write(self, data: bytes):
        self._f.write(data)

    def flush(self):
        self._f.flush()

    def fsync(self):
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self):
        try:
            self._f.flush()
        except ValueError:
            pass
        self._f.close()


def _fsync_dir(path: str) -> None:
    """Persist a rename/create in its parent directory: fsyncing the file
    alone does not make the DIRECTORY ENTRY durable, so a crash right
    after os.replace could lose the whole replace."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # non-POSIX dir semantics: best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class FileStorage(Storage):
    """POSIX files — today's semantics, fsync included."""

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def write_atomic(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(path)

    def write_atomic_framed(self, path: str, parts) -> None:
        """True streaming: write a placeholder frame header, stream the
        payload parts while accumulating length + CRC, then seek back and
        patch the real header before the atomic replace. The file bytes
        are identical to write_atomic(path, codec.frame(payload)) but
        peak memory is O(one part), not O(snapshot) — at the 10M-row
        soak the join-then-frame path held two extra copies of a ~GB
        checkpoint in RAM."""
        import zlib

        from ..utils import codec

        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(codec.FRAME_HEADER.pack(codec.FRAME_MAGIC, 0, 0))
            n = 0
            crc = 0
            for p in parts:
                f.write(p)
                n += len(memoryview(p))
                crc = zlib.crc32(p, crc)
            f.seek(0)
            f.write(codec.FRAME_HEADER.pack(codec.FRAME_MAGIC, n, crc))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(path)

    def appender(self, path: str) -> _FileAppender:
        created = not os.path.exists(path)
        ap = _FileAppender(path)
        if created:
            _fsync_dir(path)  # make the new segment's dir entry durable
        return ap

    def list(self, dir_path: str) -> list[str]:
        if not os.path.isdir(dir_path):
            return []
        return sorted(
            n for n in os.listdir(dir_path)
            if os.path.isfile(os.path.join(dir_path, n))
        )

    def walk(self, dir_path: str) -> list[str]:
        out = []
        for p in _glob.glob(os.path.join(dir_path, "**"), recursive=True):
            if os.path.isfile(p):
                out.append(os.path.relpath(p, dir_path))
        return sorted(out)

    def delete(self, path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)


class _MemoryAppender:
    __slots__ = ("_store", "_key")

    def __init__(self, store: "MemoryStorage", key: str):
        self._store = store
        self._key = key
        with store._lock:
            store._files.setdefault(key, bytearray())

    def write(self, data: bytes):
        with self._store._lock:
            self._store._files[self._key].extend(data)

    def flush(self):
        pass

    def fsync(self):
        pass

    def close(self):
        pass


class MemoryStorage(Storage):
    """Path->bytes dict with file-backend semantics. An engine reopened
    on the SAME instance recovers its state — RAM-durable, which is what
    lets the whole checkpoint/WAL/recovery machinery be exercised without
    a filesystem (the reference's in-memory StorageInterface backend)."""

    def __init__(self):
        self._files: dict[str, bytearray] = {}
        self._lock = threading.RLock()

    def read(self, path: str) -> bytes:
        with self._lock:
            b = self._files.get(_norm(path))
            if b is None:
                raise FileNotFoundError(path)
            return bytes(b)

    def exists(self, path: str) -> bool:
        with self._lock:
            return _norm(path) in self._files

    def write_atomic(self, path: str, data: bytes) -> None:
        with self._lock:
            self._files[_norm(path)] = bytearray(data)

    def appender(self, path: str) -> _MemoryAppender:
        return _MemoryAppender(self, _norm(path))

    def list(self, dir_path: str) -> list[str]:
        d = _norm(dir_path) + "/"
        with self._lock:
            return sorted(
                k[len(d):] for k in self._files
                if k.startswith(d) and "/" not in k[len(d):]
            )

    def walk(self, dir_path: str) -> list[str]:
        d = _norm(dir_path) + "/"
        with self._lock:
            return sorted(k[len(d):] for k in self._files if k.startswith(d))

    def delete(self, path: str) -> None:
        with self._lock:
            self._files.pop(_norm(path), None)

    def makedirs(self, path: str) -> None:
        pass  # directories are implicit


class InMemoryObjectClient:
    """The minimal object-store client surface ObjectStorage needs. A
    real GCS/S3 adapter implements these four methods over its SDK."""

    def __init__(self):
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)

    def get(self, key: str) -> bytes | None:
        with self._lock:
            return self._objects.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)

    def list_keys(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))


class _ObjectAppender:
    """Object stores can't append: stage locally, upload whole-object on
    fsync/close. The WAL's group-commit framing means each fsync is a
    consistent prefix, so a crash loses at most the unuploaded tail —
    the same contract as the 'interval' fsync policy on files."""

    __slots__ = ("_client", "_key", "_buf")

    def __init__(self, client, key: str, existing: bytes):
        self._client = client
        self._key = key
        self._buf = bytearray(existing)

    def write(self, data: bytes):
        self._buf.extend(data)

    def flush(self):
        pass

    def fsync(self):
        self._client.put(self._key, bytes(self._buf))

    def close(self):
        self.fsync()


class ObjectStorage(Storage):
    """Maps the database layout onto flat object keys (path -> key).
    Proves the seam: the engine runs unmodified over any client with
    put/get/delete/list_keys — swap InMemoryObjectClient for a GCS
    adapter to checkpoint a TPU-pod database into a bucket."""

    def __init__(self, client=None, prefix: str = ""):
        self.client = client or InMemoryObjectClient()
        self.prefix = prefix

    def _key(self, path: str) -> str:
        return self.prefix + _norm(path).lstrip("/")

    def read(self, path: str) -> bytes:
        b = self.client.get(self._key(path))
        if b is None:
            raise FileNotFoundError(path)
        return b

    def exists(self, path: str) -> bool:
        return self.client.get(self._key(path)) is not None

    def write_atomic(self, path: str, data: bytes) -> None:
        self.client.put(self._key(path), data)  # object puts are atomic

    def appender(self, path: str) -> _ObjectAppender:
        key = self._key(path)
        return _ObjectAppender(self.client, key, self.client.get(key) or b"")

    def list(self, dir_path: str) -> list[str]:
        d = self._key(dir_path) + "/"
        return sorted(
            k[len(d):] for k in self.client.list_keys(d)
            if "/" not in k[len(d):]
        )

    def walk(self, dir_path: str) -> list[str]:
        d = self._key(dir_path) + "/"
        return sorted(k[len(d):] for k in self.client.list_keys(d))

    def delete(self, path: str) -> None:
        self.client.delete(self._key(path))

    def makedirs(self, path: str) -> None:
        pass


FILE = FileStorage()  # module default: call sites that predate the seam
