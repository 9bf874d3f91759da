"""A database written by one package opens in the other.

File databases written through `tostore_tpu.ToStoreTPU` (JAX on the CPU)
reopen through `tostore_tpu_torch.ToStoreTPU(device="cpu")` and the
reverse, each with a checkpoint AND a WAL tail behind a hard drop of the
handle: flat bf16 and int8 tables and an IVF-PQ table, once with
compression and encryption on. The searches made by the writer just
before the drop must come back from the reader: the same primary keys in
the same order, distances within rtol 1e-4 / atol 1e-4 (the bound of
tests/test_torch_engine.py: f32 sums in another order). The IVF-PQ table
needs no exhaustive probe here: the reader restores the writer's
centroids and codebooks, so both rank the same candidates.

Then the carried leaves, byte for byte: `codec` output for every tag
(bfloat16's dtype code 8 with `ml_dtypes` blocked on the port's side),
`memcomparable` keys, a `crypto` envelope sealed by one and opened by the
other, a WAL segment written by one and replayed by the other.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import tostore_tpu as R
import tostore_tpu_torch as T
from tostore_tpu.engine import wal as r_wal
from tostore_tpu.utils import codec as r_codec
from tostore_tpu.utils import compress as r_compress
from tostore_tpu.utils import crypto as r_crypto
from tostore_tpu.utils import memcomparable as r_mc
from tostore_tpu_torch.engine import wal as t_wal
from tostore_tpu_torch.utils import codec as t_codec
from tostore_tpu_torch.utils import compress as t_compress
from tostore_tpu_torch.utils import crypto as t_crypto
from tostore_tpu_torch.utils import memcomparable as t_mc
from tostore_tpu_torch.utils.bf16 import BF16Array

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-4
PACKAGES = {"reference": (R, {}), "port": (T, {"device": "cpu"})}
DIRECTIONS = [("reference", "port"), ("port", "reference")]


def _schemas(p, d):
    def table(name, prec, **index):
        return p.TableSchema(
            name=name,
            fields=(p.FieldSchema("price", p.DataType.double),
                    p.FieldSchema("title", p.DataType.text),
                    p.FieldSchema("emb", p.DataType.vector, vector_config=p.VectorFieldConfig(
                        dimensions=d, precision=prec))),
            indexes=(p.IndexSchema(fields=("emb",), type="vector",
                                   vector_config=p.VectorIndexConfig(metric="l2", **index)),),
        )

    return [table("bf16", "bfloat16", index_type="flat"),
            table("int8", "int8", index_type="flat"),
            table("pq", "bfloat16", index_type="ivf", num_clusters=8, nprobe=4, pq_subspaces=8)]


TABLES = ("bf16", "int8", "pq")


def _searches(db, x, n):
    qc = (R if type(db).__module__.split(".")[0] == "tostore_tpu" else T).QueryCondition
    out = {}
    for t in TABLES:
        for i in (3, n - 5, n + 7):  # a checkpointed row, a deleted one's neighbour, a tail row
            hs = db.vector_search(t, "emb", x[i] + np.float32(0.05), top_k=5)
            out[t, i] = ([h.primary_key for h in hs], [h.distance for h in hs])
        hs = db.vector_search(t, "emb", x[10] + np.float32(0.05), top_k=4,
                              condition=qc().where("price", ">=", 40.0))
        out[t, "filtered"] = ([h.primary_key for h in hs], [h.distance for h in hs])
    out["rows"] = [db.count(t) for t in TABLES]
    out["record"] = {k: v for k, v in db.get_by_pk("bf16", 4).items() if k != "emb"}
    out["kv"] = db.kv.get("k")
    return out


def _write(p, kw, path, x, n, **cfg):
    """Checkpoint at n rows, then a WAL tail (rows, an update, deletes, a kv
    value), the searches, and a hard drop: no close(), no second checkpoint."""
    d = x.shape[1]
    db = p.ToStoreTPU.open(path, schemas=_schemas(p, d), **kw, **cfg)
    recs = [{"price": float(i % 90), "title": f"t{i}", "emb": x[i]} for i in range(len(x))]
    for t in TABLES:
        assert db.batch_insert(t, recs[:n]).is_success
        db.vector_search(t, "emb", x[0], top_k=1)  # flush the staged vectors
    assert db.engine.run_vector_maintenance() == 1  # trains the IVF-PQ table
    db.flush()
    for t in TABLES:
        assert db.batch_insert(t, recs[n:]).is_success
        db.update_by_pk(t, 2, {"price": 77.0, "emb": x[1] * np.float32(1.5)})
        db.delete_by_pk(t, n - 4)
    db.kv.set("k", {"v": [1, "two", 3.0]})
    want = _searches(db, x, n)
    db.engine._wal.close()
    db.engine._crontab.stop()
    return want


def _read(p, kw, path, x, n, **cfg):
    db = p.ToStoreTPU.open(path, **kw, **cfg)
    try:
        assert db.engine._counters["recovered_wal_entries"] > 0
        vi = db.engine._table("pq").vector_indexes["emb"]
        assert type(vi).__module__.startswith(p.__name__) and vi.trained and vi.pq is not None
        assert str(db.engine._table("bf16").vector_indexes["emb"].corpus.vectors.dtype
                   ).endswith("bfloat16")
        return _searches(db, x, n)
    finally:
        db.close()


def _assert_same(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(key, tuple):
            assert got[key][0] == want[key][0], (key, got[key], want[key])
            assert len(want[key][0]) > 0
            assert np.allclose(got[key][1], want[key][1], rtol=RTOL, atol=ATOL), key
        else:
            assert got[key] == want[key], key


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(21).standard_normal((760, 32)).astype(np.float32)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_cross_open_checkpoint_and_wal_tail(tmp_path, rows, writer, reader):
    n = 700
    want = _write(*PACKAGES[writer], str(tmp_path), rows, n)
    # the bf16 corpus is on disk as bfloat16 (dtype code 8), 2 bytes a value,
    # whichever package wrote it; both codecs read it
    raw = (tmp_path / "default" / "tables" / "default@bf16.snap").read_bytes()
    for codec in (r_codec, t_codec):
        state = codec.loads(next(iter(codec.iter_frames(raw))))
        vecs = state["vector_indexes"]["emb"]["corpus"]["vectors"]
        assert vecs.dtype.name == "bfloat16" and vecs.shape == (n, 128)
    assert len(raw) < n * (32 * 4 + 128 * 2 + 64)  # f32 rows would add 128 x 2 more
    _assert_same(_read(*PACKAGES[reader], str(tmp_path), rows, n), want)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_cross_open_after_readers_checkpoint(tmp_path, rows, writer, reader):
    """The reader's close() checkpoints in its own format; the writer's
    package must open that too (a round trip through both)."""
    n = 700
    want = _write(*PACKAGES[writer], str(tmp_path), rows, n)
    p, kw = PACKAGES[reader]
    db = p.ToStoreTPU.open(str(tmp_path), **kw)
    db.flush()
    db.close()
    p, kw = PACKAGES[writer]
    db = p.ToStoreTPU.open(str(tmp_path), **kw)
    try:
        _assert_same(_searches(db, rows, n), want)
    finally:
        db.close()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_cross_open_compressed_and_encrypted(tmp_path, writer, reader):
    x = np.random.default_rng(22).standard_normal((330, 16)).astype(np.float32)

    def cfg(p):
        return {"enable_compression": True, "encryption": p.EncryptionConfig(
            enable_encoding=True, encryption_key="s3cret")}

    pw, kww = PACKAGES[writer]
    pr, kwr = PACKAGES[reader]
    want = _write(pw, kww, str(tmp_path), x, 300, **cfg(pw))
    raw = (tmp_path / "default" / "tables" / "default@bf16.snap").read_bytes()
    assert b"t17" not in raw  # sealed: no plain text in the snapshot
    _assert_same(_read(pr, kwr, str(tmp_path), x, 300, **cfg(pr)), want)
    with pytest.raises(Exception):
        pr.ToStoreTPU.open(str(tmp_path), **kwr, encryption=pr.EncryptionConfig(
            enable_encoding=True, encryption_key="wrong")).get_by_pk("bf16", 4)


# --- the carried leaves, byte for byte ------------------------------------------

_BF16_BITS = np.random.default_rng(23).integers(0, 1 << 16, (5, 7)).astype(np.uint16)
_BIG_BITS = np.random.default_rng(24).integers(0, 1 << 16, (1200, 512)).astype(np.uint16)


def _values(bf16):
    """One value per wire tag and dtype code; `bf16` wraps uint16 bits as
    the package's own bfloat16 array."""
    rng = np.random.default_rng(25)
    arrays = {
        "bool": rng.random(9) > 0.5, "int8": rng.integers(-128, 127, 9).astype(np.int8),
        "uint8": rng.integers(0, 255, 9).astype(np.uint8),
        "int16": rng.integers(-9, 9, (3, 3)).astype(np.int16),
        "int32": rng.integers(-9, 9, 9).astype(np.int32),
        "int64": rng.integers(-(1 << 40), 1 << 40, 9),
        "float32_2d": rng.standard_normal((3, 4)).astype(np.float32),
        "float64": rng.standard_normal(5), "uint16": _BF16_BITS.copy(),
        "uint32": rng.integers(0, 9, 4).astype(np.uint32),
        "uint64": rng.integers(0, 9, 4).astype(np.uint64),
        "float16": rng.standard_normal(6).astype(np.float16),
        "big_endian": rng.standard_normal(4).astype(">f8"),
    }
    return {
        "none": None, "true": True, "false": False, "int": -123456789, "big_int": 1 << 70,
        "float": 3.25, "str": "héllo", "bytes": b"\x00\x01\xff", "list": [1, "a", None, [2.5]],
        "dict": {"a": 1, "b": {"c": [True, b"x"]}}, "f32_vector": rng.standard_normal(8).astype(
            np.float32), "zero_d": np.float32(1.5) * np.ones(()), "np_int": np.int64(7),
        "np_float": np.float64(0.5),
        **arrays,
        "bfloat16": bf16(_BF16_BITS), "bfloat16_big": bf16(_BIG_BITS),
        "bfloat16_nested": {"corpus": {"vectors": bf16(_BF16_BITS), "pks": [1, 2, 3]}},
    }


def _ref_bf16(bits):
    return bits.view(ml_dtypes.bfloat16)


REF_VALUES = _values(_ref_bf16)
PORT_VALUES = _values(BF16Array)


@pytest.mark.parametrize("name", sorted(REF_VALUES))
def test_codec_bytes_equal(name):
    want = r_codec._py_dumps(REF_VALUES[name])
    assert r_codec.dumps(REF_VALUES[name]) == want  # the reference's native form agrees
    for got in (t_codec._py_dumps(PORT_VALUES[name]), t_codec.dumps(PORT_VALUES[name]),
                b"".join(bytes(p) for p in t_codec.dump_parts(PORT_VALUES[name])),
                # the port also writes an ml_dtypes array it was handed (its native
                # helper returns them where ml_dtypes is installed)
                t_codec.dumps(REF_VALUES[name])):
        assert got == want


def _bits(a):
    return np.asarray(a.view(np.uint16))


def _same_value(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_value(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    if getattr(getattr(a, "dtype", None), "name", "") == "bfloat16":
        return b.dtype.name == "bfloat16" and a.shape == b.shape and (_bits(a) == _bits(b)).all()
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape \
            and (a == b).all()
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(REF_VALUES))
def test_codec_decodes_the_other_packages_bytes(name):
    blob = r_codec.dumps(REF_VALUES[name])
    want = r_codec.loads(blob)
    for got in (t_codec.loads(blob), t_codec._py_loads(blob)):
        assert _same_value(want, got) and _same_value(got, want), (want, got)
    if "bfloat16" in name:  # the pure-Python decoder gives the port's own array
        leaf = t_codec._py_loads(blob)
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        assert isinstance(leaf, BF16Array)
    assert _same_value(r_codec.loads(t_codec.dumps(PORT_VALUES[name])), want)


def test_codec_frames_equal():
    payload = t_codec.dumps(PORT_VALUES["dict"])
    assert t_codec.frame(payload) == r_codec.frame(payload)
    blob = r_codec.frame(payload) + r_codec.frame(b"second") + b"\xa7torn"
    assert [bytes(p) for p in t_codec.iter_frames(blob)] == [payload, b"second"]


def test_bf16_array_holds_the_bits():
    x = np.random.default_rng(26).standard_normal(4096).astype(np.float32) * 100
    want = torch.from_numpy(x).to(torch.bfloat16)
    got = BF16Array(want.view(torch.int16).numpy())
    assert (np.asarray(got) == want.float().numpy()).all()  # widening is exact
    assert np.asarray(got, np.float64).dtype == np.float64
    assert got[5:9].shape == (4,) and got.dtype.name == "bfloat16" and len(got) == 4096
    assert got[7] == want[7].item() and got.nbytes == 8192 and got.ndim == 1
    with pytest.raises(TypeError):
        BF16Array(x)


def test_tag8_without_ml_dtypes():
    """With ml_dtypes blocked (the GPU machine has none) the port writes a
    bf16 array as dtype code 8, 2 bytes a value, and reads it back, through
    its native helper's route and through the pure-Python one."""
    script = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "tostore_tpu", "ml_dtypes"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import numpy as np
        from tostore_tpu_torch.utils import codec
        from tostore_tpu_torch.utils.bf16 import BF16Array
        bits = np.arange(24, dtype=np.uint16).reshape(4, 6) * 1000
        for dumps in (codec.dumps, codec._py_dumps):
            blob = dumps({"v": BF16Array(bits), "n": [1, 2]})
            sys.stdout.write(blob.hex() + "\\n")
            for loads in (codec.loads, codec._py_loads):
                back = loads(blob)
                assert isinstance(back["v"], BF16Array) and (back["v"].bits == bits).all()
        assert "ml_dtypes" not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    bits = np.arange(24, dtype=np.uint16).reshape(4, 6) * 1000
    want = r_codec.dumps({"v": bits.view(ml_dtypes.bfloat16), "n": [1, 2]})
    assert proc.stdout.split() == [want.hex(), want.hex()]
    assert len(want) < 24 * 2 + 24  # 2 bytes a value


_KEYS = [None, True, False, 0, -1, 1 << 40, -(1 << 40), 1.5, -2.25, float("inf"), "", "abc",
         "ab\x00c", b"\x00\xff", "ü"]


@pytest.mark.parametrize("i", range(len(_KEYS)))
def test_memcomparable_keys_equal(i):
    v = _KEYS[i]
    assert t_mc.encode_value(v) == r_mc.encode_value(v)
    tup = (v, "x", 3)
    key = t_mc.encode_tuple(tup)
    assert key == r_mc.encode_tuple(tup)
    assert t_mc.decode_tuple(key) == r_mc.decode_tuple(key)
    assert t_mc.prefix_upper_bound(key) == r_mc.prefix_upper_bound(key)


def test_memcomparable_order_equal():
    for kind in (int, float, str):  # keys order within a type
        keys = [v for v in _KEYS if type(v) is kind]
        enc = sorted(keys, key=t_mc.encode_value)
        assert enc == sorted(keys, key=r_mc.encode_value) == sorted(keys)


@pytest.mark.parametrize("sealer,opener", [(r_crypto, t_crypto), (t_crypto, r_crypto)])
def test_crypto_envelope_crosses(sealer, opener):
    salt = b"0123456789abcdef"
    blob = sealer.Envelope(sealer.KeyRing.from_passphrase("pw", 3, salt, 1000)).seal(
        b"secret rows", aad=b"snap")
    ring = opener.KeyRing.from_passphrase("pw", 3, salt, 1000)
    assert opener.Envelope.is_sealed(blob)
    assert opener.Envelope(ring).open(blob, aad=b"snap") == b"secret rows"
    with pytest.raises(Exception):
        opener.Envelope(opener.KeyRing.from_passphrase("no", 3, salt, 1000)).open(blob, b"snap")
    assert sealer.derive_key("pw", salt, 1000) == opener.derive_key("pw", salt, 1000)
    key, nonce = bytes(range(32)), bytes(12)
    assert sealer.chacha20poly1305_seal(key, nonce, b"abc", b"ad") == \
        opener.chacha20poly1305_seal(key, nonce, b"abc", b"ad")
    assert opener.ToCrypto("pw").decrypt_text(sealer.ToCrypto("pw").encrypt_text("héllo")) \
        == "héllo"


@pytest.mark.parametrize("a,b", [(r_compress, t_compress), (t_compress, r_compress)])
def test_compress_crosses(a, b):
    data = b"tostore " * 500
    blob = a.compress(data)
    assert blob == b.compress(data) and b.is_compressed(blob) and b.decompress(blob) == data


@pytest.mark.parametrize("writer,reader", [(r_wal, t_wal), (t_wal, r_wal)])
def test_wal_segment_crosses(tmp_path, writer, reader):
    entries = [
        {"op": "insert", "space": "default", "table": "t", "pk": 1,
         "rec": {"id": 1, "emb": np.arange(4, dtype=np.float32), "name": "a"}},
        {"op": "batch", "cols": {"id": np.arange(5), "v": np.arange(5, dtype=np.float64)}},
        {"op": "delete", "table": "t", "pk": 1},
    ]
    w = writer.SegmentedWalWriter(str(tmp_path), 1, sync_policy="commit")
    w.append(entries[0])
    w.append_many(entries[1:])
    w.close()
    with open(w.path, "ab") as f:
        f.write(b"\xa7\x10\x00\x00\x00torn")  # a torn tail is dropped by both
    got, errors = reader.read_wal_segments(str(tmp_path), 1)
    mine, my_errors = writer.read_wal_segments(str(tmp_path), 1)
    assert errors == my_errors and len(got) == len(mine) == 3
    assert all(_same_value(g, m) for g, m in zip(got, mine))
    assert (tmp_path / os.path.basename(w.path)).read_bytes().startswith(b"\xa7")
