"""Port parity for hybrid filtered search: tostore_tpu_torch.vector.filters
and tostore_tpu_torch.query.QueryCondition against tostore_tpu's.

The same seeded columns go into both packages' FilterColumns and the same
conditions through `compilable` and `device_mask`: the masks must be equal
bit for bit (the JAX side evaluates them in XLA on the CPU). Covered: every
operator of `_DEVICE_OPS` on float and int columns, None values, the int64
ends, epoch-millisecond timestamps 1 ms apart, non-integral and quoted
bounds, IN lists of 16 and 17 values, OR-only and mixed nodes. Then the
host snapshot helpers and condition maps both ways, and filtered
`search_arrays` on the flat and IVF indexes of both packages (mirroring
tests/test_engine.py::test_hybrid_device_mask_path at index level), with
the tolerances of tests/torch_parity.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tostore_tpu.query.condition import QueryCondition as JCond
from tostore_tpu.vector import FlatVectorIndex as JFlat
from tostore_tpu.vector import IVFVectorIndex as JIVF
from tostore_tpu.vector import filters as jfilters
from tostore_tpu_torch import FlatVectorIndex as TFlat
from tostore_tpu_torch import convert
from tostore_tpu_torch.query import QueryCondition as TCond
from tostore_tpu_torch.vector import filters as tfilters
from torch_parity import TOL, assert_topk_match

torch.set_num_threads(1)

I64_MIN, I64_MAX = -(2**63), 2**63 - 1
T0 = 1_700_000_000_000  # epoch ms
CAP = 320
N = 300  # slots written; CAP - N stay unwritten (NaN / null)


def _columns():
    """name -> (kind, values for slots 0..N-1), seeded."""
    rng = np.random.default_rng(11)
    price = [round(float(x), 3) for x in rng.random(N)]
    price[:6] = [None, 0.5, 0.25, 1.0, 0.1, 0.0]
    for i in rng.choice(np.arange(6, N), 20, replace=False):
        price[i] = None
    ts = [T0 + i for i in range(N)]  # 1 ms apart
    ends = [I64_MIN, I64_MIN + 1, I64_MAX - 1, I64_MAX, 0, -1, 2**32, 2**32 - 1, -(2**32),
            2**31, -(2**31) - 1, None, None]
    ts[: len(ends)] = ends
    for i in rng.choice(np.arange(len(ends), N), 15, replace=False):
        ts[i] = None
    cnt = [int(x) for x in rng.integers(-5, 6, N)]
    flag = [bool(x) for x in rng.integers(0, 2, N)]
    return {"price": ("float", price), "ts": ("int", ts), "cnt": ("int", cnt),
            "flag": ("float", flag)}


def _fill(fc, columns, slots=None):
    slots = np.arange(N) if slots is None else slots
    for name, (kind, vals) in columns.items():
        fc.update(name, slots, vals, CAP, kind=kind)


@pytest.fixture(scope="module")
def both():
    cols = _columns()
    jfc, tfc = jfilters.FilterColumns(), tfilters.FilterColumns("cpu")
    _fill(jfc, cols)
    _fill(tfc, cols)
    return jfc, tfc, cols


MID = T0 + 150
IN16 = [T0 + 3 * i for i in range(16)]
# (case id, field, op, value): single-clause conditions
LEAVES = [
    *[(f"price{op}", "price", op, 0.25) for op in ("=", "!=", ">", "<", ">=", "<=")],
    ("price=quoted", "price", "=", "0.5"),
    ("price>quoted", "price", ">", "0.125"),
    ("price<=int", "price", "<=", 1),
    ("price between", "price", "between", (0.1, 0.5)),
    ("price between quoted", "price", "between", ("0.2", 1)),
    ("price in", "price", "in", [0.5, 0.25, "1.0", 0]),
    ("price in 16", "price", "in", [i / 16 for i in range(16)]),
    ("price in 17", "price", "in", [i / 16 for i in range(17)]),
    ("price is null", "price", "is", None),
    ("price is not null", "price", "isNot", None),
    ("price is value", "price", "is", 0.5),
    ("price like", "price", "like", "0.%"),
    ("flag=true", "flag", "=", True),
    ("flag!=false", "flag", "!=", False),
    *[(f"ts{op}", "ts", op, MID) for op in ("=", "!=", ">", "<", ">=", "<=")],
    *[(f"ts{op}frac", "ts", op, MID + 0.5) for op in ("=", "!=", ">", "<", ">=", "<=")],
    *[(f"ts{op}quoted", "ts", op, str(MID)) for op in ("=", ">", "<=")],
    ("ts>quoted frac", "ts", ">", f"{MID}.25"),
    ("ts between 1ms", "ts", "between", (MID - 1, MID + 1)),
    ("ts between frac", "ts", "between", (MID - 2.5, MID + 1.5)),
    ("ts between quoted", "ts", "between", (str(MID), str(MID + 40))),
    ("ts=max", "ts", "=", I64_MAX),
    ("ts>max-1", "ts", ">", I64_MAX - 1),
    ("ts>=max", "ts", ">=", I64_MAX),
    ("ts<min+1", "ts", "<", I64_MIN + 1),
    ("ts<=min", "ts", "<=", I64_MIN),
    ("ts!=min", "ts", "!=", I64_MIN),
    ("ts>-1", "ts", ">", -1),
    ("ts<2^32", "ts", "<", 2**32),
    ("ts>=-2^31-1", "ts", ">=", -(2**31) - 1),
    ("ts in 16", "ts", "in", IN16),
    ("ts in 17", "ts", "in", IN16 + [MID]),
    ("ts in mixed", "ts", "in", [MID, "150", MID + 0.5, I64_MAX, -1]),
    ("ts is null", "ts", "is", None),
    ("ts is not null", "ts", "isNot", None),
    ("cnt<=true", "cnt", "<=", True),
    ("missing field", "nope", "=", 1),
]


def _build(QC, spec):
    """A condition tree from a nested spec: ("leaf", f, op, v) or
    ("node", [leaves], [and-children], [or-children])."""
    if spec[0] == "leaf":
        return QC().where(*spec[1:])
    _, leaves, ands, ors = spec
    c = QC()
    for f, op, v in leaves:
        c.where(f, op, v)
    for s in ands:
        c.and_(_build(QC, s))
    for s in ors:
        c.or_(_build(QC, s))
    return c


TREES = [
    ("empty", ("node", [], [], [])),
    ("and of leaves", ("node", [("price", ">", 0.2), ("ts", "<", MID)], [], [])),
    ("or only", ("node", [], [], [("leaf", "price", "<", 0.1), ("leaf", "ts", ">=", MID + 100)])),
    ("or only of one", ("node", [], [], [("leaf", "cnt", "=", 3)])),
    ("mixed", ("node", [("price", ">=", 0.5)],
               [("node", [("cnt", "!=", 0)], [], [])],
               [("leaf", "ts", "between", (MID, MID + 5)), ("leaf", "price", "is", None)])),
    ("nested or in and", ("node", [("ts", "isNot", None)],
                          [("node", [], [], [("leaf", "cnt", "<", -2),
                                             ("leaf", "cnt", ">", 2)])], [])),
    ("or of ands", ("node", [], [], [("node", [("price", "<", 0.3), ("cnt", ">=", 0)], [], []),
                                     ("node", [("ts", "in", IN16)], [], [])])),
    ("not compilable below", ("node", [("price", ">", 0.1)], [],
                              [("leaf", "price", "like", "%")])),
]


def _check(both, spec):
    jfc, tfc, _ = both
    jc, tc = _build(JCond, spec), _build(TCond, spec)
    ok = jfilters.compilable(jc, jfc.names())
    assert tfilters.compilable(tc, tfc.names()) == ok
    if not ok:
        return False
    for name in tc.referenced_fields():
        jfc.ensure(name, CAP)
        tfc.ensure(name, CAP)
    want = np.asarray(jfilters.device_mask(jc, jfc, CAP))
    got = tfilters.device_mask(tc, tfc, CAP)
    assert got.dtype == torch.bool and tuple(got.shape) == (CAP,)
    np.testing.assert_array_equal(got.numpy(), want)
    return True


@pytest.mark.parametrize("case", LEAVES, ids=[c[0] for c in LEAVES])
def test_leaf_mask_matches_reference(both, case):
    _, f, op, v = case
    compiled = _check(both, ("leaf", f, op, v))
    assert compiled == (case[0] not in ("price in 17", "ts in 17", "price is value",
                                        "price like", "missing field"))


@pytest.mark.parametrize("case", TREES, ids=[c[0] for c in TREES])
def test_tree_mask_matches_reference(both, case):
    assert _check(both, case[1]) == (case[0] != "not compilable below")


def test_close_timestamps_stay_distinct(both):
    # f32 could not tell these apart (~131 s resolution at 1.7e12 ms)
    _, tfc, _ = both
    for v in (MID, MID + 1):
        m = tfilters.device_mask(TCond().where("ts", "=", v), tfc, CAP)
        assert m.nonzero().flatten().tolist() == [150 + v - MID]


def _host_mask(cond, columns):
    arrs = {k: np.array(list(v) + [None] * (CAP - N), dtype=object)
            for k, (_, v) in columns.items()}
    return cond.mask(lambda f: arrs[f], CAP)


@pytest.mark.parametrize("op", ["=", "!=", ">", "<", ">=", "<="])
@pytest.mark.parametrize("value", [float(MID), float(I64_MAX - 1023 - 1024), 2**64, -(2**64),
                                   math.inf, -math.inf, "1e30"])
def test_int_bounds_beyond_reference(both, op, value):
    # Integral floats, ints beyond int64 and infinite bounds on an int
    # column: the port compares exactly, as the host evaluator does. The
    # JAX package's device_mask treats an integral float as non-integral
    # and gives no row for an out-of-range int (ROADMAP queue 3).
    _, tfc, cols = both
    cond = TCond().where("ts", op, value)
    assert tfilters.compilable(cond, tfc.names())
    got = tfilters.device_mask(cond, tfc, CAP).numpy()
    np.testing.assert_array_equal(got, _host_mask(cond, {"ts": cols["ts"]}))


def test_gather_host_and_scatter_both_ways(both):
    jfc, tfc, _ = both
    src = np.array([0, 3, 150, 151, 299, 310])
    dst = np.array([5, 6, 7, 8, 9, 10])
    for a, b in ((jfc, tfilters.FilterColumns("cpu")), (tfc, jfilters.FilterColumns())):
        snap = a.gather_host(src)
        b.scatter(snap, dst, CAP)
        back = b.gather_host(dst)
        assert set(back["float"]) == set(snap["float"])
        for k, v in snap["float"].items():
            assert back["float"][k].dtype == np.float32
            np.testing.assert_array_equal(back["float"][k], v)
        assert set(back["int"]) == set(snap["int"])
        for k, trip in snap["int"].items():
            for x, y in zip(back["int"][k], trip):
                assert np.asarray(x).dtype == np.asarray(y).dtype
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the same slots of the two packages snapshot alike
    js, ts = jfc.gather_host(src), tfc.gather_host(src)
    for k in js["float"]:
        np.testing.assert_array_equal(ts["float"][k], np.asarray(js["float"][k]))
    for k in js["int"]:
        for x, y in zip(ts["int"][k], js["int"][k]):
            np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("case", TREES[1:], ids=[c[0] for c in TREES[1:]])
def test_condition_map_both_ways(both, case):
    _, _, cols = both
    records = [{k: v[i] for k, (_, v) in cols.items()} for i in range(0, N, 7)]
    for A, B in ((JCond, TCond), (TCond, JCond)):
        a = _build(A, case[1])
        b = B.from_map(a.to_map())
        assert b.to_map() == a.to_map()
        assert b.dnf() == a.dnf() and b.referenced_fields() == a.referenced_fields()
        assert [b.matches(r) for r in records] == [a.matches(r) for r in records]


# ----------------------------------------------------------------------------
# filtered search through the indexes
# ----------------------------------------------------------------------------

def _mask_for(pkg_filters, cond, corpus):
    """The engine's order: compilable, ensure each referenced column, mask."""
    fc = corpus.filter_columns
    assert pkg_filters.compilable(cond, fc.names())
    for name in cond.referenced_fields():
        fc.ensure(name, corpus.capacity)
    return pkg_filters.device_mask(cond, fc, corpus.capacity)


def _write_columns(corpus, slots, rng_seed):
    rng = np.random.default_rng(rng_seed)
    n = len(slots)
    price = [None if x < 0.05 else float(x) for x in rng.random(n)]
    ts = [None if i % 17 == 0 else T0 + i for i in range(n)]
    corpus.filter_columns.update("price", slots, price, corpus.capacity)
    corpus.filter_columns.update("ts", slots, ts, corpus.capacity, kind="int")


FILTER = (("price", "<", 0.5), ("ts", ">=", T0 + 100))


def _filter_cond(QC):
    c = QC().where(*FILTER[0]).where(*FILTER[1])
    return c.or_(QC().where("ts", "between", (T0 + 7, T0 + 9)))


def _assert_filtered_match(t_idx, j_idx, q, precision, **kw):
    tm = _mask_for(tfilters, _filter_cond(TCond), t_idx.corpus)
    jm = _mask_for(jfilters, _filter_cond(JCond), j_idx.corpus)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    td, ts, _ = t_idx.search_arrays(q, 10, slot_mask=tm, **kw)
    jd, js, _ = j_idx.search_arrays(q, 10, slot_mask=jnp.asarray(jm), **kw)
    allowed = tm.numpy() & t_idx.corpus.valid.numpy()
    assert allowed[ts[ts >= 0]].all()
    qsq = np.sum(q.astype(np.float64) ** 2, axis=1)[:, None]
    neg = float(np.finfo(np.float32).min)

    def as_score(d):
        s = qsq - d.astype(np.float64) ** 2 if t_idx.metric == "l2" else -d.astype(np.float64)
        return np.where(np.isfinite(d), s, neg)

    assert_topk_match(as_score(td), ts, as_score(np.asarray(jd)), js, TOL[precision])
    assert np.array_equal(ts < 0, np.asarray(js) < 0)
    return ts


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_filtered_flat_search_matches(metric, precision):
    rng = np.random.default_rng(len(metric) * 7 + len(precision))
    n, dims = 4000, 96
    x = rng.standard_normal((n, dims)).astype(np.float32)
    t_idx, j_idx = TFlat(dims, metric, precision, device="cpu"), JFlat(dims, metric, precision)
    for idx in (t_idx, j_idx):
        slots = idx.upsert(list(range(n)), x)
        idx.delete(list(range(0, n, 13)))
        _write_columns(idx.corpus, np.asarray(slots), 3)
    q = rng.standard_normal((5, dims)).astype(np.float32)
    ts = _assert_filtered_match(t_idx, j_idx, q, precision)
    assert (ts >= 0).all()
    # fused mode: K1 (B <= 32) and K2 (B > 32) plain versions under the mask
    q40 = rng.standard_normal((40, dims)).astype(np.float32)
    for qq in (q, q40):
        _assert_filtered_match(t_idx, j_idx, qq, precision, mode="fused")


def _clustered(seed, n=3000, d=64, nat=40):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nat, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, nat, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return x, rng


@pytest.mark.parametrize("pq", [0, 16])
def test_filtered_ivf_search_matches(pq):
    # raw: K3's plain version over the bucket-contiguous copy, with the
    # bucket bias rebuilt under the mask; PQ: K4's, then the exact re-rank
    x, rng = _clustered(pq + 1)
    j = JIVF(64, "l2", "bfloat16", num_clusters=16, nprobe=4, pq_subspaces=pq,
             min_train_size=100)
    j.upsert(list(range(len(x))), x)
    t = convert.ivf_index_from_reference(j.state_dict(), "cpu")
    for idx in (t, j):
        idx.delete(list(range(0, len(x), 11)))
        assert (idx.bucket_codes is not None) == bool(pq)
        slots = idx.corpus.slots_for_pks(list(range(len(x))))
        live = slots >= 0
        _write_columns(idx.corpus, slots[live], 5)
    q = x[rng.integers(0, len(x), 6)] + rng.standard_normal((6, 64)).astype(np.float32) * 0.1
    ts = _assert_filtered_match(t, j, q, "bfloat16", mode="probe")
    assert (ts >= 0).sum() > 0
