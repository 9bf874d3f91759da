"""The final selection of every search route, `ops.topk.top_k_first`, on
the CPU: `jax.lax.top_k`'s contract (scores descending in IEEE totalOrder,
NaN first and 0.0 before -0.0, the lower position first among equal
scores, for the k-th place and for the order).

On a CUDA tensor `top_k_first` launches the hand-written `select_topk`
(csrc/select_topk.cu; tests/test_torch_cuda.py holds it to `_select_exact`
bit for bit on the card); on these CPU tensors it runs its plain version,
`_top_k_first_plain`, which is held here to `jax.lax.top_k` on each
route's shape family at narrow width (its fast form too: `select_form`),
on the edge inputs of `torch_parity.select_scores`, with no tolerance:
positions equal and values bit for bit. Also: no CPU route loads the
kernel library; the kernel's wrapper raises on what it does not take; and
K1's merge as the card runs it (the per-lane merge always, no host sync)
gives the reference's hits in its order on tied rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tostore_tpu.ops.topk as jtopk
import tostore_tpu_torch.ops.topk as ttopk
from test_torch_ties import _dup_scan, _kernel_lists
from torch_parity import SELECT_KINDS, TOL, assert_topk_equal, select_scores
from tostore_tpu_torch.ops import _kernels

torch.set_num_threads(1)

BLK = 2048


@pytest.fixture(params=["exact", "fast"])
def select_form(request, monkeypatch):
    """The plain selection over all keys, or its fast form (torch.topk of
    k + 1, then the rows with ties at the cut over all keys)."""
    if request.param == "fast":
        monkeypatch.setattr(ttopk, "EXACT_SELECT_MAX", 0)
    return request.param


def _lax_top_k(x, k):
    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


def _assert_same(v, p, x, k):
    jv, jp = _lax_top_k(x, min(k, x.shape[-1]))
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_array_equal(v.numpy().view(np.int32), jv.view(np.int32))


# Each route's selection at narrow width: (shape, k). K2's merge [B, blocks
# * 256]; K1's per-lane merge [B, 128, splits * W] (k = T, and k = N where
# a lane holds fewer than T) and its final [B, T * 128]; an exact-scan
# chunk; K5 / K6's merge; the IVF probe selection [B, slices], re-rank pool
# and final top-k; k-means assignment [rows, C]; the sharded merge [B,
# shards * k]; the PQ scan.
ROUTES = {
    "k2": ((4, 2048), 10),
    "k1_lanes": ((2, 128, 24), 16),
    "k1_lanes_short": ((2, 128, 8), 16),
    "k1_final": ((3, 2048), 10),
    "exact_chunk": ((3, 4096), 10),
    "k5": ((5, 512), 10),
    "ivf_probe": ((4, 154), 16),
    "ivf_pool": ((3, 2000), 512),
    "ivf_final": ((3, 512), 10),
    "ivf_assign": ((300, 32), 3),
    "sharded": ((4, 40), 10),
    "pq": ((2, 600), 100),
}


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_plain_selection_matches_lax_top_k(select_form, route, kind):
    shape, k = ROUTES[route]
    x = select_scores(shape, kind, len(route) * 31 + SELECT_KINDS.index(kind), k)
    v, p = ttopk.top_k_first(torch.from_numpy(x), k)
    _assert_same(v, p, x, k)


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("shape,k", [((3, 700), 1), ((3, 700), 700), ((2, 9000), 8500),
                                     ((1, 1), 1), ((2, 5), 9)])
def test_plain_selection_k_edges(select_form, shape, k, kind):
    # k = 1, k = N, k above the kernel's SELECT_CAP, N = 1, and k > N
    # (min(k, N) wide)
    assert ttopk.SELECT_CAP < 8500
    x = select_scores(shape, kind, shape[-1] + k, k)
    v, p = ttopk.top_k_first(torch.from_numpy(x), k)
    assert p.shape == (*shape[:-1], min(k, shape[-1]))
    _assert_same(v, p, x, k)


def test_plain_selection_bf16_and_empty():
    # a bf16 input keeps its dtype and is ranked as its exact f32 widening;
    # k = 0 and N = 0 give empty results
    x = select_scores((3, 300), "few", 7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    v, p = ttopk.top_k_first(xb, 20)
    assert v.dtype == torch.bfloat16
    _assert_same(v.float(), p, xb.float().numpy(), 20)
    for s, k in ((torch.zeros(3, 300), 0), (torch.zeros(3, 0), 5), (torch.zeros(0, 8), 3)):
        v, p = ttopk.top_k_first(s, k)
        assert v.numel() == 0 and p.dtype == torch.int64


# --------------------------------------------------------------------------
# No CPU route loads the kernels
# --------------------------------------------------------------------------


@pytest.fixture
def no_library(monkeypatch):
    """`_kernels.library` raises: a CPU route that reached a kernel fails."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(_kernels, "library", refuse)
    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 0)
    before = dict(ttopk.LAUNCHES)
    yield
    assert ttopk.LAUNCHES == before


@pytest.mark.parametrize("b,mode", [(1, "exact"), (1, "fused"), (40, "fused"), (40, "auto"),
                                    (3, "auto")])
def test_flat_routes_on_cpu_load_no_kernel(no_library, b, mode):
    _, tx, alpha = _dup_scan(300 + b, b, 9, "bfloat16", "l2")
    s, i = ttopk.flat_search(tx[0], tx[1], tx[2], k=10, alpha=alpha, mode=mode, row_scale=tx[3])
    assert s.shape == (b, 10) and i.dtype == torch.int64


def test_group_routes_on_cpu_load_no_kernel(no_library):
    _, tx, alpha = _dup_scan(310, 40, 9, "bfloat16", "l2")
    for s, i in (ttopk._fused_group_emit(*tx[:3], k=10, alpha=alpha, blk_n=BLK, gsz=2),
                 ttopk.pipe_topk(*tx[:3], k=10, alpha=alpha, gsz=3)):
        assert s.shape == (40, 10)


@pytest.mark.parametrize("pq", [0, 4], ids=["raw", "pq"])
def test_ivf_routes_on_cpu_load_no_kernel(no_library, pq):
    from tostore_tpu_torch import IVFVectorIndex

    x = np.random.default_rng(5).standard_normal((600, 16)).astype(np.float32)
    idx = IVFVectorIndex(16, "l2", "float32", num_clusters=4, nprobe=4, min_train_size=100,
                         pq_subspaces=pq, device="cpu")
    idx.upsert(list(range(600)), x)
    assert idx.trained
    _, slots, _ = idx.search_arrays(x[:3] + np.float32(0.01), 5, mode="probe")
    assert slots[:, 0].tolist() == [0, 1, 2]


def test_sharded_and_engine_on_cpu_load_no_kernel(no_library):
    import tostore_tpu_torch as P
    from tostore_tpu_torch.parallel import ShardedFlatIndex, make_mesh

    x = np.random.default_rng(9).standard_normal((2000, 48)).astype(np.float32)
    sh = ShardedFlatIndex(48, make_mesh(4, dp=2, devices=["cpu"] * 4), metric="l2")
    sh.upsert(list(range(2000)), x)
    _, pks = sh.search_arrays(x[:4], 5)
    assert pks[:, 0].tolist() == [0, 1, 2, 3]
    schema = P.TableSchema(
        name="v", fields=(P.FieldSchema("emb", P.DataType.vector,
                                        vector_config=P.VectorFieldConfig(dimensions=48)),),
        indexes=(P.IndexSchema(fields=("emb",), type="vector",
                               vector_config=P.VectorIndexConfig(metric="l2")),))
    db = P.ToStoreTPU.memory(schemas=[schema], device="cpu")
    try:
        db.batch_insert("v", [{"emb": row.tolist()} for row in x[:300]])
        assert db.vector_search("v", "emb", x[7], top_k=3)[0].primary_key == 8
    finally:
        db.close()


# --------------------------------------------------------------------------
# The kernel's wrapper: what it raises on
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["float64", "bf16", "1d", "3d", "strided", "k0", "k_above_n"])
def test_select_wrapper_rejects(case):
    s = torch.zeros(4, 64)
    k = 5
    exc = ValueError
    if case == "float64":
        s, exc = s.double(), TypeError
    elif case == "bf16":
        s, exc = s.bfloat16(), TypeError
    elif case == "1d":
        s = s[0]
    elif case == "3d":
        s = s.view(2, 2, 64)
    elif case == "strided":
        s = torch.zeros(64, 4).t()
    elif case == "k0":
        k = 0
    else:
        k = 65
    with pytest.raises(exc):
        ttopk._check_select_inputs(s, k)


def test_select_wrapper_takes_only_cuda_tensors(monkeypatch):
    def refuse():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_kernels, "library", refuse)
    ttopk._check_select_inputs(torch.zeros(4, 64), 5)  # what the kernel takes passes
    with pytest.raises(ValueError, match="CUDA"):
        ttopk._select_topk_cuda(torch.zeros(4, 64), 5)


@pytest.mark.parametrize("n,k,plan", [(65536, 10, (512, 2048)), (2048, 10, (128, 512)),
                                      (1024, 16, (128, 512)), (31744, 5100, (512, 8192)),
                                      (20000, 9000, (512, 8192)), (16, 16, (128, 512))])
def test_select_plan(n, k, plan):
    # (threads a CTA, buffer keys): rows past 4,096 scores take 512
    # threads; the buffer holds the k (a power of two, SELECT_CAP at most,
    # a larger k in chunks) and at least 4 keys a thread
    assert ttopk._select_plan(n, k) == plan


# --------------------------------------------------------------------------
# K1's merge as the card runs it
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,per,k", [("bfloat16", 2, 10), ("int8", 9, 10), ("float32", 9, 5),
                                         ("bfloat16", 2, 20), ("float32", 2, 5),
                                         ("bfloat16", 9, 16)])
def test_k1_card_merge_keeps_reference_order(select_form, dtype, per, k):
    # the per-lane merge always (`card=True`), on K1's per-split lists at
    # the card's kind of plan, against the JAX Pallas kernel
    jx, tx, alpha = _dup_scan(140 + per + k, 3, 18, dtype, "l2")
    q, c, bias, scale = tx
    _, blk_b, t_cands, _ = ttopk._acc_plan(q, c, k, None)
    qp = ttopk._pad_queries(q, blk_b, c.dtype)
    cs, ci = ttopk._block_cands_plain(qp, c, bias, scale, alpha, BLK)
    out_s, out_i = _kernel_lists(cs, ci, per, t_cands)
    ts, ti = ttopk._merge_split_lists(out_s, out_i, t_cands, k, card=True)
    js, ji = jtopk.fused_flat_topk(jx[0], jx[1], jx[2], k=k, alpha=alpha, row_scale=jx[3])
    assert_topk_equal(ts[:3], ti[:3], js, ji, TOL[dtype])
    fs, fi = ttopk._merge_split_lists(out_s, out_i, t_cands, k)  # the CPU's form
    assert torch.equal(ti, fi) and torch.equal(ts.view(torch.int32), fs.view(torch.int32))
