"""The port's CUDA kernels on the card: K1 (`lane_topk_acc`; f32 corpora
`lane_topk_acc_f32`), K2 (`lane_topk_emit`; f32 `lane_topk_emit_f32`), K3
(`ivf_bucket_probe`), K4 (`ivf_adc`), K5 (`lane_topk_group`; f32
`lane_topk_group_f32`) and K6 (`lane_topk_group_pipe`; f32
`lane_topk_group_pipe_f32`) against their plain PyTorch versions on the
same CUDA tensors, the final selection `select_topk` against
`_select_exact` bit for bit on every route's shape (and the flat scans
with no host sync), the flat and IVF indexes on the card (filtered too)
against the same indexes on the CPU, and the sharded indexes of parallel/
on a mesh of 4 cells of one card against the single-device index.

Every test needs an NVIDIA GPU (marker `cuda`) and skips without one. This
file imports no JAX, so it runs on a machine without it; tests/conftest.py
imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances of K1/K2/K5/K6 are stated in tests/torch_parity.py (K5/K6's
candidates within twice that, a near-tie picking the other row); K3 is held to
1e-5 (f32) or 1e-4 (bf16, int8) of max(1, sum_i |q_i x_i| * scale), K4 to
1e-5 of sum_m |tab| (tests/test_torch_ivfprobe.py says why). K3 and K4 take
the (query, probe) pairs grouped by bucket; their probe-pattern cases cover
long, shared and single runs and dead ids.
"""

import numpy as np
import pytest
import torch

import tostore_tpu_torch.ops.ivfprobe as tivf
import tostore_tpu_torch.ops.topk as ttopk
from tostore_tpu_torch import FlatVectorIndex, IVFVectorIndex
from torch_parity import (SELECT_KINDS, TOL, assert_topk_equal, assert_topk_match,
                          select_scores, tie_inputs, torch_scan_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 corpora need true f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _launches():
    return dict(ttopk.LAUNCHES)


def _kernel_name(name, dtype):
    """bf16 and int8 corpora take the TMA/wgmma kernels, f32 ones the f32
    FMA kernels, each with its own launch counter."""
    return name + "_f32" if dtype == "float32" else name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 16, 24, 32])
@pytest.mark.parametrize("blk_n", [2048, 4096])
def test_k1_matches_plain(cuda, dtype, metric, b, blk_n):
    tx, alpha, _ = torch_scan_inputs(b, b, 16384, 256, dtype, metric, device=cuda)
    name = _kernel_name("lane_topk_acc", dtype)
    before = _launches()
    ks, ki = ttopk.fused_flat_topk(*tx[:3], k=10, alpha=alpha, blk_n=blk_n, row_scale=tx[3])
    assert ttopk.LAUNCHES[name] == before[name] + 1
    ps, pi = ttopk._fused_flat_topk_plain(*tx[:3], k=10, alpha=alpha, blk_n=blk_n,
                                          row_scale=tx[3])
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,n", [(40, 16384), (128, 8192), (256, 8192)])
@pytest.mark.parametrize("blk_n", [2048, 4096])
def test_k2_matches_plain(cuda, dtype, b, n, blk_n):
    tx, alpha, _ = torch_scan_inputs(b + n, b, n, 256, dtype, "l2", device=cuda)
    name = _kernel_name("lane_topk_emit", dtype)
    before = _launches()
    ks, ki = ttopk._fused_block_emit(*tx[:3], k=10, alpha=alpha, blk_n=blk_n,
                                     row_scale=tx[3])
    assert ttopk.LAUNCHES[name] == before[name] + 1
    ps, pi = ttopk._fused_block_emit_plain(*tx[:3], k=10, alpha=alpha, blk_n=blk_n,
                                           row_scale=tx[3])
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 8, 24, 32, 40, 128])
def test_kernels_fold_several_blocks_per_cta(cuda, monkeypatch, dtype, b):
    """Nine blocks per CTA and a shorter last split (K1: 16 blocks, splits
    of 9 and 7), as a large corpus gives: K1's first split bubble-inserts
    into sorted lists (more than T/2 blocks), its second writes each
    block's pair to its own slots, and the copy ring crosses block
    boundaries."""
    monkeypatch.setattr(ttopk, "_split_plan",
                        lambda n_blocks, b_tiles, sms, ctas_per_sm=1: (9, -(-n_blocks // 9)))
    tx, alpha, _ = torch_scan_inputs(b + 1, b, 32768, 256, dtype, "l2", device=cuda)
    if b <= ttopk.ACC_MAX_BLK_B:
        name = "lane_topk_acc"
        kernel = ttopk.fused_flat_topk
        plain = ttopk._fused_flat_topk_plain
        kw = {}
    else:
        name = "lane_topk_emit"
        kernel = ttopk._fused_block_emit
        plain = ttopk._fused_block_emit_plain
        kw = {"blk_n": 4096}
    name = _kernel_name(name, dtype)
    before = _launches()
    ks, ki = kernel(*tx[:3], k=10, alpha=alpha, row_scale=tx[3], **kw)
    assert ttopk.LAUNCHES[name] == before[name] + 1
    ps, pi = plain(*tx[:3], k=10, alpha=alpha, row_scale=tx[3], **kw)
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


@pytest.mark.parametrize("b,d", [(32, 4096), (256, 2048)])
def test_large_depth(cuda, b, d):
    """Deep rows: 32 to 64 k-steps per 128-row tile, so the ring of 8
    stages wraps several times within one tile."""
    tx, alpha, _ = torch_scan_inputs(b + d, b, 8192, d, "bfloat16", "dot", device=cuda)
    if b <= ttopk.ACC_MAX_BLK_B:
        kernel, plain, kw = ttopk.fused_flat_topk, ttopk._fused_flat_topk_plain, {}
    else:
        kernel, plain, kw = ttopk._fused_block_emit, ttopk._fused_block_emit_plain, {
            "blk_n": 4096}
    ks, ki = kernel(*tx[:3], k=10, alpha=alpha, row_scale=tx[3], **kw)
    ps, pi = plain(*tx[:3], k=10, alpha=alpha, row_scale=tx[3], **kw)
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k1_k_above_candidates_and_all_invalid(cuda, dtype):
    # 8 blocks in 8 splits at 132 SMs: k > T merges the splits per lane
    tx, alpha, _ = torch_scan_inputs(3, 3, 8 * 2048, 128, dtype, "dot", device=cuda)
    k = ttopk.MAX_T_CANDS * 128 + 10
    ks, ki = ttopk.fused_flat_topk(*tx[:3], k=k, alpha=alpha, row_scale=tx[3])
    ps, pi = ttopk._fused_flat_topk_plain(*tx[:3], k=k, alpha=alpha, row_scale=tx[3])
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])
    bias = torch.full_like(tx[2], ttopk.NEG_INF)
    for kk in (5, k):
        ks, _ = ttopk.fused_flat_topk(tx[0], tx[1], bias, k=kk, row_scale=tx[3])
        assert bool((ks <= ttopk.NEG_INF / 2).all())


def _check_group_cands(kc, pc, qp, corpus, bias, scale, alpha, tol, group_rows):
    """K5/K6 candidates vs the plain version's: the same live entries,
    scores within 2 * tol of max(1, |score|), and where the rows differ (a
    near-tie) the kernel's row lies in the same (group, lane) bucket and
    really has the score it reports."""
    ks, ki = kc[0].double(), kc[1].long()
    ps, pi = pc[0].double(), pc[1].long()
    live = ps > NEG_INF / 2
    assert torch.equal(ks > NEG_INF / 2, live)
    lim = 2 * tol * ps.abs().clamp(min=1.0)
    assert bool(((ks - ps).abs() <= lim)[live].all()), (ks - ps).abs()[live].max().item()
    bs, pos = (live & (ki != pi)).nonzero(as_tuple=True)
    rows = ki[bs, pos]
    assert bool((rows % 128 == pos % 128).all() and (rows // group_rows == pos // 256).all())
    x = corpus[rows].double()
    if scale is not None:
        x = x * scale[rows, None].double()
    s = alpha * (qp[bs].double() * x).sum(1) + bias[rows].double()
    assert bool(((s - ks[bs, pos]).abs() <= lim[bs, pos]).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("b,n,gsz", [(40, 5 * 2048, 2), (256, 8 * 2048, None), (7, 3 * 2048, 1)])
def test_k5_matches_plain(cuda, dtype, metric, b, n, gsz):
    tx, alpha, _ = torch_scan_inputs(b + n, b, n, 256, dtype, metric, device=cuda)
    q, c, bias, scale = tx
    name = _kernel_name("lane_topk_group", dtype)
    before = _launches()
    ks, ki = ttopk._fused_group_emit(q, c, bias, k=10, alpha=alpha, blk_n=2048, gsz=gsz,
                                     row_scale=scale)
    assert ttopk.LAUNCHES[name] == before[name] + 1
    ps, pi = ttopk._fused_group_emit_plain(q, c, bias, k=10, alpha=alpha, blk_n=2048, gsz=gsz,
                                           row_scale=scale)
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])
    blk_b, g = ttopk._group_plan(q, c, 2048, gsz)
    qp = ttopk._pad_queries(q, blk_b, c.dtype)
    kc = ttopk._lane_topk_group_cuda(qp, c, bias, scale, alpha, 2048, g)
    pc = ttopk._group_cands_plain(qp, c, bias, scale, alpha, 2048, g)
    _check_group_cands(kc, pc, qp, c, bias, scale, alpha, TOL[dtype], g * 2048)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,n,gsz", [(40, 4 * 2048, 2), (256, 8 * 2048, 4), (5, 6 * 2048, 3)])
def test_k6_matches_plain_and_k5(cuda, dtype, b, n, gsz):
    tx, alpha, _ = torch_scan_inputs(b + n + 1, b, n, 256, dtype, "l2", device=cuda)
    q, c, bias, _ = tx
    name = _kernel_name("lane_topk_group_pipe", dtype)
    before = _launches()
    ks, ki = ttopk.pipe_topk(q, c, bias, k=10, alpha=alpha, gsz=gsz)
    assert ttopk.LAUNCHES[name] == before[name] + 1
    ps, pi = ttopk._pipe_topk_plain(q, c, bias, k=10, alpha=alpha, gsz=gsz)
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])
    blk_b, g = ttopk._pipe_plan(q, c, 2048, 256, gsz)
    qp = ttopk._pad_queries(q, blk_b, c.dtype)
    kc = ttopk._lane_topk_group_pipe_cuda(qp, c, bias, alpha, 2048, g)
    pc = ttopk._group_cands_plain(qp, c, bias, None, alpha, 2048, g)
    _check_group_cands(kc, pc, qp, c, bias, None, alpha, TOL[dtype], g * 2048)
    # the same scoring code as K5: the same candidates, bit for bit
    k5 = ttopk._lane_topk_group_cuda(qp, c, bias, None, alpha, 2048, g)
    assert torch.equal(kc[0], k5[0]) and torch.equal(kc[1], k5[1])


def _k5_k6_vs_plain(tx, alpha, dtype, gsz, k6=True):
    """K5's candidates against the plain version's on padded queries; K6's,
    where gsz divides the blocks, equal to K5's bit for bit."""
    q, c, bias, scale = tx
    blk_b, g = ttopk._group_plan(q, c, 2048, gsz)
    qp = ttopk._pad_queries(q, blk_b, c.dtype)
    k5 = ttopk._lane_topk_group_cuda(qp, c, bias, scale, alpha, 2048, g)
    pc = ttopk._group_cands_plain(qp, c, bias, scale, alpha, 2048, g)
    torch.cuda.synchronize()
    _check_group_cands(k5, pc, qp, c, bias, scale, alpha, TOL[dtype], g * 2048)
    if k6:
        if scale is not None:  # K6 takes no row scale
            k5 = ttopk._lane_topk_group_cuda(qp, c, bias, None, alpha, 2048, g)
        k6c = ttopk._lane_topk_group_pipe_cuda(qp, c, bias, alpha, 2048, g)
        assert torch.equal(k6c[0], k5[0]) and torch.equal(k6c[1], k5[1])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("tile_b", [32, 64])
@pytest.mark.parametrize("b,n,gsz", [
    (40, 4 * 2048, 2),    # B no multiple of either query tile
    (100, 13 * 2048, 5),  # a partial last group (5, 5, 3 blocks); K5 only
    (256, 8 * 2048, 1),   # groups of one block
    (128, 6 * 2048, 6),   # one group
])
def test_k5_k6_query_tile_widths(cuda, monkeypatch, dtype, tile_b, b, n, gsz):
    """Both query widths of the TMA / wgmma grouped kernels, forced."""
    monkeypatch.setattr(ttopk, "_group_grid_plan",
                        lambda b_pad, n_groups, sms: (tile_b, -(-b_pad // tile_b)))
    tx, alpha, _ = torch_scan_inputs(b + n + tile_b, b, n, 256, dtype, "l2", device=cuda)
    before = _launches()
    _k5_k6_vs_plain(tx, alpha, dtype, gsz, k6=(n // 2048) % gsz == 0)
    assert ttopk.LAUNCHES["lane_topk_group"] > before["lane_topk_group"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("half", [0, 1])
def test_k5_k6_dead_lane_half(cuda, dtype, half):
    """Every row of one lane half dead (lanes 0-63 or 64-127), and a few
    lanes of the other half dead too: their candidates stay at (float32
    min, row 0) and the live half's are the plain version's."""
    tx, alpha, _ = torch_scan_inputs(17 + half, 72, 6 * 2048, 256, dtype, "dot", device=cuda)
    q, c, bias, scale = tx
    lane = torch.arange(c.shape[0], device=cuda) % 128
    dead = (lane // 64 == half) | (lane == 64 * (1 - half) + 5) | (lane == 64 * (1 - half) + 63)
    bias = torch.where(dead, torch.full_like(bias, NEG_INF), bias)
    _k5_k6_vs_plain((q, c, bias, scale), alpha, dtype, 3)
    qp = ttopk._pad_queries(q, 72, c.dtype)
    ks, ki = ttopk._lane_topk_group_cuda(qp, c, bias, scale, alpha, 2048, 3)
    dead_pos = (torch.arange(ks.shape[1], device=cuda) % 128) // 64 == half
    assert bool((ks[:, dead_pos] <= NEG_INF / 2).all())
    tops = dead_pos & (torch.arange(ks.shape[1], device=cuda) % 256 < 128)
    assert bool((ki[:, tops] == 0).all())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("b,d", [(40, 128), (72, 2048), (256, 2048)])
def test_k5_k6_depths(cuda, dtype, b, d):
    """D = 128: two k-steps a tile, fewer than K6's four selection slices;
    D = 2048: 32 k-steps, the ring of 8 stages wraps within a tile."""
    tx, alpha, _ = torch_scan_inputs(b + d, b, 8 * 2048, d, dtype, "dot", device=cuda)
    _k5_k6_vs_plain(tx, alpha, dtype, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [40, 256])
def test_flat_auto_on_card_launches_k2(cuda, monkeypatch, dtype, b):
    """On a CUDA corpus `auto` sends B > 32 to K2; the result is the plain
    version's."""
    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)
    tx, alpha, _ = torch_scan_inputs(b, b, 8192, 256, dtype, "l2", device=cuda)
    name = _kernel_name("lane_topk_emit", dtype)
    before = _launches()
    ks, ki = ttopk.flat_search(*tx[:3], k=10, alpha=alpha, mode="auto", row_scale=tx[3])
    assert ttopk.LAUNCHES[name] == before[name] + 1
    ps, pi = ttopk._fused_block_emit_plain(*tx[:3], k=10, alpha=alpha, blk_n=4096,
                                           row_scale=tx[3])
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


def _tie_scan(dev, dtype, b, n_blocks=16, d=256, metric="l2", seed=0):
    """Scan tensors with one row copied across lanes, blocks and split
    boundaries (`torch_parity.tie_inputs`): the top hits score exactly alike."""
    inputs = tie_inputs(seed + b, b, n_blocks, d, dtype, metric)
    tx, alpha, _ = torch_scan_inputs(None, b, None, d, dtype, metric, device=dev, inputs=inputs)
    return tx, alpha


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 8, 32, 40, 256])
@pytest.mark.parametrize("fold", [False, True])
def test_ties_kernels_match_plain_in_order(cuda, monkeypatch, dtype, b, fold):
    """K1 / K2 on copied rows: the plain version's hits in its order (the
    reference's tie order); `fold` forces 9 blocks a split, so K1
    bubble-inserts into sorted lists."""
    if fold:
        monkeypatch.setattr(ttopk, "_split_plan", lambda n_blocks, *_: (9, -(-n_blocks // 9)))
    tx, alpha = _tie_scan(cuda, dtype, b)
    ks, ki = ttopk.fused_flat_topk(*tx[:3], k=10, alpha=alpha, row_scale=tx[3])
    if b <= 32:
        ps, pi = ttopk._fused_flat_topk_plain(*tx[:3], k=10, alpha=alpha, row_scale=tx[3])
    else:
        ps, pi = ttopk._fused_block_emit_plain(*tx[:3], k=10, alpha=alpha, blk_n=4096,
                                               row_scale=tx[3])
    torch.cuda.synchronize()
    assert_topk_equal(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [40, 256])
def test_auto_above_32_queries_holds_the_fused_contract(cuda, monkeypatch, dtype, b):
    """On the card `auto` at B > 32 takes K2, the reference's
    mode="fused" contract, ties included: its hits and order are those of
    mode="fused" on the card and of the CPU's mode="fused" (the reference's
    `auto` there takes the lane scan, whose tied set may differ)."""
    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)
    tx, alpha = _tie_scan(cuda, dtype, b)
    auto = ttopk.flat_search(*tx[:3], k=10, alpha=alpha, mode="auto", row_scale=tx[3])
    fused = ttopk.flat_search(*tx[:3], k=10, alpha=alpha, mode="fused", row_scale=tx[3])
    cpu = ttopk.flat_search(tx[0].cpu(), tx[1].cpu(), tx[2].cpu(), k=10, alpha=alpha,
                            mode="fused", row_scale=None if tx[3] is None else tx[3].cpu())
    torch.cuda.synchronize()
    assert_topk_equal(auto[0].cpu(), auto[1].cpu(), fused[0].cpu(), fused[1].cpu(), 0.0)
    assert_topk_equal(auto[0].cpu(), auto[1].cpu(), cpu[0], cpu[1], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ties_k5_k6_match_plain_in_order(cuda, dtype):
    tx, alpha = _tie_scan(cuda, dtype, 72)
    ks, ki = ttopk._fused_group_emit(*tx[:3], k=10, alpha=alpha, blk_n=2048, gsz=3,
                                     row_scale=tx[3])
    ps, pi = ttopk._fused_group_emit_plain(*tx[:3], k=10, alpha=alpha, blk_n=2048, gsz=3,
                                           row_scale=tx[3])
    ks6, ki6 = ttopk.pipe_topk(*tx[:3], k=10, alpha=alpha, gsz=4)
    ps6, pi6 = ttopk._pipe_topk_plain(*tx[:3], k=10, alpha=alpha, gsz=4)
    torch.cuda.synchronize()
    assert_topk_equal(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])
    assert_topk_equal(ks6.cpu(), ki6.cpu(), ps6.cpu(), pi6.cpu(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_auto_on_card_past_256_queries(cuda, monkeypatch, dtype):
    """Past 256 queries `auto` keeps bf16 on K2 and sends f32 to the plain
    lane scan (no launch); each gives its plain version's result (the lane
    scan's on the CPU)."""
    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)
    tx, alpha, _ = torch_scan_inputs(512, 512, 8192, 256, dtype, "l2", device=cuda)
    name = _kernel_name("lane_topk_emit", dtype)
    before = _launches()
    ks, ki = ttopk.flat_search(*tx[:3], k=10, alpha=alpha, mode="auto", row_scale=tx[3])
    assert ttopk.LAUNCHES[name] == before[name] + (dtype != "float32")
    if dtype == "float32":
        ps, pi = ttopk.flat_topk_lane(*(t.cpu() for t in tx[:3]), k=10, alpha=alpha)
    else:
        ps, pi = ttopk._fused_block_emit_plain(*tx[:3], k=10, alpha=alpha, blk_n=4096)
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


@pytest.mark.parametrize("trained", [False, True])
def test_ivf_index_on_card_maybe_compact(cuda, trained):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2000, 64)).astype(np.float32)
    idx = IVFVectorIndex(64, "l2", "bfloat16", num_clusters=8, nprobe=8,
                         min_train_size=100 if trained else 10**9, device=cuda)
    idx.upsert(list(range(2000)), x)
    assert idx.trained == trained
    idx.delete(list(range(0, 100)))
    assert idx.maybe_compact(0.10) is False and idx.corpus.deleted_count == 100
    idx.delete(list(range(100, 300)))
    assert idx.quiescent_s() >= 0.0
    assert idx.maybe_compact(0.10) is True and idx.corpus.deleted_count == 0
    assert idx.search(x[777], top_k=1)[0].primary_key == 777


def test_k5_k6_raise_on_bad_cuda_input(cuda):
    c = torch.zeros(4096, 128, dtype=torch.bfloat16, device=cuda)
    bias = torch.zeros(4096, device=cuda)
    q = torch.zeros(8, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):  # f32 queries on a bf16 corpus
        ttopk._lane_topk_group_cuda(q.float(), c, bias, None, 1.0, 2048, 1)
    with pytest.raises(ValueError):  # gsz does not divide the 2 blocks
        ttopk._lane_topk_group_pipe_cuda(q, c, bias, 1.0, 2048, 3)
    with pytest.raises(ValueError):  # bias of the wrong length
        ttopk._fused_group_emit(q, c, bias[:100], k=5, alpha=1.0, blk_n=2048)
    with pytest.raises(ValueError):  # unpadded corpus
        ttopk.pipe_topk(q, c[:3000], bias[:3000], k=5)


def test_filtered_flat_index_card_matches_cpu(cuda):
    from tostore_tpu_torch.query import QueryCondition
    from tostore_tpu_torch.vector import filters

    rng = np.random.default_rng(8)
    x = rng.standard_normal((9000, 96)).astype(np.float32)
    q = rng.standard_normal((8, 96)).astype(np.float32)
    price = rng.random(9000).tolist()
    cond = QueryCondition().where("price", "<", 0.25)
    res = {}
    for dev in ("cpu", cuda):
        idx = FlatVectorIndex(96, "l2", "bfloat16", device=dev)
        slots = idx.upsert(list(range(9000)), x)
        idx.corpus.filter_columns.update("price", slots, price, idx.corpus.capacity)
        assert filters.compilable(cond, idx.corpus.filter_columns.names())
        mask = filters.device_mask(cond, idx.corpus.filter_columns, idx.corpus.capacity)
        assert mask.device.type == torch.device(dev).type
        res[str(dev)] = idx.search_arrays(q, 10, slot_mask=mask, mode="fused")
    d_cpu, s_cpu, p_cpu = res["cpu"]
    d_gpu, s_gpu, p_gpu = res[str(cuda)]
    assert all(price[p] < 0.25 for p in p_gpu.ravel())
    qsq = np.sum(q * q, axis=1)[:, None]
    assert_topk_match(qsq - d_gpu.astype(np.float64) ** 2, s_gpu,
                      qsq - d_cpu.astype(np.float64) ** 2, s_cpu, TOL["bfloat16"])


@pytest.mark.parametrize("case", ["unpadded", "misaligned"])
def test_wrapper_raises_on_bad_cuda_input(cuda, case):
    if case == "unpadded":
        c = torch.zeros(3000, 128, device=cuda)
    else:  # a corpus base 2 bytes past a 16-byte boundary: TMA cannot read it
        c = torch.zeros(4096 * 128 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(4096, 128)
    with pytest.raises(ValueError):
        ttopk.fused_flat_topk(torch.zeros(2, 128, device=cuda), c,
                              torch.zeros(c.shape[0], device=cuda), k=5)


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
def test_flat_index_card_matches_cpu(cuda, precision):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((9000, 96)).astype(np.float32)
    q = rng.standard_normal((8, 96)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        idx = FlatVectorIndex(96, "l2", precision, device=dev)
        idx.upsert(list(range(9000)), x)
        idx.delete(list(range(0, 9000, 50)))
        res[str(dev)] = idx.search_arrays(q, 10, mode="fused")
    d_cpu, s_cpu, _ = res["cpu"]
    d_gpu, s_gpu, _ = res[str(cuda)]
    qsq = np.sum(q * q, axis=1)[:, None]
    assert_topk_match(qsq - d_gpu.astype(np.float64) ** 2, s_gpu,
                      qsq - d_cpu.astype(np.float64) ** 2, s_cpu, TOL[precision])


NEG_INF = float(np.finfo(np.float32).min)
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _check_scores(got, want, lim):
    live = want > NEG_INF / 2
    assert torch.equal(got > NEG_INF / 2, live)
    err = (got - want).abs()
    assert bool((err[live] <= lim[live]).all()), err[live].max().item()


def _probe_inputs(dev, dtype, c, cap, d, b, p, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    scale = None
    if dtype == "int8":
        v = torch.randint(-127, 128, (c, cap, d), generator=g, device=dev,
                          dtype=torch.int16).to(torch.int8)
        scale = (torch.rand((c, cap), generator=g, device=dev) + 0.5) / 127
    else:
        v = torch.randn((c, cap, d), generator=g, device=dev).to(_TDT[dtype])
    bias = -torch.rand((c, cap), generator=g, device=dev) * 10
    bias[torch.rand((c, cap), generator=g, device=dev) < 0.1] = NEG_INF
    q = torch.randn((b, d), generator=g, device=dev)
    q = q.to(torch.float32 if dtype == "float32" else torch.bfloat16)
    probes = torch.randint(0, c, (b, p), generator=g, device=dev, dtype=torch.int32)
    return q, probes, v, bias, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("cap,d,b,p", [(37, 128, 1, 1), (1000, 256, 3, 5), (64, 768, 9, 2),
                                       (200, 2048, 2, 3)])
def test_k3_matches_plain(cuda, dtype, cap, d, b, p):
    q, probes, v, bias, scale = _probe_inputs(cuda, dtype, 7, cap, d, b, p, cap + d)
    before = tivf.LAUNCHES["ivf_bucket_probe"]
    got = tivf.bucket_probe_scores(q, probes, v, bias, scale)
    assert tivf.LAUNCHES["ivf_bucket_probe"] == before + 1
    want = tivf._bucket_probe_scores_plain(q, probes, v, bias, scale)
    mag = tivf._bucket_probe_scores_plain(q.abs(), probes, v.abs(), torch.zeros_like(bias),
                                          scale)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 1e-4
    _check_scores(got, want, tol * mag.clamp(min=1.0))


def _adc_inputs(dev, m, k, packed, c, cap, b, p, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tabs = torch.randn((b, p, m, k), generator=g, device=dev) * 4
    rows = m // 2 if packed else m
    codes = torch.randint(0, 256 if packed else k, (c, rows, cap), generator=g, device=dev,
                          dtype=torch.int16).to(torch.uint8)
    bias = torch.zeros((c, cap), device=dev)
    bias[torch.rand((c, cap), generator=g, device=dev) < 0.1] = NEG_INF
    probes = torch.randint(0, c, (b, p), generator=g, device=dev, dtype=torch.int32)
    return tabs, probes, codes, bias


@pytest.mark.parametrize("m,k,packed,smem", [
    (96, 256, False, None),       # 48 KB bf16 table: three chunks of 32 subspaces
    (128, 256, False, None),      # 64 KB: four chunks of the default budget
    (192, 16, True, None),
    (192, 16, True, 16 * 32),     # 16 subspaces a chunk: 12 chunks of byte rows
    (12, 64, False, 5 * 128),     # 5 subspaces a chunk, a short last chunk
    (3, 256, False, None),        # (M, K) the JAX kernel does not take
])
@pytest.mark.parametrize("cap,b,p", [(37, 1, 1), (1984, 4, 16), (1030, 2, 3)])
def test_k4_matches_plain(cuda, monkeypatch, m, k, packed, smem, cap, b, p):
    if smem is not None:
        monkeypatch.setattr(tivf, "ADC_SMEM_BYTES", smem)
    tabs, probes, codes, bias = _adc_inputs(cuda, m, k, packed, 5, cap, b, p, m + k + cap)
    before = tivf.LAUNCHES["ivf_adc"]
    got = tivf.adc_bucket_scores(tabs, probes, codes, bias)
    assert tivf.LAUNCHES["ivf_adc"] == before + 1
    rounded = tivf.round_tables(tabs)
    want = tivf._adc_bucket_scores_plain(rounded, probes, codes, bias)
    mag = -tivf._adc_bucket_scores_plain(rounded.abs(), probes, codes, torch.zeros_like(bias))
    torch.cuda.synchronize()
    _check_scores(got, want, 1e-5 * mag)


def _pattern_probes(pattern, probes, c):
    """K3/K4 probe patterns on [B, P] probes: every pair in one bucket (a
    run longer than 64), every query probing the same P buckets, or random
    with ids -1 and C."""
    if pattern == "one_bucket":
        probes[:] = 2
    elif pattern == "shared":
        probes[:] = torch.randperm(c, device=probes.device)[: probes.shape[1]].to(probes.dtype)
    elif pattern == "out_of_range":
        probes[0, 0], probes[-1, -1], probes[probes.shape[0] // 2, 0] = -1, c, c + 7
    return probes


def _check_live_dead(got, want, lim, probes, c):
    """Pairs with an id in [0, C) against the plain version (run on the
    clamped ids), the others dead."""
    live = (probes >= 0) & (probes < c)
    assert bool((got[~live] <= NEG_INF / 2).all())
    _check_scores(got[live], want[live], lim[live])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pattern", ["one_bucket", "shared", "out_of_range", "single"])
@pytest.mark.parametrize("d", [128, 768, 2048])
def test_k3_probe_patterns(cuda, dtype, pattern, d):
    """Queries grouped by bucket: runs of 150 (chunks of 64, 64, 22), runs
    of B, a single pair, dead runs; cap 300 is no multiple of the row tile."""
    b, p = (1, 1) if pattern == "single" else (50, 3)
    q, probes, v, bias, scale = _probe_inputs(cuda, dtype, 7, 300, d, b, p, d + len(pattern))
    probes = _pattern_probes(pattern, probes, 7)
    before = tivf.LAUNCHES["ivf_bucket_probe"]
    got = tivf.bucket_probe_scores(q, probes, v, bias, scale)
    assert tivf.LAUNCHES["ivf_bucket_probe"] == before + 1
    pc = probes.clamp(0, 6)
    want = tivf._bucket_probe_scores_plain(q, pc, v, bias, scale)
    mag = tivf._bucket_probe_scores_plain(q.abs(), pc, v.abs(), torch.zeros_like(bias), scale)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 1e-4
    _check_live_dead(got, want, tol * mag.clamp(min=1.0), probes, 7)


@pytest.mark.parametrize("b,p", [(1, 1), (8, 16), (64, 16), (300, 16), (5, 3)])
@pytest.mark.parametrize("wide", [False, True])
def test_grouping_prepass_matches_plain(cuda, b, p, wide):
    """K3/K4's pre-pass: the pairs sorted by clamped id, stable, per launch
    slice of RUN_MAX (300 x 16 pairs take two), equal to the plain sort."""
    g = torch.Generator(device=cuda)
    g.manual_seed(b * p)
    probes = torch.randint(-3, 12, (b, p), generator=g, device=cuda)
    if wide:
        probes[0, 0] = 2**40  # an int64 id must not wrap into [0, C)
        probes = probes.t().contiguous().t()  # strided: read in place, not copied
    else:
        probes = probes.to(torch.int32)
    got = tivf._group_pairs_cuda(probes, 9)
    want = tivf._group_pairs_plain(probes, 9)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_more_pairs_than_one_launch(cuda, dtype):
    """B * P = 4,800 sorted pairs: two launches, a run cut between them."""
    q, probes, v, bias, scale = _probe_inputs(cuda, dtype, 3, 64, 128, 300, 16, 11)
    before = tivf.LAUNCHES["ivf_bucket_probe"]
    got = tivf.bucket_probe_scores(q, probes, v, bias, scale)
    assert tivf.LAUNCHES["ivf_bucket_probe"] == before + 2
    want = tivf._bucket_probe_scores_plain(q, probes, v, bias, scale)
    mag = tivf._bucket_probe_scores_plain(q.abs(), probes, v.abs(), torch.zeros_like(bias), scale)
    torch.cuda.synchronize()
    _check_scores(got, want, (1e-5 if dtype == "float32" else 1e-4) * mag.clamp(min=1.0))


@pytest.mark.parametrize("m,k,packed", [(96, 256, False), (192, 16, True), (4, 12, False)])
@pytest.mark.parametrize("pattern", ["one_bucket", "shared", "out_of_range", "single",
                                     "broadcast"])
@pytest.mark.parametrize("cap", [1040, 300])
def test_k4_probe_patterns(cuda, m, k, packed, pattern, cap):
    """Runs of 150, runs of B, a single pair, dead runs, and one table per
    query broadcast over P (stride 0, as a non-residual index passes it);
    K = 12 pads the table rows; cap 1040 takes the TMA code tile, 300 (no
    multiple of 16) the threads' loads, neither a multiple of 512."""
    b, p = (1, 1) if pattern == "single" else (50, 3)
    tabs, probes, codes, bias = _adc_inputs(cuda, m, k, packed, 7, cap, b, p, m + k + cap)
    probes = _pattern_probes(pattern, probes, 7)
    if pattern == "broadcast":
        tabs = tabs[:, :1].expand(b, p, m, k)
    before = tivf.LAUNCHES["ivf_adc"]
    got = tivf.adc_bucket_scores(tabs, probes, codes, bias)
    assert tivf.LAUNCHES["ivf_adc"] == before + 1
    rounded, pc = tivf.round_tables(tabs), probes.clamp(0, 6)
    want = tivf._adc_bucket_scores_plain(rounded, pc, codes, bias)
    mag = -tivf._adc_bucket_scores_plain(rounded.abs(), pc, codes, torch.zeros_like(bias))
    torch.cuda.synchronize()
    _check_live_dead(got, want, 1e-5 * mag, probes, 7)


def test_probe_ids_out_of_range_score_dead(cuda):
    q, probes, v, bias, _ = _probe_inputs(cuda, "bfloat16", 4, 100, 128, 2, 3, 1)
    probes[0, 1] = 4
    probes[1, 0] = -1
    s = tivf.bucket_probe_scores(q, probes, v, bias)
    assert bool((s[0, 1] <= NEG_INF / 2).all()) and bool((s[1, 0] <= NEG_INF / 2).all())
    tabs, pr, codes, bias = _adc_inputs(cuda, 8, 16, False, 4, 100, 2, 3, 2)
    pr[1, 2] = 99
    s = tivf.adc_bucket_scores(tabs, pr, codes, bias)
    assert bool((s[1, 2] <= NEG_INF / 2).all())


@pytest.mark.parametrize("precision,pq", [("float32", 0), ("bfloat16", 0), ("int8", 0),
                                          ("bfloat16", 16), ("float32", 8)])
def test_ivf_index_card_matches_cpu(cuda, precision, pq):
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((30, 64)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 30, 5000)] + rng.standard_normal((5000, 64))).astype(np.float32)
    q = x[:8] + rng.standard_normal((8, 64)).astype(np.float32) * 0.1
    # trained once on the CPU; both copies rebuild their layout from the
    # same centroids and codebooks
    idx = IVFVectorIndex(64, "l2", precision, num_clusters=16, nprobe=4, pq_subspaces=pq,
                         min_train_size=100, device="cpu")
    idx.upsert(list(range(5000)), x)
    idx.delete(list(range(0, 5000, 50)))
    state = idx.state_dict()
    res = {}
    for dev in ("cpu", cuda):
        idx = IVFVectorIndex.from_state_dict(state, device=dev)
        idx.delete(list(range(1, 5000, 70)))
        assert (idx.bucket_vectors is not None) == (pq == 0)
        assert (idx.bucket_codes is not None) == (pq > 0)
        before = dict(tivf.LAUNCHES)
        res[str(dev)] = idx.search_arrays(q, 10, mode="probe")
        name = "ivf_adc" if pq else "ivf_bucket_probe"
        assert tivf.LAUNCHES[name] == before[name] + (dev != "cpu")
    d_cpu, s_cpu, _ = res["cpu"]
    d_gpu, s_gpu, _ = res[str(cuda)]
    qsq = np.sum(q * q, axis=1)[:, None]
    assert_topk_match(qsq - d_gpu.astype(np.float64) ** 2, s_gpu,
                      qsq - d_cpu.astype(np.float64) ** 2, s_cpu, TOL[precision])


# --- the engine on the card ---------------------------------------------------


def _engine_schema(P, name, prec, **index):
    return P.TableSchema(
        name=name,
        fields=(P.FieldSchema("price", P.DataType.double),
                P.FieldSchema("emb", P.DataType.vector, vector_config=P.VectorFieldConfig(
                    dimensions=256, precision=prec))),
        indexes=(P.IndexSchema(fields=("emb",), type="vector",
                               vector_config=P.VectorIndexConfig(metric="l2", **index)),),
    )


@pytest.mark.parametrize("prec", ["bfloat16", "int8", "float32"])
def test_engine_on_card_matches_engine_on_cpu(cuda, monkeypatch, tmp_path, prec):
    """The same rows through `ToStoreTPU` on the default device (the card)
    and with device="cpu": equal pks, through the flat table (K1), the IVF
    table after maintenance trained it (K3) and a filtered search; from 8
    threads every search launches K1 once (the search that captures the
    key's CUDA graph twice: eagerly, then replayed); a checkpoint, a WAL
    tail, a hard drop and a reopen on the card keep the answers."""
    import threading

    import tostore_tpu_torch as P

    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)  # 8,192 slots take the lane kernels
    rng = np.random.default_rng(31)
    x = rng.standard_normal((9000, 256)).astype(np.float32)
    recs = [{"price": float(i % 100), "emb": x[i]} for i in range(len(x))]
    schemas = [_engine_schema(P, "flat", prec, index_type="flat"),
               _engine_schema(P, "ivf", prec, index_type="ivf", num_clusters=16, nprobe=16)]
    dbs = {"card": P.ToStoreTPU.open(str(tmp_path / "card"), schemas=schemas),
           "cpu": P.ToStoreTPU.open(str(tmp_path / "cpu"), schemas=schemas, device="cpu")}
    cond = P.QueryCondition().where("price", "<", 25.0)
    got = {}
    for name, db in dbs.items():
        assert db.engine.config.device == ("cuda" if name == "card" else "cpu")
        for t in ("flat", "ivf"):
            assert db.batch_insert(t, recs[:8000]).is_success
            db.vector_search(t, "emb", x[0], top_k=1)
        assert db.engine.run_vector_maintenance() == 1
        vi = db.engine._table("ivf").vector_indexes["emb"]
        assert vi.trained and vi.corpus.vectors.device.type == ("cuda" if name == "card"
                                                                 else "cpu")
        for key in ttopk.LAUNCHES:
            ttopk.LAUNCHES[key] = 0
        for key in tivf.LAUNCHES:
            tivf.LAUNCHES[key] = 0
        got[name] = [
            [h.primary_key for h in db.vector_search("flat", "emb", x[5] + 0.05, top_k=10)],
            [h.primary_key for h in db.vector_search("ivf", "emb", x[6] + 0.05, top_k=10,
                                                     mode="probe")],
            [h.primary_key for h in db.vector_search("flat", "emb", x[7] + 0.05, top_k=10,
                                                     condition=cond)],
        ]
        if name == "card":
            k1 = _kernel_name("lane_topk_acc", prec)
            assert ttopk.LAUNCHES[k1] == 2 and tivf.LAUNCHES["ivf_bucket_probe"] == 1
    # k-means runs on each device in its own arithmetic: the IVF tables are
    # held to their own exact scan, the flat ones to each other
    assert got["card"][0] == got["cpu"][0] and got["card"][2] == got["cpu"][2]
    for name, db in dbs.items():
        exact = [h.primary_key for h in db.vector_search("ivf", "emb", x[6] + 0.05, top_k=10,
                                                         mode="exact")]
        assert len(set(got[name][1]) & set(exact)) >= 9, (name, got[name][1], exact)
    assert all(dbs["cpu"].get_by_pk("flat", pk)["price"] < 25.0 for pk in got["card"][2])

    db = dbs["card"]
    k1 = _kernel_name("lane_topk_acc", prec)
    ttopk.LAUNCHES[k1] = 0
    captures = ttopk.LAUNCHES["flat_graph_capture"]
    out = [None] * 8

    def worker(i):
        out[i] = [[h.primary_key for h in db.vector_search("flat", "emb", x[j] + 0.05, top_k=10)]
                  for j in range(20)]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    captures = ttopk.LAUNCHES["flat_graph_capture"] - captures
    assert captures == 1 and ttopk.LAUNCHES[k1] == 160 + captures
    assert all(o == out[0] for o in out)

    db.flush()
    assert db.batch_insert("flat", recs[8000:]).is_success  # lives only in the WAL
    want = [h.primary_key for h in db.vector_search("flat", "emb", x[8500] + 0.05, top_k=5)]
    assert want[0] == 8501
    db.engine._wal.close()
    db.engine._crontab.stop()
    del db
    db = P.ToStoreTPU.open(str(tmp_path / "card"))
    assert db.engine._counters["recovered_wal_entries"] > 0
    assert [h.primary_key for h in db.vector_search("flat", "emb", x[8500] + 0.05, top_k=5)] == want
    assert db.engine._table("flat").vector_indexes["emb"].corpus.vectors.is_cuda
    assert db.status.memory()["hbm_limit"] > 0
    db.close()
    dbs["cpu"].close()


# --------------------------------------------------------------------------
# parallel/: a mesh of 4 cells on one card against the single-device index
# --------------------------------------------------------------------------


def _card_mesh(dev, dp):
    from tostore_tpu_torch.parallel import make_mesh

    return make_mesh(4, dp=dp, devices=[dev] * 4)


@pytest.fixture(params=[0])
def card(request, cuda):
    """The card the sharded tests run on, by index: the kernel wrappers
    launch under the tensor's own device, so a machine with several cards
    may add their indexes here."""
    if request.param >= torch.cuda.device_count():
        pytest.skip(f"no cuda:{request.param}")
    return torch.device("cuda", request.param)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("precision", ["bfloat16", "int8", "float32"])
def test_sharded_flat_on_card_matches_single_device(card, monkeypatch, dp, precision):
    from tostore_tpu_torch.parallel import ShardedFlatIndex

    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 0)  # the stripes are small: take the kernels
    rng = np.random.default_rng(31)
    n, d = 20_000, 256
    x = rng.standard_normal((n, d)).astype(np.float32)
    one = FlatVectorIndex(d, "l2", precision, device=card)
    sh = ShardedFlatIndex(d, _card_mesh(card, dp), "l2", precision)
    for idx in (one, sh):
        idx.upsert(list(range(n)), x)
        idx.delete(list(range(0, n, 50)))
    assert all(t.device == card for t in sh.vectors.parts.values())
    for b, kernel in ((1, "lane_topk_acc"), (8, "lane_topk_acc"), (80, "lane_topk_emit")):
        q = x[rng.integers(0, n, b)] + rng.standard_normal((b, d)).astype(np.float32) * 0.1
        before = _launches()
        sd, sp = sh.search_arrays(q, 10)
        name = _kernel_name(kernel, precision)
        assert ttopk.LAUNCHES[name] == before[name] + 4  # once per cell
        od, _, op = one.search_arrays(q, 10)
        assert not any(p % 50 == 0 for p in sp.ravel())
        same = np.mean([len(set(sp[i]) & set(op[i])) / 10 for i in range(b)])
        assert same >= 0.99, (b, same)
        # f32 sums in another order (tests/torch_parity.py), on the squared distances
        np.testing.assert_allclose(np.sort(sd, 1) ** 2, np.sort(od, 1) ** 2,
                                   rtol=10 * TOL[precision], atol=1e-2)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("pq", [0, 16])
def test_sharded_ivf_on_card_matches_cpu_cells(card, dp, pq):
    """The sharded IVF index on 4 cells of the card against the same index
    on 4 CPU cells with its centroids and codebooks carried across: K3 / K4
    launch once per cell, and the results agree."""
    from tostore_tpu_torch.parallel import make_mesh
    from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    rng = np.random.default_rng(33)
    nat, n, d = 30, 6000, 128
    centers = rng.standard_normal((nat, d)).astype(np.float32) * 4
    x = (centers[rng.integers(0, nat, n)] + rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    host = ShardedIVFIndex(d, make_mesh(4, dp=dp, devices=["cpu"] * 4), "l2", "bfloat16",
                           num_clusters=16, nprobe=6, min_train_size=100, pq_subspaces=pq)
    host.upsert(list(range(n)), x)
    host.delete(list(range(0, 300, 3)))
    on_card = ShardedIVFIndex.from_state_dict(host.state_dict(), _card_mesh(card, dp))
    host = ShardedIVFIndex.from_state_dict(host.state_dict(), host.mesh)
    contig = on_card.bucket_codes if pq else on_card.bucket_vectors
    assert contig is not None and all(t.device == card for t in contig.parts.values())
    np.testing.assert_array_equal(on_card._bucket_counts, host._bucket_counts)
    q = x[rng.integers(0, n, 6)] + rng.standard_normal((6, d)).astype(np.float32) * 0.05
    kernel = "ivf_adc" if pq else "ivf_bucket_probe"
    before = dict(tivf.LAUNCHES)
    cd, cp = on_card.search_arrays(q, 10)
    assert tivf.LAUNCHES[kernel] == before[kernel] + 4  # once per cell
    hd, hp = host.search_arrays(q, 10)
    same = np.mean([len(set(cp[i]) & set(hp[i])) / 10 for i in range(6)])
    assert same >= 0.95, same
    np.testing.assert_allclose(np.sort(cd, 1) ** 2, np.sort(hd, 1) ** 2, rtol=1e-3, atol=1e-2)
    # a delete stales the cached bias; a slot mask never caches
    victim = cp[0][0]
    on_card.delete([victim])
    assert on_card._bias_stale
    assert victim not in on_card.search_arrays(q[:1], 10)[1]
    mask = torch.ones(on_card.capacity, dtype=torch.bool, device=card)
    mask[int(on_card.slots_for_pks([cp[1][0]])[0])] = False
    assert cp[1][0] not in on_card.search_arrays(q[1:2], 10, slot_mask=mask)[1]
    assert cp[1][0] in on_card.search_arrays(q[1:2], 10)[1]


def test_engine_mesh_on_card(card, monkeypatch):
    """`mesh_shape` with a device that has an index: every cell on that
    card; with "cuda" alone a mesh of more cells than cards raises."""
    import tostore_tpu_torch as P

    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 0)
    rng = np.random.default_rng(35)
    x = rng.standard_normal((5000, 256)).astype(np.float32)
    db = P.ToStoreTPU.memory(schemas=[_engine_schema(P, "docs", "bfloat16", index_type="flat")],
                             device=str(card), mesh_shape=(2, 2))
    try:
        db.batch_insert("docs", [{"price": float(i % 50), "emb": x[i]} for i in range(5000)])
        vi = db.engine._table("docs").vector_indexes["emb"]
        assert vi.index_type == "sharded_flat"
        before = _launches()
        assert db.vector_search("docs", "emb", x[7], top_k=1)[0].primary_key == 8
        assert ttopk.LAUNCHES["lane_topk_acc"] == before["lane_topk_acc"] + 4
        hits = db.vector_search("docs", "emb", x[7], top_k=5,
                                condition=P.QueryCondition().where("price", ">", 20.0))
        assert hits and all(db.get_by_pk("docs", h.primary_key)["price"] > 20.0 for h in hits)
    finally:
        db.close()
    if torch.cuda.device_count() < 4:
        with pytest.raises(RuntimeError, match="cards"):
            P.ToStoreTPU.memory(schemas=[_engine_schema(P, "docs", "bfloat16",
                                                        index_type="flat")],
                                device="cuda", mesh_shape=(4,))


@pytest.mark.parametrize("n", [4, 1])
def test_dryrun_multichip_defaults_to_the_card(cuda, n):
    """The harness entry point with no device named: n cells on the first
    card, the flat step through K1 (f32 form) and the IVF-PQ step through
    K4, once per cell."""
    import __graft_entry_torch__ as g  # at the repository's root: run with `python -m pytest`

    flat, ivf = _launches(), dict(tivf.LAUNCHES)
    g.dryrun_multichip(n)
    assert ttopk.LAUNCHES["lane_topk_acc_f32"] == flat["lane_topk_acc_f32"] + n
    assert tivf.LAUNCHES["ivf_adc"] == ivf["ivf_adc"] + n


# --------------------------------------------------------------------------
# select_topk (csrc/select_topk.cu): the final selection of every route
# --------------------------------------------------------------------------

# (shape, k) of each route's selection at the smoke's sizes (1M rows, B up
# to 256): K2's merge; K1's per-lane merge at B = 32 (a lane shorter than
# T: k = N) and its final; an exact-scan chunk; K5 / K6's merge; the IVF
# probe selection, raw final top-k and re-rank pool at k = 10 and 100;
# k-means assignment; the sharded merge; a k above SELECT_CAP.
SELECT_ROUTES = {
    "k2": ((256, 65536), 10),
    "k1_lanes": ((32, 128, 1024), 16),
    "k1_lanes_short": ((8, 128, 8), 16),
    "k1_final": ((32, 2048), 10),
    "exact_chunk": ((8, 65536), 10),
    "k5": ((128, 4096), 10),
    "ivf_probe": ((64, 1232), 16),
    "ivf_final": ((64, 31744), 10),
    "ivf_pool": ((64, 31744), 512),
    "ivf_pool_k100": ((8, 31744), 5100),
    "ivf_assign": ((65536, 1024), 3),
    "sharded": ((256, 40), 10),
    "above_cap": ((2, 20000), 9000),
}


def _same_selection(v, p, s, k):
    """values and positions of the kernel equal to `_select_exact`'s, bit
    for bit"""
    ev, ep = ttopk._select_exact(s, min(k, s.shape[-1]))
    torch.cuda.synchronize()
    assert torch.equal(p, ep)
    assert torch.equal(v.view(torch.int32), ev.view(torch.int32))


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("route", list(SELECT_ROUTES))
def test_select_topk_matches_plain_bit_for_bit(cuda, route, kind):
    shape, k = SELECT_ROUTES[route]
    s = torch.from_numpy(select_scores(shape, kind, 7 * len(route) + len(kind), k)).to(cuda)
    before = _launches()["select_topk"]
    v, p = ttopk.top_k_first(s, k)
    assert ttopk.LAUNCHES["select_topk"] == before + 1
    _same_selection(v, p, s, k)


def test_select_topk_layouts_and_empty(cuda):
    # a transposed (non-contiguous) input as K1's per-lane merge makes it, a
    # bf16 input (values in bf16), misaligned rows (N % 4 != 0), k = 0, N = 0
    x = torch.from_numpy(select_scores((4, 1024, 128), "copies", 3, 16)).to(cuda)
    _same_selection(*ttopk.top_k_first(x.transpose(1, 2), 16), x.transpose(1, 2), 16)
    xb = torch.from_numpy(select_scores((8, 5000), "few", 4)).to(cuda).bfloat16()
    v, p = ttopk.top_k_first(xb, 50)
    assert v.dtype == torch.bfloat16
    _same_selection(v.float(), p, xb.float(), 50)
    xo = torch.from_numpy(select_scores((16, 70001), "random", 5)).to(cuda)
    _same_selection(*ttopk.top_k_first(xo[:, 1:], 10), xo[:, 1:], 10)
    before = _launches()["select_topk"]
    for s, k in ((xo, 0), (xo[:, :0], 5), (xo[:0], 5)):
        v, p = ttopk.top_k_first(s, k)
        assert v.numel() == 0 and p.dtype == torch.int64
    assert ttopk.LAUNCHES["select_topk"] == before


def test_select_topk_raises_on_bad_cuda_input(cuda):
    s = torch.zeros(64, 4, device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        ttopk._select_topk_cuda(s.t(), 3)
    with pytest.raises(ValueError):  # k above n
        ttopk._select_topk_cuda(s, 5)
    with pytest.raises(TypeError):
        ttopk._select_topk_cuda(s.double(), 3)
    with pytest.raises(TypeError):  # no integer scores on the card
        ttopk.top_k_first(s.long(), 3)


def test_select_topk_launches_on_every_route(cuda, monkeypatch):
    """Every selection of a route on the card is select_topk: the flat scans
    (exact, K1 twice: per-lane merge then final, K2, K5, K6, the lane
    scan), IVF raw and PQ, the sharded merge and the engine."""
    import tostore_tpu_torch as P
    from tostore_tpu_torch.parallel import ShardedFlatIndex

    monkeypatch.setattr(ttopk, "MIN_FUSED_N", 0)
    tx, alpha, _ = torch_scan_inputs(3, 40, 8192, 256, "bfloat16", "l2", device=cuda)
    q, c, bias = tx[:3]

    def launched(fn):
        before = ttopk.LAUNCHES["select_topk"]
        fn()
        torch.cuda.synchronize()
        return ttopk.LAUNCHES["select_topk"] - before

    assert launched(lambda: ttopk.flat_topk_xla(q, c, bias, alpha, 10)) == 1
    assert launched(lambda: ttopk.fused_flat_topk(q[:8], c, bias, k=10, alpha=alpha)) == 2
    assert launched(lambda: ttopk.fused_flat_topk(q, c, bias, k=10, alpha=alpha)) == 1
    assert launched(lambda: ttopk._fused_group_emit(q, c, bias, k=10, alpha=alpha,
                                                    blk_n=2048)) == 1
    assert launched(lambda: ttopk.pipe_topk(q, c, bias, k=10, alpha=alpha)) == 1
    assert launched(lambda: ttopk.flat_topk_lane(q, c, bias, k=10, alpha=alpha)) == 1
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2000, 64)).astype(np.float32)
    for pq in (0, 8):
        idx = IVFVectorIndex(64, "l2", "bfloat16", num_clusters=8, nprobe=4,
                             min_train_size=100, pq_subspaces=pq, device=cuda)
        idx.upsert(list(range(2000)), x)
        # the probe selection and the final top-k; PQ adds the re-rank pool
        assert launched(lambda: idx.search_arrays(x[:4], 10, mode="probe")) >= (3 if pq else 2)
    sh = ShardedFlatIndex(64, _card_mesh(cuda, 2), "l2", "bfloat16")
    sh.upsert(list(range(2000)), x)
    # at least each cell's scan, then one merge a dp row
    assert launched(lambda: sh.search_arrays(x[:4], 10)) >= 4 + 2
    db = P.ToStoreTPU.memory(schemas=[_engine_schema(P, "docs", "bfloat16", index_type="flat")],
                             device=str(cuda))
    try:
        db.batch_insert("docs", [{"price": 1.0, "emb": np.resize(x[i], 256)} for i in range(300)])
        assert launched(lambda: db.vector_search("docs", "emb", np.resize(x[7], 256),
                                                 top_k=3)) >= 1
    finally:
        db.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("b", [1, 8, 32, 256])
def test_flat_scans_need_no_host_sync(cuda, dtype, b):
    """K1 (B <= 32) and K2 with their selections, and K5 with its merge,
    under torch.cuda.set_sync_debug_mode("error"): no host sync."""
    tx, alpha, _ = torch_scan_inputs(b + 2, b, 16384, 256, dtype, "l2", device=cuda)
    calls = [lambda: ttopk.fused_flat_topk(*tx[:3], k=10, alpha=alpha, row_scale=tx[3]),
             lambda: ttopk._fused_group_emit(*tx[:3], k=10, alpha=alpha, blk_n=2048,
                                             row_scale=tx[3])]
    want = [call() for call in calls]  # the first call builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [call() for call in calls]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for (gs, gi), (ws, wi) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(gs, ws)
