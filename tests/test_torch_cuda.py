"""The port's CUDA kernels on the card: K1 (`lane_topk_acc`) and K2
(`lane_topk_emit`) against their plain PyTorch versions on the same CUDA
tensors, and the flat index on the card against the same index on the CPU.

Every test needs an NVIDIA GPU (marker `cuda`) and skips without one. This
file imports no JAX, so it runs on a machine without it; tests/conftest.py
imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are stated in tests/torch_parity.py.
"""

import numpy as np
import pytest
import torch

import tostore_tpu_torch.ops.topk as ttopk
from tostore_tpu_torch import FlatVectorIndex
from torch_parity import TOL, assert_topk_match, torch_scan_inputs

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
@pytest.mark.parametrize("b", [1, 7, 32])
def test_k1_matches_plain(cuda, dtype, metric, b):
    tx, alpha, _ = torch_scan_inputs(b, b, 16384, 256, dtype, metric, device=cuda)
    before = _launches()
    ks, ki = ttopk.fused_flat_topk(*tx[:3], k=10, alpha=alpha, row_scale=tx[3])
    assert ttopk.LAUNCHES["lane_topk_acc"] == before["lane_topk_acc"] + 1
    ps, pi = ttopk._fused_flat_topk_plain(*tx[:3], k=10, alpha=alpha, row_scale=tx[3])
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,n", [(40, 16384), (256, 8192)])
def test_k2_matches_plain(cuda, dtype, b, n):
    tx, alpha, _ = torch_scan_inputs(b + n, b, n, 256, dtype, "l2", device=cuda)
    before = _launches()
    ks, ki = ttopk._fused_block_emit(*tx[:3], k=10, alpha=alpha, blk_n=4096,
                                     row_scale=tx[3])
    assert ttopk.LAUNCHES["lane_topk_emit"] == before["lane_topk_emit"] + 1
    ps, pi = ttopk._fused_block_emit_plain(*tx[:3], k=10, alpha=alpha, blk_n=4096,
                                           row_scale=tx[3])
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 8, 32, 40])
def test_kernels_fold_several_blocks_per_cta(cuda, monkeypatch, dtype, b):
    """Three blocks per CTA and a shorter last split, as a large corpus
    gives: K1 folds later blocks into its running lists and both kernels'
    copy ring crosses block boundaries."""
    monkeypatch.setattr(ttopk, "_split_plan",
                        lambda corpus, n_blocks, b_tiles: (3, -(-n_blocks // 3)))
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
    before = _launches()
    ks, ki = kernel(*tx[:3], k=10, alpha=alpha, row_scale=tx[3], **kw)
    assert ttopk.LAUNCHES[name] == before[name] + 1
    ps, pi = plain(*tx[:3], k=10, alpha=alpha, row_scale=tx[3], **kw)
    torch.cuda.synchronize()
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL[dtype])


def test_k1_k_above_candidates_and_all_invalid(cuda):
    tx, alpha, _ = torch_scan_inputs(3, 3, 4096, 128, "float32", "dot", device=cuda)
    k = ttopk.MAX_T_CANDS * 128 + 10
    ks, ki = ttopk.fused_flat_topk(*tx[:3], k=k, alpha=alpha)
    ps, pi = ttopk._fused_flat_topk_plain(*tx[:3], k=k, alpha=alpha)
    assert_topk_match(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), TOL["float32"])
    bias = torch.full_like(tx[2], ttopk.NEG_INF)
    ks, _ = ttopk.fused_flat_topk(tx[0], tx[1], bias, k=5)
    assert bool((ks <= ttopk.NEG_INF / 2).all())


def test_wrapper_raises_on_bad_cuda_input(cuda):
    c = torch.zeros(3000, 128, device=cuda)
    with pytest.raises(ValueError):
        ttopk.fused_flat_topk(torch.zeros(2, 128, device=cuda), c,
                              torch.zeros(3000, device=cuda), k=5)


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
