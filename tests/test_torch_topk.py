"""Port parity: tostore_tpu_torch.ops.topk against tostore_tpu.ops.topk.

Mirrors tests/test_ops_topk.py (TestFusedTopK, TestLanePathXLA) for the
exact path, the lane-candidate path, K2 (`_fused_block_emit`) and the
`flat_search` dispatch; K1 (`fused_flat_topk`, B <= 32) is in
test_torch_topk_fused.py. Inputs come from a numpy seed and go to both
packages; the JAX Pallas kernels run in interpret mode (tests/conftest.py)
and the port runs its plain versions, since these tensors are on the CPU.
Tolerances are stated in tests/torch_parity.py.
"""

import numpy as np
import pytest
import torch

import tostore_tpu.ops.topk as jtopk
import tostore_tpu_torch.ops.topk as ttopk
from tostore_tpu_torch.ops import _kernels
from torch_parity import NEG_INF, TOL, assert_topk_match, scan_inputs

torch.set_num_threads(1)

# (dtype, metric) pairs cycled over the other axes of each case list
_PAIRS = [(dt, m) for dt in ("float32", "bfloat16", "int8")
          for m in ("dot", "l2", "cosine")]


class TestExactPath:
    @pytest.mark.parametrize("dtype,metric", _PAIRS)
    @pytest.mark.parametrize("k", [1, 10])
    def test_flat_topk_xla(self, dtype, metric, k):
        jx, tx, alpha = scan_inputs(1, 5, 3000, 128, dtype, metric)
        js, ji = jtopk.flat_topk_xla(jx[0], jx[1], jx[2], alpha, k, row_scale=jx[3])
        ts, ti = ttopk.flat_topk_xla(tx[0], tx[1], tx[2], alpha, k, row_scale=tx[3])
        assert ts.dtype == torch.float32 and tuple(ti.shape) == (5, k)
        assert_topk_match(ts, ti, js, ji, TOL[dtype])

    @pytest.mark.parametrize("dtype,metric", [("float32", "dot"), ("int8", "l2")])
    def test_chunked_exact(self, dtype, metric, monkeypatch):
        # n > 2 * EXACT_CHUNK and divisible: the chunked branch of both
        monkeypatch.setattr(jtopk, "EXACT_CHUNK", 1024)
        monkeypatch.setattr(ttopk, "EXACT_CHUNK", 1024)
        jx, tx, alpha = scan_inputs(2, 3, 8192, 128, dtype, metric)
        js, ji = jtopk.flat_topk_xla(jx[0], jx[1], jx[2], alpha, 7, row_scale=jx[3])
        ts, ti = ttopk.flat_topk_xla(tx[0], tx[1], tx[2], alpha, 7, row_scale=tx[3])
        assert_topk_match(ts, ti, js, ji, TOL[dtype])

    def test_k_above_n_pads(self):
        jx, tx, alpha = scan_inputs(3, 2, 100, 128, "float32", "dot")
        js, ji = jtopk.flat_topk_xla(jx[0], jx[1], jx[2], alpha, 120)
        ts, ti = ttopk.flat_topk_xla(tx[0], tx[1], tx[2], alpha, 120)
        assert_topk_match(ts, ti, js, ji, TOL["float32"])
        assert np.all(ts[:, 100:].numpy() == NEG_INF)
        assert np.all(ti[:, 100:].numpy() == 0)


class TestLanePath:
    # n=40000: two 16384-row chunks plus a 7232-row remainder (padded to a
    # multiple of 128); n=32768: an even split
    @pytest.mark.parametrize("case", [
        (0, 40000, 5, 1), (1, 32768, 8, 10), (2, 40000, 40, 10),
        (3, 32768, 5, 10), (4, 40000, 8, 1), (5, 32768, 40, 10),
        (6, 40000, 5, 10), (7, 32768, 8, 10), (8, 40000, 40, 1),
    ])
    def test_flat_topk_lane(self, case):
        pair, n, b, k = case
        dtype, metric = _PAIRS[pair]
        jx, tx, alpha = scan_inputs(10 + pair, b, n, 128, dtype, metric)
        js, ji = jtopk.flat_topk_lane(jx[0], jx[1], jx[2], k=k, alpha=alpha, ch=16384,
                                      row_scale=jx[3])
        ts, ti = ttopk.flat_topk_lane(tx[0], tx[1], tx[2], k=k, alpha=alpha, ch=16384,
                                      row_scale=tx[3])
        assert_topk_match(ts, ti, js, ji, TOL[dtype])

    def test_lane_k_above_candidates(self):
        # 2 chunks x 256 candidates = 512 < k
        jx, tx, alpha = scan_inputs(20, 2, 4096, 128, "float32", "dot")
        js, ji = jtopk.flat_topk_lane(jx[0], jx[1], jx[2], k=600, alpha=alpha, ch=2048)
        ts, ti = ttopk.flat_topk_lane(tx[0], tx[1], tx[2], k=600, alpha=alpha, ch=2048)
        assert_topk_match(ts, ti, js, ji, TOL["float32"])

    @pytest.mark.parametrize("b,n", [(1, 1_000_000), (256, 1_000_000), (8, 131072),
                                     (256, 40000), (1000, 2048)])
    def test_lane_chunk_rule(self, b, n):
        assert ttopk._lane_chunk_for(b, n) == jtopk._lane_chunk_for(b, n)


class TestBlockEmit:
    """K2's path: `_fused_block_emit` (B > 32), blk_n 4096 as the reference
    picks it for N % 4096 == 0."""

    @pytest.mark.parametrize("dtype,metric,k", [
        ("float32", "dot", 10), ("bfloat16", "l2", 10), ("int8", "cosine", 1),
    ])
    def test_block_emit(self, dtype, metric, k):
        jx, tx, alpha = scan_inputs(30, 40, 8192, 128, dtype, metric)
        js, ji = jtopk._fused_block_emit(jx[0], jx[1], jx[2], k=k, alpha=alpha,
                                         blk_n=4096, row_scale=jx[3])
        ts, ti = ttopk._fused_block_emit(tx[0], tx[1], tx[2], k=k, alpha=alpha,
                                         blk_n=4096, row_scale=tx[3])
        assert_topk_match(ts, ti, js, ji, TOL[dtype])

    def test_fused_dispatches_emit_above_32(self):
        jx, tx, alpha = scan_inputs(31, 40, 8192, 128, "float32", "l2")
        js, ji = jtopk.fused_flat_topk(jx[0], jx[1], jx[2], k=10, alpha=alpha)
        ts, ti = ttopk.fused_flat_topk(tx[0], tx[1], tx[2], k=10, alpha=alpha)
        assert_topk_match(ts, ti, js, ji, TOL["float32"])

    def test_block_emit_rejects_unpadded(self):
        with pytest.raises(ValueError):
            ttopk.fused_flat_topk(torch.zeros(40, 128), torch.zeros(6000, 128),
                                  torch.zeros(6000), k=5)


class TestDispatch:
    @pytest.mark.parametrize("mode", ["auto", "fused", "exact", "fast"])
    @pytest.mark.parametrize("b", [4, 40])
    def test_flat_search_modes(self, mode, b, monkeypatch):
        # MIN_FUSED_N lowered in both packages so 'auto' takes the fused
        # (B <= 32) and lane (B > 32) paths at a CPU-sized corpus
        monkeypatch.setattr(jtopk, "MIN_FUSED_N", 4096)
        monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)
        jx, tx, alpha = scan_inputs(40, b, 4096, 128, "bfloat16", "dot")
        js, ji = jtopk.flat_search(jx[0], jx[1], jx[2], k=10, alpha=alpha, mode=mode)
        ts, ti = ttopk.flat_search(tx[0], tx[1], tx[2], k=10, alpha=alpha, mode=mode)
        assert_topk_match(ts, ti, js, ji, TOL["bfloat16"])

    def test_dispatch_routes(self, monkeypatch):
        calls = []
        for name in ("flat_topk_xla", "flat_topk_lane", "fused_flat_topk"):
            real = getattr(ttopk, name)
            monkeypatch.setattr(
                ttopk, name,
                lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw),
            )
        monkeypatch.setattr(ttopk, "MIN_FUSED_N", 4096)
        c = torch.randn(4096, 128)
        bias = torch.zeros(4096)
        for b, mode, want in [(8, "auto", "fused_flat_topk"), (40, "auto", "flat_topk_lane"),
                              (8, "fast", "fused_flat_topk"), (40, "fused", "fused_flat_topk"),
                              (8, "exact", "flat_topk_xla")]:
            calls.clear()
            ttopk.flat_search(torch.randn(b, 128), c, bias, k=5, mode=mode)
            assert calls == [want], (b, mode, calls)
        # unaligned corpus, small corpus, or k above 256 -> exact
        for n, k in [(4000, 5), (2048, 5), (4096, 300)]:
            calls.clear()
            ttopk.flat_search(torch.randn(8, 128), torch.randn(n, 128), torch.zeros(n),
                              k=k, mode="auto")
            assert calls == ["flat_topk_xla"], (n, k, calls)


class TestKernelWrapper:
    """What the CUDA wrappers check before a launch, and the build's
    refusal without nvcc; both run without a card."""

    def test_checks_reject_bad_inputs(self):
        c = torch.zeros(4096, 128, dtype=torch.bfloat16)
        q = torch.zeros(8, 128, dtype=torch.bfloat16)
        bias = torch.zeros(4096)
        ttopk._check_kernel_inputs(q, c, bias, None, 2048)  # accepted
        bad = [
            (q.float(), c, bias, None, 2048),  # q not in the score dtype
            (q[:7], c, bias, None, 2048),  # B_pad not a multiple of 8
            (q, c[:3000], bias[:3000], None, 2048),  # N not block-aligned
            (q, c, bias.double(), None, 2048),  # bias not f32
            (q, c, bias, torch.ones(100), 2048),  # row_scale wrong length
            (q, c.t().contiguous().t(), bias, None, 2048),  # not contiguous
            (q.to(torch.float16), c.to(torch.float16), bias, None, 2048),  # dtype
        ]
        for args in bad:
            with pytest.raises((ValueError, TypeError)):
                ttopk._check_kernel_inputs(*args)

    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_kernels, "_lib", None)
        with pytest.raises(RuntimeError, match="nvcc"):
            _kernels.library()

    def test_launch_counters_untouched_on_cpu(self):
        before = dict(ttopk.LAUNCHES)
        jx, tx, alpha = scan_inputs(50, 4, 4096, 128, "float32", "dot")
        ttopk.fused_flat_topk(tx[0], tx[1], tx[2], k=5)
        ttopk.fused_flat_topk(torch.zeros(40, 128), tx[1], tx[2], k=5)
        assert ttopk.LAUNCHES == before
