"""Port parity for K1's path: tostore_tpu_torch.ops.topk.fused_flat_topk
(B <= 32, running per-lane top-T) against tostore_tpu's Pallas
`fused_flat_topk` in interpret mode. On these CPU tensors the port runs
`_fused_flat_topk_plain`, the plain version K1 is held to on the card.
Mirrors tests/test_ops_topk.py TestFusedTopK; tolerances in
tests/torch_parity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tostore_tpu.ops.topk as jtopk
import tostore_tpu_torch.ops.topk as ttopk
from torch_parity import NEG_INF, TOL, assert_topk_match, scan_inputs

torch.set_num_threads(1)


# every (dtype, metric) pair once, with B, N and k spread over the cases;
# N = 4096 and 8192 give 2 and 4 blocks, so per-lane buckets collide
@pytest.mark.parametrize("dtype,metric,b,n,k", [
    ("float32", "dot", 1, 4096, 10),
    ("float32", "l2", 7, 8192, 1),
    ("float32", "cosine", 32, 8192, 10),
    ("bfloat16", "dot", 32, 4096, 1),
    ("bfloat16", "l2", 1, 8192, 10),
    ("bfloat16", "cosine", 7, 4096, 10),
    ("int8", "dot", 7, 8192, 10),
    ("int8", "l2", 32, 4096, 10),
    ("int8", "cosine", 1, 8192, 1),
])
def test_fused_flat_topk(dtype, metric, b, n, k):
    jx, tx, alpha = scan_inputs(100 + b + n, b, n, 128, dtype, metric)
    js, ji = jtopk.fused_flat_topk(jx[0], jx[1], jx[2], k=k, alpha=alpha, row_scale=jx[3])
    ts, ti = ttopk.fused_flat_topk(tx[0], tx[1], tx[2], k=k, alpha=alpha, row_scale=tx[3])
    assert tuple(ts.shape) == (b, k) and ti.dtype == torch.int64
    assert_topk_match(ts, ti, js, ji, TOL[dtype])


def test_k_above_candidate_width():
    # T = 16 lists x 128 lanes = 2048 candidates < k: pads NEG_INF / 0
    k = ttopk.MAX_T_CANDS * 128 + 52
    jx, tx, alpha = scan_inputs(120, 2, 4096, 128, "float32", "dot")
    js, ji = jtopk.fused_flat_topk(jx[0], jx[1], jx[2], k=k, alpha=alpha)
    ts, ti = ttopk.fused_flat_topk(tx[0], tx[1], tx[2], k=k, alpha=alpha)
    assert_topk_match(ts, ti, js, ji, TOL["float32"])
    assert np.all(ts[:, 2048:].numpy() == NEG_INF)


def test_all_invalid_bias():
    jx, tx, alpha = scan_inputs(121, 2, 2048, 128, "float32", "dot")
    bias = np.full(2048, NEG_INF, np.float32)
    js, _ = jtopk.fused_flat_topk(jx[0], jx[1], jnp.asarray(bias), k=5)
    ts, _ = ttopk.fused_flat_topk(tx[0], tx[1], torch.from_numpy(bias), k=5)
    assert np.all(np.asarray(js) <= NEG_INF / 2)
    assert np.all(ts.numpy() <= NEG_INF / 2)


def test_plain_candidates_are_per_lane_top_t():
    # the running top-T of the plain version: per lane, the T best of all
    # blocks' top-2, sorted, t-major layout
    rng = np.random.default_rng(122)
    n, blk = 8192, 2048
    s = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    cs, ci = ttopk._lane_top2(s, blk)
    ts, ti = ttopk._running_top_t(cs, ci, 8)
    for b in range(3):
        for lane in (0, 77, 127):
            rows = np.arange(lane, n, 128)
            per_block = [sorted(s[b, rows[j * 16:(j + 1) * 16]].tolist())[-2:]
                         for j in range(n // blk)]
            want = sorted(sum(per_block, []), reverse=True)[:8]
            got = ts[b].view(8, 128)[:, lane].tolist()
            assert got == want[:len(got)] + [NEG_INF] * (8 - len(want))
            assert np.all(ti[b].view(8, 128)[:, lane].numpy() % 128 == lane)


def test_rejects_unpadded():
    with pytest.raises(ValueError):
        ttopk.fused_flat_topk(torch.zeros(1, 128), torch.zeros(1000, 128),
                              torch.zeros(1000), k=5)
