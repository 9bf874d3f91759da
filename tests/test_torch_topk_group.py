"""Port parity for K5 and K6's paths: tostore_tpu_torch.ops.topk's
`_fused_group_emit` (per-(group of gsz blocks, lane) top-2, kernel K5) and
`pipe_topk` (the same candidates with the scoring pipelined against the
selection, kernel K6) against the JAX package's `topk._fused_group_emit`
(Pallas in interpret mode) and `experiments/_exp_pipe.py::pipe_topk` (under
`pltpu.force_tpu_interpret_mode()`). On these CPU tensors the port runs
the plain versions the kernels are held to on the card. Mirrors
tests/test_ops_topk.py::TestGroupEmit; tolerances in tests/torch_parity.py
(f32 scores within 1e-5; indices equal as sets outside near-ties).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tostore_tpu.ops.topk as jtopk
import tostore_tpu_torch.ops.topk as ttopk
from torch_parity import NEG_INF, TOL, assert_topk_match, scan_inputs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def exp_pipe():
    """experiments/_exp_pipe.py, loaded without keeping the persistent
    compile cache it configures at import."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    old = {key: getattr(jax.config, key) for key in keys}
    spec = importlib.util.spec_from_file_location("_exp_pipe",
                                                  REPO / "experiments" / "_exp_pipe.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for key, value in old.items():
            jax.config.update(key, value)
    assert all(getattr(jax.config, key) == old[key] for key in keys)
    return mod


def _both(seed, b, n, dtype="float32", metric="dot", scale=True):
    jx, tx, alpha = scan_inputs(seed, b, n, 128, dtype, metric)
    if not scale:
        jx, tx = jx[:3] + (None,), tx[:3] + (None,)
    return jx, tx, alpha


def _group(args, alpha, **kw):
    mod = jtopk if isinstance(args[0], jax.Array) else ttopk
    return mod._fused_group_emit(args[0], args[1], args[2], alpha=alpha, row_scale=args[3], **kw)


def test_k2_gsz1_is_exact():
    # k = 2 and one block per group: unconditionally exact
    jx, tx, alpha = _both(1, 40, 4096)
    js, ji = _group(jx, alpha, k=2, blk_n=2048, gsz=1)
    ts, ti = _group(tx, alpha, k=2, blk_n=2048, gsz=1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    q, c = tx[0].double().numpy(), tx[1].double().numpy()
    full = q @ c.T + tx[2].double().numpy()[None, :]
    np.testing.assert_array_equal(ti.numpy(), np.argsort(-full, axis=1, kind="stable")[:, :2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_partial_last_group(dtype):
    # 5 blocks, gsz = 2: three groups, the last of one block
    jx, tx, alpha = _both(2, 64, 5 * 2048, dtype, "l2")
    js, ji = _group(jx, alpha, k=10, blk_n=2048, gsz=2)
    ts, ti = _group(tx, alpha, k=10, blk_n=2048, gsz=2)
    assert ti.dtype == torch.int64 and tuple(ts.shape) == (64, 10)
    assert_topk_match(ts, ti, js, ji, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mask_and_row_scale(dtype):
    jx, tx, alpha = _both(3, 16, 4 * 2048, dtype, "dot")
    rng = np.random.default_rng(3)
    dead = rng.choice(4 * 2048, 500, replace=False)
    bias = tx[2].clone()
    bias[torch.from_numpy(dead)] = NEG_INF
    scale = torch.from_numpy((0.5 + rng.random(4 * 2048)).astype(np.float32))
    if dtype == "int8":
        scale = tx[3]
    jx = (jx[0], jx[1], jnp.asarray(bias.numpy()), jnp.asarray(scale.numpy()))
    tx = (tx[0], tx[1], bias, scale)
    js, ji = _group(jx, alpha, k=4, blk_n=2048, gsz=2)
    ts, ti = _group(tx, alpha, k=4, blk_n=2048, gsz=2)
    assert_topk_match(ts, ti, js, ji, TOL[dtype])
    assert not set(ti.flatten().tolist()) & set(dead.tolist())


def test_odd_batch_default_gsz():
    jx, tx, alpha = _both(4, 33, 2 * 2048, "bfloat16", "cosine")  # pads to 40
    js, ji = _group(jx, alpha, k=3, blk_n=2048)
    ts, ti = _group(tx, alpha, k=3, blk_n=2048)
    assert tuple(ts.shape) == (33, 3)
    assert_topk_match(ts, ti, js, ji, TOL["bfloat16"])


def test_every_candidate_with_dead_lanes():
    # k = every candidate: the whole per-(group, lane) top-2 set, with most
    # rows dead so that many lanes keep the NEG_INF start value
    n, gsz = 6 * 2048, 4
    jx, tx, alpha = _both(5, 8, n, scale=False)
    rng = np.random.default_rng(5)
    bias = np.where(rng.random(n) < 0.97, NEG_INF, 0.0).astype(np.float32)
    jx = (jx[0], jx[1], jnp.asarray(bias), None)
    tx = (tx[0], tx[1], torch.from_numpy(bias), None)
    k = 2 * 128 * 2  # two groups
    js, ji = _group(jx, alpha, k=k, blk_n=2048, gsz=gsz)
    ts, ti = _group(tx, alpha, k=k, blk_n=2048, gsz=gsz)
    assert_topk_match(ts, ti, js, ji, TOL["float32"])


def test_plain_candidates_are_per_group_lane_top2():
    rng = np.random.default_rng(6)
    n, blk, gsz = 5 * 256, 256, 2  # 5 blocks of 2 rows per lane
    s = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    eye = torch.eye(n)
    cs, ci = ttopk._group_cands_plain(s, eye, torch.zeros(n), None, 1.0, blk, gsz)
    assert tuple(cs.shape) == (3, 3 * 256)
    for b in range(3):
        for g in range(3):
            rows = np.arange(g * gsz * blk, min(n, (g + 1) * gsz * blk))
            for lane in (0, 5, 127):
                lr = rows[rows % 128 == lane]
                want = sorted(s[b, lr].tolist(), reverse=True)[:2]
                got = cs[b, g * 256 + lane], cs[b, g * 256 + 128 + lane]
                assert [float(x) for x in got] == want
                idx = ci[b, g * 256 + lane], ci[b, g * 256 + 128 + lane]
                assert [float(s[b, int(i)]) for i in idx] == want


@pytest.mark.parametrize("dtype,gsz", [("float32", None), ("bfloat16", 4), ("int8", 2)])
def test_pipe_topk_matches_reference(exp_pipe, dtype, gsz):
    jx, tx, alpha = _both(7, 16, 4 * 2048, dtype, "l2", scale=False)
    with pltpu.force_tpu_interpret_mode():
        js, ji = exp_pipe.pipe_topk(jx[0], jx[1], jx[2], k=10, alpha=alpha, gsz=gsz)
    ts, ti = ttopk.pipe_topk(tx[0], tx[1], tx[2], k=10, alpha=alpha, gsz=gsz)
    assert tuple(ts.shape) == (16, 10) and ti.dtype == torch.int64
    assert_topk_match(ts, ti, js, ji, TOL[dtype])
    # the pipelined form's candidates are K5's at the same gsz
    gs, gi = ttopk._fused_group_emit(tx[0], tx[1], tx[2], k=10, alpha=alpha, blk_n=2048,
                                     gsz=gsz or 2)
    assert torch.equal(ts, gs) and torch.equal(ti, gi)


@pytest.mark.parametrize("n_blocks,gsz", [(4, 1), (4, 3), (3, None), (1, None)])
def test_pipe_topk_rejects_bad_groups(n_blocks, gsz):
    with pytest.raises(ValueError):
        ttopk.pipe_topk(torch.zeros(2, 128), torch.zeros(n_blocks * 2048, 128),
                        torch.zeros(n_blocks * 2048), k=5, gsz=gsz)


def test_group_emit_rejects_unpadded():
    with pytest.raises(ValueError):
        ttopk._fused_group_emit(torch.zeros(1, 128), torch.zeros(3000, 128), torch.zeros(3000),
                                k=5, alpha=1.0, blk_n=2048)
