"""Port parity: tostore_tpu_torch.ops.distance against tostore_tpu.ops.distance,
every function, for each metric, including the miss mapping. Mirrors
tests/test_ops_topk.py TestDistanceHelpers. Tolerances in
tests/torch_parity.py (element-wise f32 arithmetic: 1e-6 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tostore_tpu.ops.distance as jd
import tostore_tpu_torch.ops.distance as td
from tostore_tpu_torch.ops import runtime as trt
from torch_parity import NEG_INF, TOL, assert_scores_close

torch.set_num_threads(1)

METRICS = ["dot", "l2", "cosine"]


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def test_constants_match():
    from tostore_tpu.ops import runtime as jrt

    assert trt.NEG_INF == jrt.NEG_INF and trt.NEG_INF != float("-inf")
    assert (trt.LANE, trt.ROW_BLOCK) == (jrt.LANE, jrt.ROW_BLOCK)
    assert trt.round_up(1000, 128) == jrt.round_up(1000, 128) == 1024
    assert jd.METRICS == td.METRICS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_norms_and_normalize(dtype):
    x = np.random.default_rng(0).standard_normal((8, 96)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert_scores_close(td.l2_norms(tx).numpy(), np.asarray(jd.l2_norms(jx)), 1e-6)
    tn, jn = td.normalize(tx), jd.normalize(jx)
    assert tn.dtype == tx.dtype
    assert_scores_close(tn.float().numpy(), np.asarray(jn, np.float32), TOL[dtype])


@pytest.mark.parametrize("metric", METRICS)
def test_make_bias_and_alpha(metric):
    rng = np.random.default_rng(1)
    norms = rng.random(64).astype(np.float32) * 10
    valid = rng.random(64) > 0.2
    jb = jd.make_bias(metric, jnp.asarray(norms), jnp.asarray(valid))
    tb = td.make_bias(metric, torch.from_numpy(norms), torch.from_numpy(valid))
    assert tb.dtype == torch.float32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert np.all(tb.numpy()[~valid] == NEG_INF)
    assert td.metric_alpha(metric) == jd.metric_alpha(metric)


def test_make_bias_l2_requires_norms():
    with pytest.raises(ValueError):
        td.make_bias("l2", None, torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_score_matrix(metric, dtype):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    c = rng.standard_normal((16, 64)).astype(np.float32)
    norms = np.einsum("ij,ij->i", c, c).astype(np.float32)
    alpha = jd.metric_alpha(metric)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jb = jd.make_bias(metric, jnp.asarray(norms), jnp.ones(16, bool))
    tb = td.make_bias(metric, torch.from_numpy(norms), torch.ones(16, dtype=torch.bool))
    js = jd.score_matrix(jnp.asarray(q), jnp.asarray(c, jdt), jb, alpha)
    ts = td.score_matrix(torch.from_numpy(q), torch.from_numpy(c).to(tdt), tb, alpha)
    assert_scores_close(ts.numpy(), np.asarray(js), TOL[dtype])


@pytest.mark.parametrize("metric", METRICS)
def test_scores_to_distances_and_finalize(metric):
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((3, 6)).astype(np.float32) * 5
    scores[1, 4:] = NEG_INF  # misses
    scores[2, 5] = NEG_INF / 2  # the boundary counts as a miss
    qsq = (rng.random(3) * 40 + 30).astype(np.float32)
    slots = rng.integers(0, 1000, (3, 6)).astype(np.int64)
    js_, ts_ = _pair(scores)
    jq, tq = _pair(qsq)
    hit = scores > NEG_INF / 2
    assert_scores_close(
        td.scores_to_distances(metric, ts_, tq).numpy()[hit],
        np.asarray(jd.scores_to_distances(metric, js_, jq))[hit], 1e-6)
    np.testing.assert_allclose(
        td.scores_to_distances_np(metric, scores, qsq),
        jd.scores_to_distances_np(metric, scores, qsq), rtol=1e-6)
    jdist, jslot = jd.finalize_results(metric, js_, jnp.asarray(slots, jnp.int32), jq)
    tdist, tslot = td.finalize_results(metric, ts_, torch.from_numpy(slots), tq)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    assert np.all(tslot.numpy()[~hit] == -1)
    assert np.all(np.isinf(tdist.numpy()[~hit]))
    assert_scores_close(tdist.numpy()[hit], np.asarray(jdist)[hit], 1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_distances_to_scores(metric):
    d = np.asarray([0.0, 1.0, 3.0, 0.25], np.float32)
    jdd, tdd = _pair(d)
    assert_scores_close(td.distances_to_scores(metric, tdd).numpy(),
                        np.asarray(jd.distances_to_scores(metric, jdd)), 1e-6)


def test_unknown_metric_raises():
    with pytest.raises(ValueError):
        td.scores_to_distances("hamming", torch.zeros(1, 1), torch.zeros(1))
    with pytest.raises(ValueError):
        td.distances_to_scores("hamming", torch.zeros(1))


def test_pad_helpers_numpy_and_torch():
    a = np.ones((3, 5), np.float32)
    assert trt.pad_rows(a, 8, fill=-1).shape == (8, 5)
    t = trt.pad_rows(torch.ones(3, 5), 8, fill=-1)
    assert tuple(t.shape) == (8, 5) and t[7, 0].item() == -1
    t = trt.pad_cols(torch.ones(3, 5), 128)
    assert tuple(t.shape) == (3, 128) and t[:, 5:].abs().sum().item() == 0
    assert trt.pad_cols(a, 128).shape == (3, 128)
    with pytest.raises(ValueError):
        trt.pad_rows(a, 2)
