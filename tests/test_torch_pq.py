"""Port parity for product quantization: tostore_tpu_torch.vector.pq
against tostore_tpu.vector.pq, on the same numpy-seeded inputs (mirrors
TestPQ of tests/test_vector_indexes.py).

Tolerances:
  - codebooks within 1e-4 (absolute, values of order 1): both packages
    draw the same sample and initial centroids from numpy's seeded RNG;
    the Lloyd sums differ only in summation order (one-hot matmul in JAX,
    scatter-add here), unless a point sits on a near-tie between two
    centroids, which these seeds avoid;
  - codes equal except at near-ties: where the packages pick different
    codes, the two codes' distances differ by at most 1e-4 relative;
  - ADC tables and scans within 1e-5 of max(1, |value|) (f32, summation
    order only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tostore_tpu.vector import pq as JP
from tostore_tpu_torch.vector import pq as TP

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, want, tol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("dims", [8, 32, 64, 96, 100, 128, 768, 2048])
def test_auto_subspaces(dims):
    assert TP.auto_subspaces(dims) == JP.auto_subspaces(dims)


@pytest.mark.parametrize("n,d,m,k", [
    (1000, 64, 8, 64),     # sample = all rows
    (3000, 32, 8, 16),     # above the 2500-row sample cap
    (500, 32, 4, 32),
    (20, 16, 4, 32),       # k > n: centroids repeated up to K
])
def test_train_pq_codebooks_match(n, d, m, k):
    x = np.random.default_rng(n + d).standard_normal((n, d)).astype(np.float32)
    jcb = JP.train_pq(x, m=m, k=k, iters=8)
    tcb = TP.train_pq(x, m=m, k=k, iters=8, device="cpu")
    assert (tcb.m, tcb.k, tcb.dsub, tcb.dims) == (jcb.m, jcb.k, jcb.dsub, jcb.dims)
    np.testing.assert_allclose(tcb.codebooks.numpy(), np.asarray(jcb.codebooks), atol=1e-4)
    again = TP.PQCodebook.from_state_dict(tcb.state_dict(), device="cpu")
    assert torch.equal(again.codebooks, tcb.codebooks) and again.dims == d


def test_train_pq_rejects_indivisible_dims():
    with pytest.raises(ValueError):
        TP.train_pq(np.zeros((10, 30), np.float32), m=4, device="cpu")


@pytest.mark.parametrize("m,k", [(8, 64), (16, 16), (4, 256)])
def test_encode_decode_match(m, k):
    rng = np.random.default_rng(m * k)
    d = 64
    x = rng.standard_normal((700, d)).astype(np.float32)
    jcb = JP.train_pq(x, m=m, k=k, iters=4)
    cb = np.asarray(jcb.codebooks)
    jcodes = np.asarray(JP.pq_encode(jcb.codebooks, jnp.asarray(x)))
    tcodes = TP.pq_encode(_t(cb), _t(x)).numpy()
    assert tcodes.dtype == np.uint8 and tcodes.shape == (700, m)
    diff = np.argwhere(tcodes != jcodes)
    for i, sub in diff:  # near-ties only
        xs = x[i].reshape(m, d // m)[sub]
        dj = np.sum((xs - cb[sub, jcodes[i, sub]]) ** 2)
        dt = np.sum((xs - cb[sub, tcodes[i, sub]]) ** 2)
        assert abs(dj - dt) <= 1e-4 * max(1.0, dj), (i, sub, dj, dt)
    assert len(diff) <= 2
    _close(TP.pq_decode(_t(cb), torch.tensor(jcodes)).numpy(),
           np.asarray(JP.pq_decode(jcb.codebooks, jnp.asarray(jcodes))))


def test_encode_decode_reduces_error():
    rng = np.random.default_rng(42)
    x = rng.standard_normal((1000, 64)).astype(np.float32)
    cb = TP.train_pq(x, m=8, k=64, iters=8, device="cpu")
    codes = TP.pq_encode(cb.codebooks, _t(x))
    rec = TP.pq_decode(cb.codebooks, codes).numpy()
    err = np.mean(np.sum((x - rec) ** 2, axis=1)) / np.mean(np.sum(x**2, axis=1))
    assert err < 0.6


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_adc_tables_scan_search_match(metric):
    rng = np.random.default_rng(3)
    d, m, k, n = 64, 16, 32, 900
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((5, d)).astype(np.float32)
    jcb = JP.train_pq(x, m=m, k=k, iters=4)
    cb = np.asarray(jcb.codebooks)
    jtab = np.asarray(JP.adc_tables(jcb.codebooks, jnp.asarray(q), metric=metric))
    ttab = TP.adc_tables(_t(cb), _t(q), metric=metric)
    _close(ttab.numpy(), jtab)
    codes = np.asarray(JP.pq_encode(jcb.codebooks, jnp.asarray(x)))
    jscan = np.asarray(JP.adc_scan(jnp.asarray(jtab), jnp.asarray(codes)))
    tscan = TP.adc_scan(torch.tensor(jtab), torch.tensor(codes))
    _close(tscan.numpy(), jscan)
    bias = np.where(rng.random(n) < 0.05, np.finfo(np.float32).min, 0).astype(np.float32)
    jd, ji = JP.adc_search(jcb, jnp.asarray(codes), jnp.asarray(q), 20, metric=metric,
                           bias=jnp.asarray(bias))
    td, ti = TP.adc_search(TP.PQCodebook(_t(cb), d), torch.tensor(codes), _t(q), 20,
                           metric=metric, bias=torch.tensor(bias))
    assert ti.dtype == torch.int32
    _close(td.numpy(), np.asarray(jd))
    # equal ADC sums order by index in both (lax.top_k's tie order)
    same = np.isclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5).all(axis=1)
    for row in np.flatnonzero(same):
        assert set(ti[row].tolist()) == set(np.asarray(ji)[row].tolist())


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_adc_tables_probed_match(metric):
    rng = np.random.default_rng(4)
    d, m, k, c = 32, 8, 16, 12
    cb = rng.standard_normal((m, k, d // m)).astype(np.float32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    cents = rng.standard_normal((c, d)).astype(np.float32)
    probes = rng.integers(0, c, (3, 5)).astype(np.int32)
    jt, jo = JP.adc_tables_probed(jnp.asarray(cb), jnp.asarray(q), jnp.asarray(cents),
                                  jnp.asarray(probes), metric=metric)
    tt, to = TP.adc_tables_probed(_t(cb), _t(q), _t(cents), torch.tensor(probes),
                                  metric=metric)
    assert tuple(tt.shape) == (3, 5, m, k) and tuple(to.shape) == (3, 5)
    _close(tt.numpy(), np.asarray(jt))
    _close(to.numpy(), np.asarray(jo))


def test_adc_recall_vs_exact():
    rng = np.random.default_rng(42)
    n, d, k = 2000, 64, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    cb = TP.train_pq(x, m=16, k=128, iters=8, device="cpu")
    codes = TP.pq_encode(cb.codebooks, _t(x))
    q = rng.standard_normal((4, d)).astype(np.float32)
    _, idx = TP.adc_search(cb, codes, _t(q), 50, metric="l2")
    ref = np.argsort(np.linalg.norm(q[:, None] - x[None], axis=-1), axis=-1)[:, :k]
    for arow, rrow in zip(idx.numpy(), ref):
        assert len(set(arow.tolist()) & set(rrow.tolist())) >= 6


def test_deterministic_seeded():
    x = np.random.default_rng(42).standard_normal((500, 32)).astype(np.float32)
    c1 = TP.train_pq(x, m=4, k=32, seed=42, device="cpu")
    c2 = TP.train_pq(x, m=4, k=32, seed=42, device="cpu")
    assert torch.equal(c1.codebooks, c2.codebooks)


def test_kmeans_bf16_compute_matches():
    # the coarse quantizer's Lloyd loop: bf16 products, f32 output
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((1024, 64)) * 2).astype(np.float32)
    init = rng.choice(1024, 24, replace=False).astype(np.int32)
    jc = JP._kmeans_all_subspaces(jnp.asarray(x)[None], jnp.asarray(init)[None], k=24,
                                  iters=6, compute_dtype=jnp.bfloat16)
    tc = TP._kmeans_all_subspaces(_t(x)[None], torch.tensor(init)[None], k=24, iters=6,
                                  compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
