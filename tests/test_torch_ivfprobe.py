"""Port parity for the IVF bucket scans: the plain PyTorch versions of K3
(`bucket_probe_scores`) and K4 (`adc_bucket_scores`) in
tostore_tpu_torch.ops.ivfprobe against the JAX package's Pallas kernels,
which run in interpret mode on the CPU. On a CPU tensor the port's
wrappers run exactly these plain versions.

Tolerances (float sums in another order, nothing else):
  - K3: 1e-5 (f32 rows) or 1e-4 (bf16, int8 rows) of max(1, sum_i
    |q_i x_i| * scale), the scale of a dot product's rounding error: a
    score near 0 is a sum that cancelled, and its error does not shrink
    with it. Products are exact in f32 on both sides (bf16 x bf16, int8
    widened).
  - K4: 1e-5 of sum_m |tab[m, code_m]|. Both sides sum the same
    bf16-rounded table entries in f32.
Dead entries (bias NEG_INF) must be dead in both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tostore_tpu.ops import ivfprobe as JI
from tostore_tpu.vector.pq import adc_tables_probed as j_adc_tables_probed
from tostore_tpu_torch.ops import ivfprobe as TI

torch.set_num_threads(1)

NEG_INF = float(np.finfo(np.float32).min)
TOL = {"float32": 1e-5, "bfloat16": 1e-4, "int8": 1e-4}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
C, CAP, D, P = 6, 256, 128, 3


def _dead_bias(rng, base):
    dead = rng.random(base.shape) < 0.05
    dead[:, CAP - 40 :] = True  # partly filled buckets
    return np.where(dead, NEG_INF, base).astype(np.float32)


def _assert_scores(got, want, lim):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    live = want > NEG_INF / 2
    assert np.array_equal(got > NEG_INF / 2, live)
    err = np.abs(got - want)[live]
    assert (err <= np.asarray(lim)[live]).all(), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["dot", "l2", "cosine"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_bucket_probe_plain_matches_pallas(dtype, metric, b):
    rng = np.random.default_rng(len(dtype) * 100 + len(metric) * 10 + b)
    scale = None
    if dtype == "int8":
        v = rng.integers(-127, 128, (C, CAP, D)).astype(np.int8)
        scale = (rng.uniform(0.5, 1.5, (C, CAP)) / 127).astype(np.float32)
        xf = v.astype(np.float32) * scale[:, :, None]
    else:
        v = rng.standard_normal((C, CAP, D)).astype(np.float32)
        if metric == "cosine":
            v /= np.linalg.norm(v, axis=2, keepdims=True)
        xf = np.asarray(jnp.asarray(v, JDT[dtype]).astype(jnp.float32))
    base = -np.sum(xf * xf, axis=2) if metric == "l2" else np.zeros((C, CAP), np.float32)
    bias = _dead_bias(rng, base)
    q = rng.standard_normal((b, D)).astype(np.float32)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= 2.0 if metric == "l2" else 1.0  # alpha folded in
    probes = rng.integers(0, C, (b, P)).astype(np.int32)

    qdt = "float32" if dtype == "float32" else "bfloat16"
    jq = jnp.asarray(q, JDT[qdt])
    want = JI.bucket_probe_scores(
        jq, jnp.asarray(probes), jnp.asarray(v, JDT[dtype]), jnp.asarray(bias),
        None if scale is None else jnp.asarray(scale))
    tq = torch.tensor(q).to(TDT[qdt])
    tv = torch.tensor(v).to(TDT[dtype])
    tscale = None if scale is None else torch.tensor(scale)
    got = TI.bucket_probe_scores(tq, torch.tensor(probes), tv, torch.tensor(bias), tscale)
    assert got.shape == (b, P, CAP) and got.dtype == torch.float32
    mag = TI._bucket_probe_scores_plain(tq.abs(), torch.tensor(probes), tv.abs(),
                                        torch.zeros(C, CAP), tscale)
    _assert_scores(got.numpy(), np.asarray(want), TOL[dtype] * np.maximum(1.0, mag.numpy()))


@pytest.mark.parametrize("m,k,packed", [(4, 256, False), (8, 16, False), (16, 16, True)])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_adc_plain_matches_pallas(m, k, packed, metric, b):
    rng = np.random.default_rng(m * 1000 + k + b + len(metric))
    d = 64
    cb = rng.standard_normal((m, k, d // m)).astype(np.float32)
    cents = rng.standard_normal((C, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    probes = rng.integers(0, C, (b, P)).astype(np.int32)
    tabs, _ = j_adc_tables_probed(jnp.asarray(cb), jnp.asarray(q), jnp.asarray(cents),
                                  jnp.asarray(probes), metric=metric)
    tabs = np.asarray(tabs)
    codes = rng.integers(0, 256 if packed else k, (C, m // 2 if packed else m, CAP))
    codes = codes.astype(np.uint8)
    bias = _dead_bias(rng, np.zeros((C, CAP), np.float32))
    assert JI.adc_kernel_supported(m, k) and TI.adc_kernel_supported(m, k)
    want = JI.adc_bucket_scores(jnp.asarray(tabs), jnp.asarray(probes), jnp.asarray(codes),
                                jnp.asarray(bias))
    got = TI.adc_bucket_scores(torch.tensor(tabs), torch.tensor(probes), torch.tensor(codes),
                               torch.tensor(bias))
    assert got.shape == (b, P, CAP)
    mag = -TI._adc_bucket_scores_plain(TI.round_tables(torch.tensor(tabs)).abs(),
                                       torch.tensor(probes), torch.tensor(codes),
                                       torch.zeros(C, CAP))
    _assert_scores(got.numpy(), np.asarray(want), 1e-5 * mag.numpy())


def test_adc_rounds_tables_to_bf16():
    # the wrapper rounds the tables as the Pallas kernel does: f32 tables
    # within half a bf16 step of the same bf16 values give the same scores
    rng = np.random.default_rng(9)
    tabs = TI.round_tables(torch.tensor(rng.standard_normal((2, 2, 8, 16)).astype(np.float32)))
    nudged = tabs * (1 + 2.0**-12)
    assert not torch.equal(nudged, tabs)
    codes = torch.tensor(rng.integers(0, 16, (3, 8, 40)).astype(np.uint8))
    probes = torch.tensor([[0, 2], [1, 1]], dtype=torch.int32)
    bias = torch.zeros(3, 40)
    a = TI.adc_bucket_scores(tabs, probes, codes, bias)
    assert torch.equal(a, TI.adc_bucket_scores(nudged, probes, codes, bias))
    assert torch.equal(a, TI._adc_bucket_scores_plain(TI.round_tables(tabs), probes, codes,
                                                      bias))


def test_unpack_nibbles_inverts_packing():
    from tostore_tpu_torch.vector.ivf import IVFVectorIndex

    codes = torch.tensor(np.random.default_rng(1).integers(0, 16, (50, 12)).astype(np.uint8))
    packed = IVFVectorIndex._pack_codes(codes)  # [N, M/2]
    assert torch.equal(TI._unpack_nibbles(packed.t()[None])[0].t(), codes)


@pytest.mark.parametrize("m,k", [(8, 16), (16, 16), (4, 256), (3, 256), (12, 64), (6, 48),
                                 (96, 256), (192, 16), (5, 16)])
def test_adc_kernel_supported_matches(m, k):
    assert TI.adc_kernel_supported(m, k) == JI.adc_kernel_supported(m, k)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        TI.adc_bucket_scores(torch.zeros(1, 1, 8, 16), torch.zeros(1, 1, dtype=torch.int32),
                             torch.zeros(2, 3, 10, dtype=torch.uint8), torch.zeros(2, 10))
