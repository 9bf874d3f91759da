"""The bucket grouping behind the port's K3 and K4 (tostore_tpu_torch.ops.
ivfprobe): `bucket_groups` sorts the B * P (query, probe) pairs by probe id
so that each bucket is scanned once for all the queries that probe it, and
K4 reads bf16 tables (`_bf16_tables`) with the values of `round_tables`.

The CUDA kernels, and their grouping pre-pass, run on the card only
(tests/test_torch_cuda.py); `_group_pairs_plain` is the pre-pass's plain
version. Here a plain model of the kernels' grouped walk (runs of equal ids, queries in chunks of
64, writes through the pair order, dead runs for ids outside [0, C)) is
held to the plain versions and to the JAX package's Pallas kernels in
interpret mode on probe patterns where queries share buckets. Tolerances
as in tests/test_torch_ivfprobe.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from tostore_tpu.ops import ivfprobe as JI
from tostore_tpu_torch.ops import ivfprobe as TI

torch.set_num_threads(1)

NEG_INF = float(np.finfo(np.float32).min)
C, CAP, D = 5, 200, 128


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 12), st.integers(1, 6), st.integers(0, 2**31 - 1))
def test_bucket_groups_properties(b, p, seed):
    rng = np.random.default_rng(seed)
    probes = torch.tensor(rng.integers(-2, C + 3, (b, p)), dtype=torch.int32)
    ids, order = TI.bucket_groups(probes)
    flat = probes.reshape(-1)
    # every (b, p) pair exactly once, with its own id
    assert sorted(order.tolist()) == list(range(b * p))
    assert torch.equal(ids, flat[order])
    # runs contiguous and ascending, stable (pair order) inside a run
    assert bool((ids[1:] >= ids[:-1]).all())
    same = ids[1:] == ids[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    # ids below 0 first, ids >= C last
    kind = torch.where(ids < 0, 0, torch.where(ids >= C, 2, 1))
    assert bool((kind[1:] >= kind[:-1]).all())


def test_group_pairs_plain_clamps_out_of_range_ids():
    probes = torch.tensor([[3, 2**33, -(2**40)], [-1, C, 2**31 + 1]], dtype=torch.int64)
    ids, order = TI._group_pairs_plain(probes, C)
    assert ids.dtype == torch.int32 and order.dtype == torch.int32
    assert ids.tolist() == [-1, -1, 3, C, C, C]
    assert order.tolist() == [2, 3, 0, 1, 4, 5]


def test_group_pairs_plain_sorts_each_launch_slice(monkeypatch):
    # the kernels' pre-pass sorts each launch's RUN_MAX pairs on their own
    monkeypatch.setattr(TI, "RUN_MAX", 5)
    probes = torch.tensor([[4, 1, 4], [0, 1, 3], [2, 2, 0], [1, 9, -7]], dtype=torch.int32)
    ids, order = TI._group_pairs_plain(probes, C)
    assert ids.tolist() == [0, 1, 1, 4, 4, 0, 1, 2, 2, 3, -1, C]
    assert order.tolist() == [3, 1, 4, 0, 2, 8, 9, 6, 7, 5, 11, 10]


def test_slices_cover_every_pair_once():
    for n in (1, TI.RUN_MAX - 1, TI.RUN_MAX, 2 * TI.RUN_MAX + 5):
        sl = TI._slices(n)
        assert sl[0][0] == 0 and sl[-1][1] == n
        assert all(a1 == b0 and 0 < a1 - a0 <= TI.RUN_MAX for (a0, a1), (b0, _) in
                   zip(sl, sl[1:] + [(n, n)]))


@pytest.mark.parametrize("m,k", [(8, 16), (4, 256), (3, 12), (6, 48)])
@pytest.mark.parametrize("broadcast", [False, True])
def test_bf16_tables_equal_round_tables(m, k, broadcast):
    rng = np.random.default_rng(m * k)
    b, p = 3, 4
    if broadcast:  # a non-residual index: one table per query over P
        tabs = torch.tensor(rng.standard_normal((b, m, k)).astype(np.float32) * 7)
        tabs = tabs[:, None].expand(b, p, m, k)
    else:
        tabs = torch.tensor(rng.standard_normal((b, p, m, k)).astype(np.float32) * 7)
    tb = TI._bf16_tables(tabs)
    assert tb.dtype == torch.bfloat16 and tb.is_contiguous()
    assert tb.shape[1] == (1 if broadcast else p)  # the broadcast is not copied P times
    assert tb.shape[3] % 8 == 0 and tb.shape[3] >= k
    assert bool((tb[..., k:] == 0).all())
    want = TI.round_tables(tabs)
    got = tb[..., :k].float().expand(b, p, m, k)
    assert torch.equal(got, want)  # value for value


# --------------------------------------------------------------------------
# the kernels' grouped walk, modelled in plain PyTorch
# --------------------------------------------------------------------------


def _runs(ids):
    ids = ids.tolist()
    starts = [i for i in range(len(ids)) if i == 0 or ids[i] != ids[i - 1]]
    return list(zip(starts, starts[1:] + [len(ids)]))


def _k3_grouped_model(q, probes, v, bias, scale, chunk=64):
    b, p = probes.shape
    c, cap, _ = v.shape
    out = torch.full((b * p, cap), float("nan"))
    ids, order = TI._group_pairs_plain(probes, c)
    qs = q.float()[order.long() // p]
    for s0, s1 in _runs(ids):
        pid = int(ids[s0])
        if not 0 <= pid < c:
            out[order[s0:s1].long()] = NEG_INF
            continue
        rows = v[pid].float()  # the bucket, read once for the run
        for c0 in range(s0, s1, chunk):
            c1 = min(s1, c0 + chunk)
            s = qs[c0:c1] @ rows.t()
            if scale is not None:
                s = s * scale[pid]
            out[order[c0:c1].long()] = s + bias[pid]
    return out.reshape(b, p, cap)


def _k4_grouped_model(tabs, probes, codes, bias):
    b, p, m, k = tabs.shape
    c, rows, cap = codes.shape
    tb = TI._bf16_tables(tabs)
    out = torch.full((b * p, cap), float("nan"))
    ids, order = TI._group_pairs_plain(probes, c)
    for s0, s1 in _runs(ids):
        pid = int(ids[s0])
        if not 0 <= pid < c:
            out[order[s0:s1].long()] = NEG_INF
            continue
        cd = codes[pid].long()  # the code tile, read once for the run
        if rows * 2 == m:
            cd = TI._unpack_nibbles(cd[None])[0]
        for pair in order[s0:s1].tolist():
            t = tb[pair // p, pair % p if tb.shape[1] > 1 else 0, :, :k].float()
            out[pair] = -torch.gather(t, 1, cd).sum(0) + bias[pid]
    return out.reshape(b, p, cap)


def _patterned(rng, pattern, b, p):
    if pattern == "one_bucket":  # every pair in one bucket: a run of 150
        return np.full((b, p), 2, np.int32)
    if pattern == "shared":  # every query probes the same P buckets
        return np.tile(rng.permutation(C)[:p], (b, 1)).astype(np.int32)
    probes = rng.integers(0, C, (b, p)).astype(np.int32)
    probes[0, 0], probes[-1, -1] = -1, C  # out of range: dead in both
    return probes


def _assert_scores(got, want, lim):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    live = want > NEG_INF / 2
    assert np.array_equal(got > NEG_INF / 2, live)
    assert (np.abs(got - want)[live] <= np.asarray(lim)[live]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pattern", ["one_bucket", "shared", "out_of_range"])
def test_k3_grouped_walk_matches_plain_and_pallas(dtype, pattern):
    rng = np.random.default_rng(len(dtype) + len(pattern))
    b, p = 50, 3
    probes = _patterned(rng, pattern, b, p)
    scale = None
    if dtype == "int8":
        v = torch.tensor(rng.integers(-127, 128, (C, CAP, D)).astype(np.int8))
        scale = torch.tensor((rng.uniform(0.5, 1.5, (C, CAP)) / 127).astype(np.float32))
    else:
        v = torch.tensor(rng.standard_normal((C, CAP, D)).astype(np.float32))
        v = v.to(getattr(torch, dtype))
    bias = rng.uniform(-5, 0, (C, CAP)).astype(np.float32)
    bias[:, CAP - 30:] = NEG_INF
    bias = torch.tensor(bias)
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.tensor(rng.standard_normal((b, D)).astype(np.float32)).to(qdt)
    tp = torch.tensor(probes)
    live = (probes >= 0) & (probes < C)  # the plain and Pallas kernels take ids in range
    tpc = tp.clamp(0, C - 1)
    got = _k3_grouped_model(q, tp, v, bias, scale).numpy()
    assert (got[~live] == NEG_INF).all()
    plain = TI.bucket_probe_scores(q, tpc, v, bias, scale)
    mag = TI._bucket_probe_scores_plain(q.abs(), tpc, v.abs(), torch.zeros(C, CAP),
                                        scale).clamp(min=1.0)
    lim = (1e-5 if dtype == "float32" else 1e-4) * mag.numpy()
    _assert_scores(got[live], plain.numpy()[live], lim[live])
    jv = jnp.asarray(v.float().numpy()).astype({"float32": jnp.float32,
                                                 "bfloat16": jnp.bfloat16,
                                                 "int8": jnp.int8}[dtype])
    want = JI.bucket_probe_scores(
        jnp.asarray(q.float().numpy()).astype(jnp.float32 if dtype == "float32" else
                                               jnp.bfloat16),
        jnp.asarray(tpc.numpy()), jv, jnp.asarray(bias.numpy()),
        None if scale is None else jnp.asarray(scale.numpy()))
    _assert_scores(got[live], np.asarray(want)[live], lim[live])


@pytest.mark.parametrize("m,k,packed", [(8, 256, False), (16, 16, True)])
@pytest.mark.parametrize("pattern", ["one_bucket", "shared", "out_of_range"])
@pytest.mark.parametrize("broadcast", [False, True])
def test_k4_grouped_walk_matches_plain_and_pallas(m, k, packed, pattern, broadcast):
    rng = np.random.default_rng(m + k + len(pattern) + broadcast)
    b, p = 50, 3
    probes = _patterned(rng, pattern, b, p)
    if broadcast:
        tabs = torch.tensor(rng.standard_normal((b, m, k)).astype(np.float32) * 4)
        tabs = tabs[:, None].expand(b, p, m, k)
    else:
        tabs = torch.tensor(rng.standard_normal((b, p, m, k)).astype(np.float32) * 4)
    codes = torch.tensor(rng.integers(0, 256 if packed else k,
                                      (C, m // 2 if packed else m, CAP)).astype(np.uint8))
    bias = np.zeros((C, CAP), np.float32)
    bias[:, CAP - 30:] = NEG_INF
    bias = torch.tensor(bias)
    tp = torch.tensor(probes)
    live = (probes >= 0) & (probes < C)  # the plain and Pallas kernels take ids in range
    tpc = tp.clamp(0, C - 1)
    got = _k4_grouped_model(tabs, tp, codes, bias).numpy()
    assert (got[~live] == NEG_INF).all()
    plain = TI.adc_bucket_scores(tabs, tpc, codes, bias)
    mag = -TI._adc_bucket_scores_plain(TI.round_tables(tabs).abs(), tpc, codes,
                                       torch.zeros(C, CAP))
    lim = 1e-5 * mag.numpy()
    _assert_scores(got[live], plain.numpy()[live], lim[live])
    want = JI.adc_bucket_scores(jnp.asarray(tabs.contiguous().numpy()), jnp.asarray(tpc.numpy()),
                                jnp.asarray(codes.numpy()), jnp.asarray(bias.numpy()))
    _assert_scores(got[live], np.asarray(want)[live], lim[live])
