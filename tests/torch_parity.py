"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same numpy-seeded inputs go to the JAX package and to tostore_tpu_torch,
and their top-k results are compared with a stated tolerance.

Tolerances (relative to max(1, |score|)):
  - f32 corpora: 1e-5. Products are true f32 on both sides; only the order
    of summation differs.
  - bf16 and int8 corpora: 1e-4. Products of bf16 values are exact in f32,
    so again only the order of summation differs, over larger values.
Indices are compared as sets; an index in only one result must score
within the tolerance of that row's k-th score (a near-tie at the cut).
Misses (score <= NEG_INF / 2) must agree in number; their indices are
arbitrary.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float(np.finfo(np.float32).min)
TOL = {"float32": 1e-5, "bfloat16": 1e-4, "int8": 1e-4}


def assert_scores_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    lim = tol * np.maximum(1.0, np.abs(want))
    bad = np.abs(got - want) > lim
    assert not bad.any(), (
        f"{bad.sum()} scores differ beyond {tol}: max err "
        f"{np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))}"
    )


def assert_topk_match(got_s, got_i, want_s, want_i, tol):
    """Port (got) vs reference (want) top-k: scores within tol, indices
    equal as sets outside near-ties."""
    got_s, want_s = np.asarray(got_s, np.float32), np.asarray(want_s, np.float32)
    got_i, want_i = np.asarray(got_i, np.int64), np.asarray(want_i, np.int64)
    assert_scores_close(got_s, want_s, tol)
    for b in range(want_s.shape[0]):
        hit_g = got_s[b] > NEG_INF / 2
        hit_w = want_s[b] > NEG_INF / 2
        assert hit_g.sum() == hit_w.sum(), f"row {b}: miss counts differ"
        if not hit_w.any():
            continue
        sg = dict(zip(got_i[b][hit_g].tolist(), got_s[b][hit_g].tolist()))
        sw = dict(zip(want_i[b][hit_w].tolist(), want_s[b][hit_w].tolist()))
        last = min(want_s[b][hit_w])
        for idx in set(sg) ^ set(sw):
            v = sg.get(idx, sw.get(idx))
            assert abs(v - last) <= 2 * tol * max(1.0, abs(last)), (
                f"row {b}: index {idx} (score {v}) in one result only, "
                f"k-th score {last}"
            )


def make_inputs(seed, b, n, d, dtype, metric, invalid_frac=0.01):
    """Numpy inputs for one scan: (q f32 [b, d], corpus [n, d] f32 or int8,
    row_scale f32 [n] or None, valid bool [n], alpha). Cosine rows and
    queries are L2-normalized; int8 corpora carry per-row scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if dtype == "int8":
        c = rng.integers(-127, 128, (n, d)).astype(np.int8)
        scale = rng.uniform(0.5, 1.5, n).astype(np.float32) / 127.0
    else:
        c = rng.standard_normal((n, d)).astype(np.float32)
        scale = None
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        if dtype != "int8":
            c = c / np.linalg.norm(c, axis=1, keepdims=True)
    valid = rng.random(n) >= invalid_frac
    alpha = 2.0 if metric == "l2" else 1.0
    return q, c, scale, valid, alpha


def stored_sq_norms(c, scale):
    x = c.astype(np.float32)
    if scale is not None:
        x = x * scale[:, None]
    return np.einsum("ij,ij->i", x, x).astype(np.float32)


def torch_scan_inputs(seed, b, n, d, dtype, metric, device="cpu"):
    """(q, corpus, bias, row_scale) tensors for one scan, and alpha."""
    q, c, scale, valid, alpha = make_inputs(seed, b, n, d, dtype, metric)
    base = -stored_sq_norms(c, scale) if metric == "l2" else np.zeros(n, np.float32)
    bias = np.where(valid, base, NEG_INF).astype(np.float32)
    tc = torch.from_numpy(c)
    if dtype == "bfloat16":
        tc = tc.to(torch.bfloat16)
    tx = tuple(None if t is None else t.to(device) for t in (
        torch.from_numpy(q), tc, torch.from_numpy(bias),
        None if scale is None else torch.from_numpy(scale)))
    return tx, alpha, (q, c, bias, scale)


def scan_inputs(seed, b, n, d, dtype, metric):
    """The same scan inputs for both packages: (jax args, torch args, alpha)."""
    import jax.numpy as jnp  # the card's tests import this module without JAX

    tx, alpha, (q, c, bias, scale) = torch_scan_inputs(seed, b, n, d, dtype, metric)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    jx = (jnp.asarray(q), jnp.asarray(c, jdt), jnp.asarray(bias),
          None if scale is None else jnp.asarray(scale))
    return jx, tx, alpha
