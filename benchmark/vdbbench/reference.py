"""The plain reference and the comparison that decides `correct`.

Plain PyTorch: it imports nothing of the program. From the seed it makes
the configuration's rows again (datagen.Mixture), normalises them (cosine),
rounds rows and queries to the field's declared type, and scores every row
against the sampled queries in float64, in blocks of rows, so that it fits
beside nothing else on the card once the program is gone.

What it works out per sampled query:
  - the exact top-k over the eligible rows (the filter keeps keys at or
    above a threshold);
  - for a flat index, the top-k over the candidates that the default mode
    documents (`ops/topk.py`: exact unless 3+ of the true top-k share one
    bucket): the best `per_bucket` rows of every bucket of rows with the
    same (position // block_rows, position % lanes), positions in load
    order, which is key order;
  - its own score of every hit the program returned.

The numbers compared (each under a limit in the configuration's file):
  - `dist_err`: the widest gap between a hit's distance as the program
    reported it and the reference's distance of that row;
  - `gap`: the widest amount by which a returned hit scores below the k-th
    best score of the documented candidates (0 when every hit is at least
    that good; an exact answer reads at most the rounding);
  - `miss`: 1 - the mean recall of the exact top k among the answers' k
    hits (an IVF index answers from its probed clusters only: probing
    fewer, or skipping part of a probed cluster, loses hits of the exact
    top k);
  - `miss10`: the same over the exact top 10 and the first 10 hits (logged,
    under no limit);
  - `bad`: answers that break a guarantee: fewer hits than min(k, eligible
    rows), a pk that is no row, a pk twice, a filtered-out row, distances
    out of order or not finite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Q_BLOCK = 256  # sampled queries scored at once
BIG = 1.7976931348623157e308


DOT = ("dot", "innerProduct")


def _prepared(x: torch.Tensor, metric: str, precision: str) -> torch.Tensor:
    """Rows (or queries) as the field stores them, in float64."""
    if metric == "cosine":
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)
    elif metric not in DOT:
        raise ValueError(f"the reference has no {metric!r} distance")
    if precision == "bfloat16":
        x = x.to(torch.bfloat16)
    elif precision != "float32":
        raise ValueError(f"the reference has no {precision!r} rows")
    return x.double()


def _distance(metric: str, s: torch.Tensor) -> torch.Tensor:
    return 1.0 - s if metric == "cosine" else -s


def _top(s_run, i_run, s_new, i_new, k):
    s = torch.cat([s_run, s_new], 1)
    i = torch.cat([i_run, i_new], 1)
    s, j = torch.topk(s, k, dim=1)
    return s, torch.gather(i, 1, j)


def _bucket_best(s: torch.Tensor, off: int, rule: dict):
    """The best `per_bucket` scores (and positions) of every bucket of a
    block-aligned chunk of scores [Q, m]."""
    br, lanes, per = rule["block_rows"], rule["lanes"], rule["per_bucket"]
    q, m = s.shape
    pad = -m % br
    if pad:
        s = torch.cat([s, s.new_full((q, pad), -math.inf)], 1)
    nb = s.shape[1] // br
    v = s.view(q, nb, br // lanes, lanes)
    top, j = torch.topk(v, per, dim=2)  # [Q, nb, per, lanes]
    pos = (off + torch.arange(nb, device=s.device)[None, :, None, None] * br
           + j * lanes + torch.arange(lanes, device=s.device)[None, None, None, :])
    return top.reshape(q, -1), pos.reshape(q, -1)


def score_block(config: dict, mixture, queries: torch.Tensor, hits: torch.Tensor,
                keep_from: int) -> dict:
    """Reference scores for one block of queries [Q, d] and the pks the
    program returned for them [Q, k] (-1 where none): exact top-k scores and
    positions, the documented candidates' k-th score, and every hit's score
    (nan where the pk is no row)."""
    n, k = config["rows"], config["top_k"]
    metric, precision = config["metric"], config["precision"]
    rule = config["check"].get("candidate_rule")
    dev = mixture.device
    q = _prepared(queries.to(dev, torch.float32), metric, precision)
    nq = q.shape[0]
    hit_pos = hits.to(dev) - 1
    hit_s = torch.full(hit_pos.shape, math.nan, dtype=torch.float64, device=dev)
    ex_s = torch.full((nq, k), -math.inf, dtype=torch.float64, device=dev)
    ex_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    ru_s, ru_i = ex_s.clone(), ex_i.clone()
    for off, rows in mixture.rows(n):
        m = rows.shape[0]
        s = q @ _prepared(rows, metric, precision).T
        inside = (hit_pos >= off) & (hit_pos < off + m)
        got = torch.gather(s, 1, (hit_pos - off).clamp(0, m - 1))
        hit_s = torch.where(inside, got, hit_s)
        if keep_from > off:
            s[:, : min(m, keep_from - off)] = -math.inf
        pos = off + torch.arange(m, device=dev)
        ex_s, ex_i = _top(ex_s, ex_i, s, pos.expand(nq, m), k)
        if rule:
            ru_s, ru_i = _top(ru_s, ru_i, *_bucket_best(s, off, rule), k)
    kth = (ru_s if rule else ex_s)[:, k - 1]
    return {"exact_pos": ex_i.cpu(), "kth": kth.cpu(), "hit_s": hit_s.cpu()}


def judge(config: dict, mixture, queries: np.ndarray, pks: np.ndarray, dists: np.ndarray,
          counts: np.ndarray, keep_from: int = 0) -> dict:
    """Compare the program's answers (pks [Q, k] int64 with -1 past the
    hits, distances [Q, k], hit counts [Q]) for queries [Q, d] with the
    reference. Returns the numbers, per answer whether it breaks a limit
    (`wrong`, bool [Q]) and the mean recall of the exact top k (`recall`)."""
    n, k, metric = config["rows"], config["top_k"], config["metric"]
    limits = config["check"]["limits"]
    parts = []
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a in range(0, len(queries), Q_BLOCK):
            parts.append(score_block(config, mixture, torch.from_numpy(queries[a:a + Q_BLOCK]),
                                     torch.from_numpy(pks[a:a + Q_BLOCK]), keep_from))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    exact = torch.cat([p["exact_pos"] for p in parts]).numpy()
    kth = torch.cat([p["kth"] for p in parts]).numpy()
    hit_s = torch.cat([p["hit_s"] for p in parts]).numpy()

    want = min(k, n - keep_from)
    # hits that are rows; a pk that is none counts under `bad`
    rows = (np.arange(k)[None, :] < counts[:, None]) & ~np.isnan(hit_s)
    ref_d = _distance(metric, torch.from_numpy(hit_s)).numpy()
    err = np.where(rows, np.abs(dists - ref_d), 0.0)
    dist_err = np.nan_to_num(err, nan=np.inf).max(axis=1)
    low = np.where(rows, hit_s, np.inf).min(axis=1)
    gap = np.maximum(kth - low, 0.0)
    top10 = min(10, k)
    recall10 = np.array([len(set(exact[i, :top10] + 1) & set(pks[i, :top10])) / top10
                         for i in range(len(pks))])
    recall = np.array([len(set(exact[i] + 1) & set(pks[i, : counts[i]])) / k
                       for i in range(len(pks))])
    bad = np.zeros(len(pks), bool)
    for i in range(len(pks)):
        p, d = pks[i, : counts[i]], dists[i, : counts[i]]
        bad[i] = (counts[i] != want or len(set(p.tolist())) != len(p)
                  or bool(((p < 1) | (p > n) | (p - 1 < keep_from)).any())
                  or not np.isfinite(d).all() or bool((np.diff(d) < 0).any()))
    # a number that is not finite prints as the largest float, so that the
    # result stays plain JSON
    numbers = {"dist_err": min(float(dist_err.max()), BIG), "gap": min(float(gap.max()), BIG),
               "miss": float(1.0 - recall.mean()), "miss10": float(1.0 - recall10.mean()),
               "bad": float(bad.sum())}
    wrong = bad.copy()
    for name, per_answer in (("dist_err", dist_err), ("gap", gap)):
        if name in limits:
            wrong |= per_answer > limits[name]
    return {"numbers": numbers, "wrong": wrong, "recall": float(recall.mean())}
