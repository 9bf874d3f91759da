"""A plain reference of the IVF probe's contract: given an index's trained
centroids and its slice layout, the exact top-k of the live rows in the
nprobe slices that those centroids select.

Plain PyTorch in float64, with TF32 off: it imports nothing of the program
and none of its kernels, so it holds the port's probe (`IVFVectorIndex.
_probe` in `tostore_tpu_torch/vector/ivf.py`, on each of its routes) to its
contract on the CPU and, at a deployment's size, on the card. The trained
centroids are the deployment's weights: training is held to the JAX
package by tests/test_torch_ivf.py, and is taken here as data, with the
layout (which slice belongs to which cluster, and which slot sits at each
place of each slice).

Per query it
  1. scores the C centroids: q.c for cosine (q of unit length) and dot,
     2 q.c - |c|^2 for l2;
  2. spreads the scores over the slices (a cluster holding more rows than
     a slice occupies several, all with its score), leaves out padding
     slices, and takes the nprobe best, the lower slice first among equal
     scores;
  3. scores every live row of the probed slices exactly;
  4. returns the k best of those candidates as distances and slots, the
     earlier candidate first among equal scores, where the candidates are
     in probe order and each slice in place order; past the live
     candidates the slot is -1 and the distance inf.

Departures from the source (VectorDBBench's IVF_FLAT, an inverted file
over float32 vectors):
  - rows are taken as the field stores them (bfloat16 for the port's main
    path), and the query is rounded to the rows' type before it scores
    them, as the port's scan reads it; the centroids are scored with the
    query unrounded;
  - a cluster is cut into slices of at most `cap` rows and nprobe counts
    slices, not clusters (the port's sliced layout, which spends the probe
    budget on fat clusters);
  - among equal scores the earlier candidate wins (`jax.lax.top_k`'s rule,
    which the JAX package keeps), where the source leaves the order to its
    heap.
"""

from __future__ import annotations

import contextlib
import math

import torch

ROW_TYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the reference's products (a float64 product never
    uses it; this holds whatever type a caller's tensors have)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def stored_rows(x: torch.Tensor, metric: str, precision: str) -> torch.Tensor:
    """Rows as a field of `precision` stores them: of unit length for
    cosine (normalised in float64), rounded to the field's type."""
    x = x.double()
    if metric == "cosine":
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)
    return x.to(ROW_TYPES[precision])


def queries_of(queries: torch.Tensor, metric: str, precision: str):
    """(q [B, D] float64, of unit length for cosine; q rounded to the rows'
    type, as float64; |q|^2 of the queries as given [B])."""
    q = queries.double()
    qsq = (q * q).sum(1)
    if metric == "cosine":
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
    return q, q.to(ROW_TYPES[precision]).double(), qsq


def slice_scores(q: torch.Tensor, centroids: torch.Tensor, slice_cluster: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """[B, slices] float64: each slice's centroid score, -inf for padding
    slices (cluster -1)."""
    c = centroids.double()
    cs = q.double() @ c.T
    if metric == "l2":
        cs = 2.0 * cs - (c * c).sum(1)[None, :]
    sc = slice_cluster.long()
    return torch.where((sc >= 0)[None, :], cs[:, sc.clamp(min=0)], -math.inf)


def select_probes(q: torch.Tensor, centroids: torch.Tensor, slice_cluster: torch.Tensor,
                  metric: str, nprobe: int) -> torch.Tensor:
    """[B, min(nprobe, slices)] slice ids: the best slice scores, padding
    slices last, ties to the lower slice."""
    spread = slice_scores(q, centroids, slice_cluster, metric)
    return torch.sort(spread, dim=1, descending=True, stable=True)[1][:, :nprobe]


def _scores(qr: torch.Tensor, rows: torch.Tensor, metric: str) -> torch.Tensor:
    x = rows.double()
    s = x @ qr
    if metric == "l2":
        s = 2.0 * s - (x * x).sum(1)
    return s


def _distances(s: torch.Tensor, qsq: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        return 1.0 - s
    if metric == "dot":
        return -s
    return torch.sqrt(torch.clamp(qsq - s, min=0.0))


def probe_topk(queries: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
               centroids: torch.Tensor, slice_cluster: torch.Tensor,
               bucket_slots: torch.Tensor, *, metric: str, nprobe: int, k: int,
               precision: str = "bfloat16"):
    """The probe's answer for queries [B, D]: (distances [B, k] float64,
    slots [B, k] int64). `rows` [slots, D] as the field stores them (any
    type; read as float64), `valid` [slots] bool, `centroids` [C, D],
    `slice_cluster` [slices] (-1 = padding), `bucket_slots` [slices, cap]
    (-1 = empty place). Everything is read on `rows`' device, one query at
    a time."""
    if metric not in ("cosine", "l2", "dot"):
        raise ValueError(f"the reference has no {metric!r} metric")
    dev = rows.device
    with no_tf32():
        q, qr, qsq = queries_of(queries.to(dev), metric, precision)
        probe = select_probes(q, centroids.to(dev), slice_cluster.to(dev), metric, nprobe)
        buckets, valid = bucket_slots.to(dev).long(), valid.to(dev)
        dist = torch.full((q.shape[0], k), math.inf, dtype=torch.float64, device=dev)
        out = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
        for b in range(q.shape[0]):
            cand = buckets[probe[b]].reshape(-1)  # probe order, then place order
            cand = cand[cand >= 0]
            cand = cand[valid[cand]]
            s = _scores(qr[b], rows[cand], metric)
            best = torch.sort(s, descending=True, stable=True)[1][:k]
            out[b, : len(best)] = cand[best]
            dist[b, : len(best)] = _distances(s[best], qsq[b], metric)
    return dist, out


def distances_of(queries: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor, *,
                 metric: str, precision: str = "bfloat16") -> torch.Tensor:
    """The exact distance [B, k] float64 of each given slot [B, k] to its
    query (inf where the slot is -1)."""
    dev = rows.device
    with no_tf32():
        _, qr, qsq = queries_of(queries.to(dev), metric, precision)
        slots = slots.to(dev)
        out = torch.full(slots.shape, math.inf, dtype=torch.float64, device=dev)
        for b in range(slots.shape[0]):
            ok = slots[b] >= 0
            s = _scores(qr[b], rows[slots[b][ok]], metric)
            out[b, ok] = _distances(s, qsq[b], metric)
    return out
