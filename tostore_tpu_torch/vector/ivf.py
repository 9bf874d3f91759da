"""IVFVectorIndex: coarse-quantizer partitioned ANN index (counterpart of
`tostore_tpu/vector/ivf.py`).

The corpus is partitioned by a k-means coarse quantizer. A query scores
the centroids, probes the `nprobe` nearest clusters, scans only those
buckets with exact distances (raw vectors) or ADC (PQ codes), and
re-ranks, mirroring the reference's search -> re-rank pool rule
max(2k, 20) (ngh_graph_engine.dart:115).

Layout (the JAX package's, kept so both packages hold the same index):
buckets_slots [C_exp, cap] maps bucket positions to DeviceCorpus slots
(-1 = empty). A cluster with more rows than `cap` occupies several
consecutive "slices" with a duplicated centroid, so a probe spends its
budget on fat clusters. Beside it sit bucket-contiguous copies: the raw
rows [C_exp, cap, D] scanned by K3 (ops/ivfprobe.py bucket_probe_scores),
or the PQ codes [C_exp, M (or M/2 packed), cap] scanned by K4
(adc_bucket_scores). Without a contiguous copy the probe gathers rows by
slot in plain PyTorch, as the JAX package leaves that path to XLA.

Where the JAX package relies on immutable arrays, this port writes some
tensors in place (the corpus, the bucket maps on upsert/delete); the RCU
retrain and compaction stay safe because every mutation bumps the
mutation count that install checks (capture_build_state).
"""

from __future__ import annotations

import time
from collections import namedtuple

import numpy as np
import torch

from ..models.results import VectorSearchResult
from ..ops import _kernels, graphs
from ..ops import distance as D
from ..ops.ivfprobe import LAUNCHES as PROBE_LAUNCHES
from ..ops.ivfprobe import adc_bucket_scores, adc_kernel_supported, bucket_probe_scores
from ..ops.runtime import NEG_INF, f32_dot, round_up, score_dtype
from ..ops.topk import MISS_FLOOR, top_k_first
from ..utils.spans import span
from .corpus import DeviceCorpus
from .flat import FlatVectorIndex, run_search
from .pq import (
    PQCodebook,
    _kmeans_all_subspaces,
    adc_tables,
    adc_tables_probed,
    pq_encode,
    train_pq,
)


def auto_num_clusters(n: int) -> int:
    """~sqrt(N), multiple of 8, within [8, 4096]."""
    c = int(np.sqrt(max(n, 1)))
    return int(min(4096, max(8, round_up(c, 8))))


# --------------------------------------------------------------------------
# Probe scans
# --------------------------------------------------------------------------


def _select_probes(q, centroids, slice_cluster, slice_bias, l2: bool, nprobe: int):
    """Probe selection over the (sliced) centroids: [B, nprobe] slice ids.

    Scores come from the C real centroids and are then spread over their
    slices, so a fat cluster's slices tie exactly; the stable sort takes
    the lower slice first, as `lax.top_k` does in the JAX package.
    slice_bias masks padding slices with NEG_INF."""
    cs = torch.mm(q, centroids.t())
    if l2:
        cs = 2.0 * cs - torch.sum(centroids * centroids, dim=1)[None, :]
    cs = cs[:, slice_cluster] + slice_bias[None, :]
    return top_k_first(cs, nprobe)[1]


def _rescore(q, cand, vectors, scales, sq_norms, alpha):
    """Exact scores alpha * q.x (* scale) (- |x|^2) of candidate slots
    [B, R] (clamped to valid slot numbers by the caller), as the flat scan
    computes them: q rounded to the rows' score type, f32 products."""
    vecs = vectors[cand].float()  # [B, R, D]; bf16 / int8 widen exactly
    qv = q.to(score_dtype(vectors.dtype)).float()
    s = alpha * torch.bmm(vecs, qv[:, :, None])[:, :, 0]
    if scales is not None:
        s = s * scales[cand]
    if sq_norms is not None:
        s = s - sq_norms[cand]
    return s


def _final_topk(s, slots, k: int):
    """Top-k of [B, R] candidate scores in the reference's candidate order
    (probes in probe order, each bucket in row order; or the re-rank pool
    in ADC order), ties to the earlier candidate, misses in any order;
    -> (scores, slots)."""
    ts, ti = top_k_first(s, k, MISS_FLOOR)
    return ts, torch.gather(slots, 1, ti)


# The most queries a search may have for its probe to run as CUDA graphs.
GRAPH_MAX_B = 32


def _probe_graph_eligible(device: torch.device, raw_contig: bool, masked: bool, b: int) -> bool:
    """Whether a probe search runs its stages as CUDA graphs: on a CUDA
    device, on the raw bucket-contiguous route (K3), with no per-call slot
    mask, for at most GRAPH_MAX_B queries. The PQ and gather routes, masked
    searches and larger batches run eagerly."""
    return device.type == "cuda" and raw_contig and not masked and b <= GRAPH_MAX_B


def _scan_contig(q, probe, buckets_slots, bucket_vectors, bucket_scale, bucket_bias, alpha):
    """Raw candidates from the bucket-CONTIGUOUS corpus copy with K3
    (bucket_probe_scores): one sequential [cap, D] block per (query,
    probe). bucket_bias folds validity, l2 norms and any per-call slot
    mask. Returns (scores [B, nprobe * cap], slots [B, nprobe * cap])."""
    b = q.shape[0]
    qf = (q * alpha).to(score_dtype(bucket_vectors.dtype)).contiguous()
    s = bucket_probe_scores(qf, probe, bucket_vectors, bucket_bias, bucket_scale)
    return s.reshape(b, -1), buckets_slots[probe].reshape(b, -1)


def _scan_gather(q, probe, buckets_slots, vectors, scales, valid, sq_norms, alpha):
    """Raw candidates by slot gather (the JAX package's XLA path), one
    query at a time to bound the gathered [nprobe * cap, D] block: (scores
    [B, nprobe * cap], NEG_INF where no live row; slots)."""
    slots = buckets_slots[probe].reshape(q.shape[0], -1)
    out = []
    for b in range(q.shape[0]):
        safe = torch.clamp(slots[b : b + 1], min=0)
        s = _rescore(q[b : b + 1], safe, vectors, scales, sq_norms, alpha)
        ok = (slots[b : b + 1] >= 0) & valid[safe]
        out.append(torch.where(ok, s, torch.full_like(s, NEG_INF)))
    return torch.cat(out), slots


def _pq_tables(codebooks, q_raw, cents_unpad, probe, adc_metric: str, residual: bool):
    """Per-(query, probe) ADC tables [B, P, M, K] and score offsets [B, P]."""
    if residual:
        return adc_tables_probed(codebooks, q_raw, cents_unpad, probe, metric=adc_metric)
    t = adc_tables(codebooks, q_raw, metric=adc_metric)  # [B, M, K]
    b, p = probe.shape
    return (t[:, None].expand(b, p, *t.shape[1:]),
            torch.zeros((b, p), dtype=torch.float32, device=q_raw.device))


def _scan_pq_contig(q_raw, probe, cents_unpad, buckets_slots, bucket_codes, codebooks,
                    bucket_bias, *, adc_metric: str, residual: bool):
    """ADC candidates over bucket-contiguous CODES with K4
    (adc_bucket_scores). bucket_bias is pure validity (0 / NEG_INF): ADC
    distances are complete. With `residual` (IVFADC) the tables are built
    per probed cluster from q - centroid[probe]. Returns (ADC scores [B,
    nprobe * cap], slots)."""
    b = q_raw.shape[0]
    tabs, offs = _pq_tables(codebooks, q_raw, cents_unpad, probe, adc_metric, residual)
    s_adc = adc_bucket_scores(tabs, probe, bucket_codes, bucket_bias)
    s_adc = (s_adc + offs[:, :, None]).reshape(b, -1)
    return s_adc, buckets_slots[probe].reshape(b, -1)


def _scan_pq_gather(q_raw, probe, cents_unpad, buckets_slots, codes, codebooks, valid, *,
                    adc_metric: str, residual: bool):
    """ADC candidates by code gather (the JAX package's XLA path), with f32
    tables, one query at a time: (ADC scores [B, nprobe * cap], NEG_INF
    where no live row; slots)."""
    b, nprobe = probe.shape
    cap = buckets_slots.shape[1]
    m = codebooks.shape[0]
    tabs, offs = _pq_tables(codebooks, q_raw, cents_unpad, probe, adc_metric, residual)
    slots = buckets_slots[probe].reshape(b, nprobe * cap)
    out = []
    for i in range(b):
        safe = torch.clamp(slots[i], min=0)
        crow = codes[safe].long().reshape(nprobe, cap, m).transpose(1, 2)  # [P, M, cap]
        d_adc = torch.gather(tabs[i], 2, crow).sum(dim=1)  # [P, cap]
        s_adc = (-d_adc + offs[i][:, None]).reshape(nprobe * cap)
        ok = (slots[i] >= 0) & valid[safe]
        out.append(torch.where(ok, s_adc, torch.full_like(s_adc, NEG_INF)))
    return torch.stack(out), slots


def _rerank(q, s_adc, slots, vectors, scales, sq_norms, alpha, *, k: int, rerank: int):
    """The PQ selection: a pool of the `rerank` best ADC candidates, scored
    exactly against the raw rows, and their top-k (`_final_topk`). A dead
    candidate carries ADC score NEG_INF (its slot may be reused)."""
    cand_adc, ri = top_k_first(s_adc, min(rerank, s_adc.shape[1]), MISS_FLOOR)
    cand = torch.gather(slots, 1, ri)  # [B, R]
    csafe = torch.clamp(cand, min=0)
    s = _rescore(q, csafe, vectors, scales, sq_norms, alpha)
    ok = (cand >= 0) & (cand_adc > NEG_INF / 2)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    return _final_topk(s, cand, k)


# What a probe reads of one index, or of one shard (`_ivf_probe`): the metric,
# the unpadded dims, whether PQ codes are residual (IVFADC), and tensors: the
# centroids and slice map, the bucket table, the rows with their validity and
# norms, the bucket-contiguous copies and the PQ codebooks (None where absent).
ProbeIndex = namedtuple("ProbeIndex", [
    "metric", "dims", "residual", "centroids", "slice_cluster", "slice_bias", "centroids_exp",
    "buckets_slots", "vectors", "scales", "valid", "sq_norms", "bucket_vectors",
    "bucket_scales", "bucket_bias", "codebooks", "codes", "bucket_codes"])


def _ivf_probe(q, t: ProbeIndex, *, k: int, nprobe: int, rerank: int = 0, slot_mask=None,
               run=graphs.eager, finish=None):
    """The probe of one index, or of one shard, for prepared queries q [B,
    Dp], in three stages, each a span: probe selection (`_select_probes`),
    a scan that scores every candidate of the probed slices (probes in
    probe order, each slice in row order), and a selection over those
    candidates (`_final_topk`, or `_rerank` of a pool of `rerank` after
    ADC). The route is the one the tensors of `t` give: PQ where
    `codebooks` is set, else raw; over the bucket-contiguous copy where
    there is one (K4, K3), else by gather. A per-call `slot_mask` folds
    into `valid` and `bucket_bias` inside the scan. `run(i, fn)` runs stage
    i of the raw contiguous route (`graphs.eager`, or a CUDA-graph entry's
    stage), whose last stage also runs `finish`. Returns finish(scores [B,
    k] desc, slots [B, k]), or that pair where `finish` is None."""
    l2 = t.metric == "l2"
    alpha = D.metric_alpha(t.metric)
    sqn = t.sq_norms if l2 else None
    pq = t.codebooks is not None
    with span("vector_search.probes"):
        probe = run(0, lambda: _select_probes(q, t.centroids, t.slice_cluster, t.slice_bias, l2,
                                              nprobe))
    with span("vector_search.scan"):
        valid = t.valid if slot_mask is None else t.valid & slot_mask
        if pq:
            adc = dict(adc_metric="dot" if t.metric == "dot" else "l2", residual=t.residual)
            q_raw, cents_unpad = q[:, : t.dims], t.centroids_exp[:, : t.dims]
            if t.bucket_codes is not None:
                bias = (t.bucket_bias if slot_mask is None
                        else _bucket_bias(t.buckets_slots, valid, t.sq_norms, l2=False))
                cand = _scan_pq_contig(q_raw, probe, cents_unpad, t.buckets_slots,
                                       t.bucket_codes, t.codebooks, bias, **adc)
            else:
                cand = _scan_pq_gather(q_raw, probe, cents_unpad, t.buckets_slots, t.codes,
                                       t.codebooks, valid, **adc)
        elif t.bucket_vectors is not None:
            bias = (t.bucket_bias if slot_mask is None
                    else _bucket_bias(t.buckets_slots, valid, t.sq_norms, l2=l2))
            cand = run(1, lambda: _scan_contig(q, probe, t.buckets_slots, t.bucket_vectors,
                                               t.bucket_scales, bias, alpha))
        else:
            cand = _scan_gather(q, probe, t.buckets_slots, t.vectors, t.scales, valid, sqn,
                                alpha)
    with span("vector_search.select"):
        def select():
            top = (_rerank(q, *cand, t.vectors, t.scales, sqn, alpha, k=k, rerank=rerank)
                   if pq else _final_topk(*cand, k))
            return top if finish is None else finish(*top)

        return select() if pq else run(2, select)


# --------------------------------------------------------------------------
# Build helpers
# --------------------------------------------------------------------------


def _kmeans_sampled(vectors, scales, slots, init, *, k: int, iters: int):
    """Coarse k-means over the sampled rows (dequantized for int8), with
    the assignment product in bf16 as the JAX package runs it."""
    x = vectors[slots].float()
    if scales is not None:
        x = x * scales[slots][:, None]
    return _kmeans_all_subspaces(x[None], init[None], k=k, iters=iters,
                                 compute_dtype=torch.bfloat16)[0]


def _expand_centroids(centroids, slice_cluster):
    """(centroids_exp, slice_bias): slice_cluster -1 = padding ->
    NEG_INF probe bias."""
    cents = centroids[torch.clamp(slice_cluster, min=0)]
    bias = torch.where(slice_cluster >= 0, 0.0, NEG_INF).to(torch.float32)
    return cents, bias


def _neg_sq_norms_rows(bucket_vectors, step: int = 64):
    """-|x|^2 of every stored row of [C, cap, D], in chunks of buckets (no
    full f32 copy of the contiguous corpus)."""
    out = torch.empty(bucket_vectors.shape[:2], dtype=torch.float32,
                      device=bucket_vectors.device)
    for i in range(0, bucket_vectors.shape[0], step):
        bv = bucket_vectors[i : i + step].float()
        out[i : i + step] = -torch.sum(bv * bv, dim=-1)
    return out


def _place_and_contig(assign, valid, base, vectors, sq_norms, centroids, slice_cluster, *,
                      cap: int, c_exp: int, with_vectors: bool, bias_l2: bool):
    """Placement, the bucket-contiguous corpus copy and the bucket bias.
    Placement admits only valid rows, so validity is `buckets >= 0`. The
    l2 bias comes from the copy's own stored rows (bf16 rounding included,
    consistent with the scores K3 computes from them), except for int8,
    whose dequantized norms are the stored sq_norms."""
    buckets, slot_slice, slot_pos, slice_counts = _ivf_place_sliced(
        assign, valid, base, cap=cap, c_exp=c_exp)
    safe = torch.clamp(buckets, min=0)
    bucket_vectors = vectors[safe] if with_vectors else None
    if not bias_l2:
        bias_base = torch.zeros(buckets.shape, dtype=torch.float32, device=buckets.device)
    elif with_vectors and vectors.dtype != torch.int8:
        bias_base = _neg_sq_norms_rows(bucket_vectors)
    else:
        bias_base = -sq_norms[safe]
    bucket_bias = torch.where(buckets >= 0, bias_base, torch.full_like(bias_base, NEG_INF))
    cents_exp, slice_bias = _expand_centroids(centroids, slice_cluster)
    return (buckets, slot_slice, slot_pos, slice_counts, bucket_vectors, bucket_bias,
            cents_exp, slice_bias)


def _bucket_bias(buckets_slots, valid, sq_norms, *, l2: bool):
    """[C, cap] additive score bias: NEG_INF for dead entries, -|x|^2
    folded for l2 (K3 computes alpha*q.x + bias)."""
    safe = torch.clamp(buckets_slots, min=0)
    ok = (buckets_slots >= 0) & valid[safe]
    base = (-sq_norms[safe] if l2
            else torch.zeros(buckets_slots.shape, dtype=torch.float32,
                             device=buckets_slots.device))
    return torch.where(ok, base, torch.full_like(base, NEG_INF))


def _ivf_assign_device(vectors, valid, centroids, scales, *, chunk: int, l2: bool):
    """Chunked nearest-centroid assignment: (choices [Ncap] int64, counts
    [C] first-choice bincounts over valid rows). The product runs in bf16
    for bf16 and int8 corpora (centroids cast to bf16, as the JAX package
    does), in f32 for f32 corpora; `scales` dequantizes int8 rows into
    the centroids' space."""
    ncap = vectors.shape[0]
    num_c = centroids.shape[0]
    c_t = centroids.to(score_dtype(vectors.dtype))
    cnorm = torch.sum(centroids.float() ** 2, dim=1)
    choices = torch.empty(ncap, dtype=torch.int64, device=vectors.device)
    for s in range(0, ncap, chunk):
        v = vectors[s : s + chunk]
        sc = f32_dot(v if v.dtype != torch.int8 else v.to(torch.bfloat16), c_t)
        if scales is not None:
            sc = sc * scales[s : s + chunk, None]
        if l2:
            sc = 2.0 * sc - cnorm[None, :]
        choices[s : s + chunk] = torch.argmax(sc, dim=1)
    counts = torch.bincount(choices[valid], minlength=num_c)
    return choices, counts


def _ivf_place_sliced(assign, valid, base, *, cap: int, c_exp: int):
    """Sliced bucket placement: every valid row lands in its FIRST-choice
    cluster; a cluster with count > cap occupies ceil(count/cap)
    consecutive slices (base[c] = its first). Rows keep their order within
    a cluster (stable sort by cluster), so slots, positions and buckets are
    the JAX package's.

    Returns (buckets [c_exp, cap] int64, slot_slice [Ncap], slot_pos
    [Ncap], slice_counts [c_exp])."""
    ncap = assign.shape[0]
    num_c = base.shape[0]
    dev = assign.device
    idx = torch.arange(ncap, device=dev)
    want = torch.where(valid, assign, torch.full_like(assign, num_c))
    order = torch.sort(want, stable=True)[1]
    ws = want[order]
    change = torch.ones(ncap, dtype=torch.bool, device=dev)
    change[1:] = ws[1:] != ws[:-1]
    # first index of each run: run starts carried forward by a running max
    first = torch.cummax(torch.where(change, idx, torch.zeros_like(idx)), dim=0)[0]
    within = idx - first
    ok = ws < num_c
    sl = torch.where(ok, base[torch.clamp(ws, max=num_c - 1)] + within // cap,
                     torch.full_like(ws, -1))
    pos = torch.where(ok, within % cap, torch.full_like(ws, -1))
    # per-slot arrays: sorted position -> original row (a permutation)
    slot_slice = torch.empty_like(sl)
    slot_pos = torch.empty_like(pos)
    slot_slice[order] = sl
    slot_pos[order] = pos
    # slice run bounds by bisection on the ascending slice ids; rows not
    # placed map to c_exp so the view stays monotone
    sl_view = torch.where(ok, sl, torch.full_like(sl, c_exp))
    bounds = torch.searchsorted(sl_view, torch.arange(c_exp + 1, device=dev), side="left")
    slice_counts = bounds[1:] - bounds[:-1]
    # bucket matrix: each placed row owns one (slice, pos) cell; unplaced
    # rows all land in the spare last element, which is dropped
    cells = torch.where(ok, sl * cap + pos, torch.full_like(sl, c_exp * cap))
    buckets = torch.full((c_exp * cap + 1,), -1, dtype=torch.int64, device=dev)
    buckets[cells] = order
    return buckets[:-1].reshape(c_exp, cap), slot_slice, slot_pos, slice_counts


class _CountOnly(dict):
    """Stand-in pk map for shadow corpora: only len() is consulted."""

    def __init__(self, n: int):
        super().__init__()
        self._n = n

    def __len__(self):
        return self._n


# --------------------------------------------------------------------------
# The index
# --------------------------------------------------------------------------


class IVFVectorIndex:
    """IVF (optionally IVF-PQ) index over a DeviceCorpus on `device`.

    Probe paths, in search_arrays' dispatch order:
      - PQ with contiguous codes: K4 ADC + exact re-rank of a pool of
        max(rerank_factor*k, 51k, 512) (the JAX package's recall-derived
        floor);
      - PQ without (unsupported (M, K) for the JAX kernel): code gather;
      - raw with the contiguous copy (fits CONTIG_MAX_BYTES): K3;
      - raw without: row gather.
    mode='auto' may fall back to the flat scan (ops/topk.py, K1/K2) when
    the cost model `_flat_beats_probe` says it is cheaper; mode='exact'
    always runs the exact flat scan; mode='probe' forces the probe."""

    index_type = "ivf"

    def __init__(self, dims: int, metric: str = "cosine", precision: str = "float32",
                 num_clusters: int = 0, nprobe: int = 8, pq_subspaces: int = 0,
                 pq_centroids: int = 0, rerank_factor: int = 2, min_train_size: int = 256,
                 pq_residual: bool = True, pq_rerank: int = 0, *, device):
        # the exact flat scan of this index's rows (mode 'exact', an untrained
        # index, a batch the cost model gives it), which holds the corpus
        self._flat = FlatVectorIndex(dims, metric, precision, device=device)
        self.metric = self._flat.metric
        self.num_clusters_cfg = num_clusters
        self.nprobe = nprobe
        self.pq_subspaces = pq_subspaces
        self.pq_centroids = pq_centroids
        self.rerank_factor = rerank_factor
        self.min_train_size = min_train_size
        # IVFADC residual codes (x - centroid[bucket])
        self.pq_residual = pq_residual
        self.pq_rerank = pq_rerank  # 0 = auto: max(rerank_factor*k, 51k, 512)
        # engine-owned indexes defer the 4x-growth retrain to background
        # maintenance (RCU capture/build/install); library use retrains inline
        self.defer_retrain = False
        self._mutations = 0  # staleness check for off-lock rebuilds
        self._last_mut_t = 0.0  # quiescence gate for background maintenance

        self.centroids: torch.Tensor | None = None  # [C, Dp] f32
        # sliced layout: cluster c owns slices base[c]..base[c]+nsl[c]-1
        self.centroids_exp: torch.Tensor | None = None  # [C_exp, Dp] f32
        self.slice_bias: torch.Tensor | None = None  # [C_exp] f32 (0 / NEG_INF)
        self._slice_cluster_dev: torch.Tensor | None = None  # [C_exp] -> c (0 on padding)
        self._slice_cluster: np.ndarray | None = None  # host [C_exp] -> c (-1 = padding)
        self._slice_base: np.ndarray | None = None  # host [C] first slice
        self._slice_count: np.ndarray | None = None  # host [C] n slices
        self.buckets_slots: torch.Tensor | None = None  # [C_exp, cap] int64
        self._bucket_counts: np.ndarray | None = None  # host [C_exp]
        self._bucket_counts_dev: torch.Tensor | None = None  # lazy mirror
        # slot -> (slice, position), -1 = unassigned; after a build they stay
        # on the device until an incremental path needs them on the host
        self._slot_cluster: np.ndarray | None = np.zeros(0, np.int32)
        self._slot_pos: np.ndarray | None = np.zeros(0, np.int32)
        self._slot_dev: tuple | None = None
        self._trained_size = 0
        self.pq: PQCodebook | None = None
        self.codes: torch.Tensor | None = None  # [Ncap, M] u8 (PQ mode)
        self.bucket_vectors: torch.Tensor | None = None  # [C_exp, cap, Dp]
        self.bucket_codes: torch.Tensor | None = None  # [C_exp, M or M/2, cap] u8
        self.bucket_bias: torch.Tensor | None = None  # [C_exp, cap] f32
        self.bucket_scales: torch.Tensor | None = None  # [C_exp, cap] f32 (int8)
        self.CONTIG_MAX_BYTES = 6 << 30
        self._probe_graphs = graphs.GraphCache()  # the probe's CUDA graphs by key

    # --- helpers ------------------------------------------------------------

    def __len__(self):
        return len(self.corpus)

    @property
    def corpus(self) -> DeviceCorpus:
        """The index's rows, held by its flat view (also one set in place of
        another, convert.py)."""
        return self._flat.corpus

    @corpus.setter
    def corpus(self, corpus: DeviceCorpus):
        self._flat.corpus = corpus

    @property
    def dims(self):
        return self.corpus.dims

    @property
    def device(self) -> torch.device:
        return self.corpus.device

    @property
    def trained(self) -> bool:
        return self.centroids is not None

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _stored_matrix_f32(self, slots: np.ndarray) -> torch.Tensor:
        idx = self._tensor(slots)
        v = self.corpus.vectors[idx].float()
        if self.corpus.scales is not None:
            v = v * self.corpus.scales[idx][:, None]
        return v

    def _live_slots(self) -> np.ndarray:
        c = self.corpus
        if c._high == 0:
            return np.zeros(0, np.int64)
        return np.flatnonzero(c.valid[: c._high].cpu().numpy())

    def _bucket_counts_host(self) -> np.ndarray:
        """Slice fill counts, read back lazily (only the append path needs
        them on the host)."""
        if self._bucket_counts is None and self._bucket_counts_dev is not None:
            self._bucket_counts = self._bucket_counts_dev.cpu().numpy().astype(np.int64)
            self._bucket_counts_dev = None
        return self._bucket_counts

    def _ensure_slot_host(self):
        if self._slot_cluster is None:
            sc, sp = self._slot_dev
            self._slot_cluster = sc.cpu().numpy().astype(np.int32)
            self._slot_pos = sp.cpu().numpy().astype(np.int32)
            self._slot_dev = None

    def _slot_cluster_device(self) -> torch.Tensor:
        """slot -> slice as a device tensor [capacity]."""
        if self._slot_dev is not None:
            return self._slot_dev[0]
        self._ensure_slot_arrays()
        return self._tensor(self._slot_cluster[: self.corpus.capacity])

    def _ensure_slot_arrays(self):
        self._ensure_slot_host()
        cap = self.corpus.capacity
        if len(self._slot_cluster) < cap:
            sc = np.full(cap, -1, np.int32)
            sp = np.full(cap, -1, np.int32)
            sc[: len(self._slot_cluster)] = self._slot_cluster
            sp[: len(self._slot_pos)] = self._slot_pos
            self._slot_cluster, self._slot_pos = sc, sp

    # --- training -------------------------------------------------------------

    def train(self, force: bool = False):
        """(Re)train centroids (+ PQ) on the current corpus."""
        c = self.corpus
        n = len(c)
        if n < 1:
            return False
        if self.trained and not force:
            return False
        live = self._live_slots()
        num_c = self.num_clusters_cfg or auto_num_clusters(n)
        num_c = min(num_c, max(8, len(live)))
        rng = np.random.default_rng(42)
        sample = live if len(live) <= 65536 else rng.choice(live, 65536, replace=False)
        init = rng.choice(len(sample), min(num_c, len(sample)), replace=False)
        # the sample is padded to a power of two by REPEATING entries, as the
        # JAX package does (it bounds XLA's compile shapes there); kept so
        # that both packages train on the same rows
        m = len(sample)
        bucket = 1 << max(m - 1, 0).bit_length()
        if bucket > m:
            sample = np.concatenate([sample, sample[rng.integers(0, m, bucket - m)]])
        cents = _kmeans_sampled(c.vectors, c.scales, self._tensor(sample), self._tensor(init),
                                k=len(init), iters=10)
        if len(init) < num_c:
            reps = -(-num_c // len(init))
            cents = cents.repeat(reps, 1)[:num_c]
        self.centroids = cents.contiguous()

        self._trained_size = n
        # buckets first: residual PQ training needs each sample's slice.
        # Stale codebooks are dropped before the rebuild.
        self.pq = None
        self._rebuild_buckets()

        if self.pq_subspaces:
            xs = self._stored_matrix_f32(sample).cpu().numpy()[:, : c.dims]
            if self.pq_residual:
                sl = self._slot_cluster_device()[self._tensor(sample)].cpu().numpy()
                cents_np = self.centroids.cpu().numpy()[:, : c.dims]
                cl = np.maximum(self._slice_cluster[np.maximum(sl, 0)], 0)
                xs = xs - cents_np[cl]
            self.pq = train_pq(xs, m=self.pq_subspaces, k=self._resolve_pq_k(),
                               device=self.device)
            self._reencode_all()
        return True

    # Dispatch constants of the cost model, in ms and us of a whole
    # search_arrays call. For CPU tensors they are the JAX package's (fitted
    # on a TPU v5e), so that both packages take the same path there.
    PROBE_BASE_MS = 1.7     # fixed dispatch + centroid top-k + rerank cost
    PROBE_BASE_PQ_MS = 1.7  # the same for a PQ index (the reference has one base)
    PROBE_STEP_US = 2.2     # raw contiguous kernel, per (query, slice)
    PROBE_STEP_ADC4_US = 5.4   # 4-bit nibble ADC, per (query, slice)
    PROBE_STEP_ADC8_US = 18.0  # 8-bit K=256 ADC, per (query, slice)
    FLAT_BASE_MS = 0.0      # fixed cost of a flat call (the reference models none)
    FLAT_GBPS = 330         # effective flat-scan rate incl. selection
    FLAT_PER_QUERY_US = 7.0
    FALLBACK_MIN_BYTES = 64 << 20  # model validity floor (~43k x 768 bf16)
    # For CUDA devices: fitted to the host-clock ms of search_arrays(mode=
    # "probe") against the flat scan `auto` takes (K1 up to 32 queries, K2
    # above) at B = 1, 8, 32, 64, 128, 256, nprobe 16, on an NVIDIA H100
    # 80GB HBM3 at 700 W (`chip_smoke.py` phase 6c): 1M x 768 bf16 raw (C =
    # 1024), and 500k x 768 with PQ M = 192 / K = 16 packed and M = 96 / K =
    # 256. A call is host-bound there: the probe's base is its dispatch of
    # some 40 small ops (more for PQ: tables, re-rank), the flat scan's a
    # fixed 0.41 ms beside the corpus read at ~3 TB/s; K2 adds ~6.5 us a
    # query above 32. The fit is to the run with the quietest host of five;
    # all five agree where the model decides by more than the host clock's
    # spread (~40% between runs): the flat scan on both PQ indexes at every
    # batch, the probe on the raw index from B = 128. On the raw index up to
    # B = 64 the routes are 0.05-0.4 ms apart and the faster one changed from
    # run to run; the model takes the probe there. PERF.md section 6 has the
    # runs' tables.
    CUDA_COST = {
        "PROBE_BASE_MS": 0.77, "PROBE_BASE_PQ_MS": 1.40, "PROBE_STEP_US": 0.40,
        "PROBE_STEP_ADC4_US": 0.45, "PROBE_STEP_ADC8_US": 0.85, "FLAT_BASE_MS": 0.41,
        "FLAT_GBPS": 2980, "FLAT_PER_QUERY_US": 6.5,
    }

    @classmethod
    def _route_costs(cls, nbytes: int, b: int, nprobe: int, kind: str, device_type: str):
        """(flat ms, probe ms) of the cost model for a corpus of nbytes on a
        device type: probe ~ base + step x B x nprobe, flat ~ FLAT_BASE_MS
        + corpus bytes / FLAT_GBPS + FLAT_PER_QUERY_US x B. kind: "raw",
        "adc4" (nibble-packed PQ) or "adc8"."""
        def cost(name):
            return cls.CUDA_COST[name] if device_type == "cuda" else getattr(cls, name)

        flat_ms = (cost("FLAT_BASE_MS") + nbytes / (cost("FLAT_GBPS") * 1e6)
                   + cost("FLAT_PER_QUERY_US") * b / 1e3)
        base = cost("PROBE_BASE_MS" if kind == "raw" else "PROBE_BASE_PQ_MS")
        step = cost({"raw": "PROBE_STEP_US", "adc4": "PROBE_STEP_ADC4_US",
                     "adc8": "PROBE_STEP_ADC8_US"}[kind])
        return flat_ms, base + step * b * nprobe / 1e3

    def _flat_beats_probe(self, b: int, nprobe: int) -> bool:
        """Estimated-cost dispatch between the probe and the flat scan
        (`_route_costs`), with the constants of the corpus's device type."""
        c = self.corpus
        if c.capacity == 0:
            return False
        nbytes = c.capacity * c.d_pad * c.vectors.element_size()
        if nbytes < self.FALLBACK_MIN_BYTES:
            return False
        kind = "raw" if self.pq is None else ("adc4" if self._pack_nibbles else "adc8")
        flat_ms, probe_ms = self._route_costs(nbytes, b, nprobe, kind, c.vectors.device.type)
        return flat_ms < probe_ms

    def _resolve_pq_k(self) -> int:
        """pq_centroids=0 -> auto: K=16 (nibble-packed) when M % 16 == 0,
        else K=256 (the JAX package's rule)."""
        if self.pq_centroids:
            return self.pq_centroids
        return 16 if self.pq_subspaces % 16 == 0 else 256

    def _maybe_retrain(self):
        """Retrain when the corpus grew 4x past the training snapshot
        (vector_index_manager.dart:703). Engine-owned indexes
        (defer_retrain) never train on the write path."""
        if self.defer_retrain:
            return
        n = len(self.corpus)
        if not self.trained:
            if n >= self.min_train_size:
                self.train()
        elif n >= 4 * max(self._trained_size, 1):
            self.train(force=True)

    def _note_mutation(self):
        self._mutations += 1
        self._last_mut_t = time.monotonic()

    def quiescent_s(self) -> float:
        """Seconds since the last corpus mutation: background maintenance
        waits for a short quiet window, so that builds in the middle of a
        bulk load do not churn (their install would fail the mutation
        check anyway)."""
        return time.monotonic() - self._last_mut_t

    def needs_retrain(self) -> bool:
        if not self.trained:
            return len(self.corpus) >= self.min_train_size
        return len(self.corpus) >= 4 * max(self._trained_size, 1)

    # --- background (off-lock) retrain: RCU ---------------------------------

    def capture_build_state(self) -> dict:
        """Snapshot the inputs of a retrain under the caller's lock.

        The JAX package relies on its arrays being immutable. Here the
        corpus tensors are written in place (DeviceCorpus.upsert / delete),
        so they are NOT cloned and a build may read rows written after the
        capture; such a shadow is never installed, because every write
        through this index bumps `mutations` first and install refuses a
        changed count. (Cloning would double the corpus's device memory.)"""
        c = self.corpus
        return {
            "mutations": self._mutations,
            "vectors": c.vectors,
            "valid": c.valid,
            "sq_norms": c.sq_norms,
            "scales": c.scales,
            "high": c._high,
            "capacity": c.capacity,
            "live": len(c),
        }

    def build_retrained(self, cap: dict) -> "IVFVectorIndex":
        """Run the full train + bucket build against the captured tensors
        without a lock: returns a shadow index with the new layout."""
        shadow = self._shadow()
        sc = shadow.corpus
        sc.vectors = cap["vectors"]
        sc.valid = cap["valid"]
        sc.sq_norms = cap["sq_norms"]
        sc.scales = cap["scales"]
        sc._high = cap["high"]
        sc.capacity = cap["capacity"]
        sc._pk_slot = _CountOnly(cap["live"])  # train only needs len()
        shadow.train(force=True)
        return shadow

    _LAYOUT_ATTRS = (
        "centroids", "centroids_exp", "slice_bias", "_slice_cluster_dev", "_slice_cluster",
        "_slice_base", "_slice_count", "buckets_slots", "_bucket_counts",
        "_bucket_counts_dev", "_slot_dev", "_slot_cluster", "_slot_pos", "bucket_vectors",
        "bucket_bias", "bucket_scales", "pq", "codes", "bucket_codes", "_trained_size",
    )

    def install_retrained(self, cap: dict, shadow: "IVFVectorIndex") -> bool:
        """Swap the shadow's layout in; refuses when the index mutated
        since the capture (the next maintenance tick retries)."""
        if self._mutations != cap["mutations"] or not shadow.trained:
            return False
        for attr in self._LAYOUT_ATTRS:
            setattr(self, attr, getattr(shadow, attr))
        self._probe_graphs.clear()
        self._note_mutation()
        return True

    def _shadow(self) -> "IVFVectorIndex":
        return IVFVectorIndex(
            self.dims, metric=self.metric, precision=self.corpus.precision,
            num_clusters=self.num_clusters_cfg, nprobe=self.nprobe,
            pq_subspaces=self.pq_subspaces, pq_centroids=self.pq_centroids,
            rerank_factor=self.rerank_factor, min_train_size=self.min_train_size,
            pq_residual=self.pq_residual, pq_rerank=self.pq_rerank, device=self.device,
        )

    # --- background compaction (same RCU pattern) -----------------------------

    def needs_compact(self, ratio_threshold: float = 0.10) -> bool:
        c = self.corpus
        return self.trained and c.deleted_count > 0 and c.deleted_ratio >= ratio_threshold

    def capture_compact_state(self) -> dict:
        """Snapshot for an off-lock compact: the corpus tensors by
        reference (see capture_build_state), the host pk array and the
        filter-column dict copied."""
        from .filters import FilterColumns

        c = self.corpus
        fc = FilterColumns(c.device)
        fc.columns = dict(c.filter_columns.columns)
        fc.int_columns = dict(c.filter_columns.int_columns)
        return {
            "mutations": self._mutations,
            "vectors": c.vectors,
            "valid": c.valid,
            "sq_norms": c.sq_norms,
            "scales": c.scales,
            "slot_pks": c._slot_pks.copy(),
            "high": c._high,
            "filters": fc,
            "centroids": self.centroids,
            "trained_size": self._trained_size,
            "pq_book": self.pq,
        }

    def build_compacted(self, cap: dict) -> "IVFVectorIndex":
        """Re-pack live rows and rebuild the layout against the captured
        state, with no lock held (DeviceCorpus.compact's re-pack). The PQ
        codebooks carry over: the slices rebuild from the same centroids."""
        shadow = self._shadow()
        sc = shadow.corpus
        slot_pks = cap["slot_pks"]
        live = np.flatnonzero(np.asarray([pk is not None for pk in slot_pks[: cap["high"]]],
                                         np.bool_))
        m = len(live)
        gather = self._tensor(live)
        new_cap = DeviceCorpus.canonical_cap(max(m, 1))
        vec, val, nrm, scl = sc._alloc(new_cap)
        if m:
            vec[:m] = cap["vectors"][gather]
            val[:m] = True
            nrm[:m] = cap["sq_norms"][gather]
            if scl is not None:
                scl[:m] = cap["scales"][gather]
        sc.vectors, sc.valid, sc.sq_norms, sc.scales = vec, val, nrm, scl
        sc.filter_columns = cap["filters"]
        sc.filter_columns.gather_permute(gather, new_cap)
        pks = np.empty(new_cap, dtype=object)
        pks[:m] = slot_pks[live]
        sc._slot_pks = pks
        sc._pk_slot = {pk: j for j, pk in enumerate(pks[:m])}
        sc._free = []
        sc._high = m
        sc.capacity = new_cap
        shadow.centroids = cap["centroids"]
        shadow._trained_size = cap["trained_size"]
        shadow.pq = cap["pq_book"]
        if shadow.trained:
            shadow._rebuild_buckets()
        return shadow

    def install_compacted(self, cap: dict, shadow: "IVFVectorIndex") -> bool:
        if self._mutations != cap["mutations"]:
            return False
        c, scorp = self.corpus, shadow.corpus
        for attr in ("vectors", "valid", "sq_norms", "scales", "_slot_pks", "_pk_slot",
                     "_free", "_high", "capacity", "filter_columns"):
            setattr(c, attr, getattr(scorp, attr))
        c.deleted_count = 0
        for attr in self._LAYOUT_ATTRS:
            setattr(self, attr, getattr(shadow, attr))
        self._probe_graphs.clear()
        self._note_mutation()
        return True

    # --- bucket maintenance -------------------------------------------------

    ASSIGN_CHUNK = 65536  # bounds the [chunk, C] score matrix
    # slice quantum as a multiple of the average cluster size: a cluster with
    # more rows occupies ceil(count/cap) slices (duplicated centroid rows)
    BALANCE_FACTOR = 2.0
    N_CHOICES = 3  # append-path fallback choices before a full rebuild

    def _assign_clusters(self, slots: np.ndarray, n_choices: int = 1) -> np.ndarray:
        """Top-n_choices nearest clusters per slot, in f32 (the append
        path's compute type): [len(slots), n_choices]."""
        out = np.empty((len(slots), n_choices), np.int64)
        cn = torch.sum(self.centroids * self.centroids, dim=1)
        for a in range(0, len(slots), self.ASSIGN_CHUNK):
            chunk = slots[a : a + self.ASSIGN_CHUNK]
            s = torch.mm(self._stored_matrix_f32(chunk), self.centroids.t())
            if self.metric == "l2":
                s = 2.0 * s - cn[None, :]
            out[a : a + len(chunk)] = top_k_first(s, n_choices)[1].cpu().numpy()
        return out if n_choices > 1 else out[:, 0]

    def _bucket_cap(self, n_live: int) -> int:
        num_c = self.centroids.shape[0]
        avg = max(1, n_live // max(1, num_c))
        return int(max(64, round_up(int(self.BALANCE_FACTOR * avg) + 1, 64)))

    def _install_slices(self, nsl: np.ndarray, expand: bool = True):
        """Slice maps + expanded centroids from per-cluster slice counts
        (C_exp padded to a multiple of 8; padding slices get a NEG_INF probe
        bias). `expand=False` when the caller's placement step expands the
        centroids itself."""
        num_c = self.centroids.shape[0]
        total = int(nsl.sum())
        c_exp = int(round_up(max(total, 8), 8))
        sl_cl = np.full(c_exp, -1, np.int64)
        sl_cl[:total] = np.repeat(np.arange(num_c), nsl)
        base = np.zeros(num_c, np.int64)
        base[1:] = np.cumsum(nsl)[:-1]
        self._slice_cluster = sl_cl
        self._slice_cluster_dev = self._tensor(np.maximum(sl_cl, 0))
        self._slice_base = base
        self._slice_count = nsl.astype(np.int64)
        if expand:
            self.centroids_exp, self.slice_bias = _expand_centroids(
                self.centroids, self._tensor(sl_cl))
        return c_exp

    def _rebuild_buckets(self):
        """Sliced build: one assignment pass (chunked product + argmax), a
        [C] counts readback to size the slices on the host, one placement
        step. Every row lands in its first-choice cluster."""
        self._probe_graphs.clear()  # the tensors the graphs read are replaced below
        c = self.corpus
        live = self._live_slots()
        num_c = self.centroids.shape[0]
        cap = self._bucket_cap(len(live))
        if len(live):
            choices, counts = _ivf_assign_device(
                c.vectors, c.valid, self.centroids, c.scales,
                chunk=self.ASSIGN_CHUNK, l2=(self.metric == "l2"))
            counts_np = counts.cpu().numpy().astype(np.int64)
            nsl = np.maximum(1, -(-counts_np // cap))
            c_exp = self._install_slices(nsl, expand=False)
            pq_mode = self.pq is not None or self.pq_subspaces
            nbytes = c_exp * cap * c.vectors.shape[1] * c.vectors.element_size()
            with_vec = not pq_mode and nbytes <= self.CONTIG_MAX_BYTES
            (buckets, ssl, spos, scounts, bvec, bbias,
             self.centroids_exp, self.slice_bias) = _place_and_contig(
                choices, c.valid, self._tensor(self._slice_base), c.vectors, c.sq_norms,
                self.centroids, self._tensor(self._slice_cluster),
                cap=cap, c_exp=c_exp, with_vectors=with_vec,
                bias_l2=(not pq_mode and self.metric == "l2"))
            self.buckets_slots = buckets
            self._slot_dev = (ssl, spos)
            self._slot_cluster = None  # lazy host mirror, _ensure_slot_host()
            self._slot_pos = None
            self._bucket_counts = None  # lazy, _bucket_counts_host()
            self._bucket_counts_dev = scounts
            self.bucket_vectors = bvec
            self.bucket_bias = bbias if (with_vec or pq_mode) else None
            if with_vec and c.scales is not None:
                self.bucket_scales = c.scales[torch.clamp(buckets, min=0)]
            else:
                self.bucket_scales = None
            if self.pq is not None:
                self._reencode_all()
            return
        # empty corpus: one empty slice per cluster
        c_exp = self._install_slices(np.ones(num_c, np.int64))
        self.buckets_slots = torch.full((c_exp, cap), -1, dtype=torch.int64, device=self.device)
        self._slot_dev = None
        self._slot_cluster = np.full(c.capacity, -1, np.int32)
        self._slot_pos = np.full(c.capacity, -1, np.int32)
        self._bucket_counts = np.zeros(c_exp, np.int64)
        self._bucket_counts_dev = None
        self._refresh_bucket_vectors()
        if self.pq is not None:
            self._reencode_all()

    def _reencode_all(self):
        c = self.corpus
        if c.capacity == 0:
            self.codes = None
            self.bucket_codes = None
            return
        v = c.vectors.float()[:, : c.dims]
        if c.scales is not None:
            v = v * c.scales[:, None]
        if self.pq_residual:
            sl = self._slot_cluster_device()  # slice ids
            v = v - self.centroids_exp[torch.clamp(sl, min=0), : c.dims]
        self.codes = pq_encode(self.pq.codebooks, v)
        self._refresh_bucket_codes()

    @property
    def _pack_nibbles(self) -> bool:
        """4-bit codebooks pack two subspace codes per byte in the
        contiguous layout (under the JAX package's lane-alignment rule, so
        both packages pack alike)."""
        return (
            self.pq is not None
            and self.pq.k == 16
            and self.pq.m % 2 == 0
            and (self.pq.m * self.pq.k) % 256 == 0
        )

    @staticmethod
    def _pack_codes(codes: torch.Tensor) -> torch.Tensor:
        """[N, M] 4-bit values -> [N, M/2] u8: byte j = sub 2j | sub 2j+1."""
        return (codes[:, 0::2] << 4 | codes[:, 1::2]).to(torch.uint8)

    def _refresh_bucket_codes(self):
        if self.codes is None or self.buckets_slots is None:
            self.bucket_codes = None
            return
        if not adc_kernel_supported(self.pq.m, self.pq.k):
            self.bucket_codes = None  # code-gather path, as in the JAX package
            return
        codes = self._pack_codes(self.codes) if self._pack_nibbles else self.codes
        gathered = codes[torch.clamp(self.buckets_slots, min=0)]  # [C, cap, M']
        self.bucket_codes = gathered.permute(0, 2, 1).contiguous()

    def _refresh_bucket_vectors(self):
        self._probe_graphs.clear()  # the tensors the graphs read are replaced below
        c = self.corpus
        num_c, cap = self.buckets_slots.shape
        if self.pq is not None or self.pq_subspaces:
            # PQ mode scans contiguous CODES; validity-only bias
            self.bucket_vectors = None
            self.bucket_bias = _bucket_bias(self.buckets_slots, c.valid, c.sq_norms, l2=False)
            return
        nbytes = num_c * cap * c.vectors.shape[1] * c.vectors.element_size()
        if nbytes > self.CONTIG_MAX_BYTES:
            self.bucket_vectors = None
            self.bucket_bias = None
            self.bucket_scales = None
            return
        safe = torch.clamp(self.buckets_slots, min=0)
        self.bucket_vectors = c.vectors[safe]
        self.bucket_bias = _bucket_bias(self.buckets_slots, c.valid, c.sq_norms,
                                        l2=(self.metric == "l2"))
        self.bucket_scales = c.scales[safe] if c.scales is not None else None

    def _append_to_buckets(self, slots: np.ndarray, choices: np.ndarray):
        """Append past the high-water mark of each row's choice cluster's
        slices (first choice first; delete holes are reclaimed by the next
        rebuild or compact); a cluster whose slices are all full falls to
        the 2nd/3rd choice, and a full overflow rebuilds."""
        cap = self.buckets_slots.shape[1]
        slots = np.asarray(slots)
        counts = self._bucket_counts_host()  # [C_exp], updated in place
        base, nsl = self._slice_base, self._slice_count
        cl_out = np.full(len(slots), -1, np.int64)  # slice ids
        pos_out = np.full(len(slots), -1, np.int64)
        pending = np.arange(len(slots))
        for choice in range(choices.shape[1]):
            if not len(pending):
                break
            want = choices[pending, choice]
            still = []
            for cl in np.unique(want):
                rows = pending[want == cl]
                sls = np.arange(base[cl], base[cl] + nsl[cl])
                free = np.maximum(cap - counts[sls], 0)
                cumfree = np.cumsum(free)
                total = int(cumfree[-1]) if len(cumfree) else 0
                take, rest = rows[:total], rows[total:]
                if len(take):
                    offs = np.arange(len(take))
                    si = np.searchsorted(cumfree, offs, side="right")
                    prev = np.where(si > 0, cumfree[np.maximum(si - 1, 0)], 0)
                    sl_ids = sls[si]
                    cl_out[take] = sl_ids
                    pos_out[take] = counts[sl_ids] + (offs - prev)
                    np.add.at(counts, sl_ids, 1)
                if len(rest):
                    still.append(rest)
            pending = np.concatenate(still) if still else pending[:0]
        if len(pending):
            self._rebuild_buckets()
            return
        self._ensure_slot_arrays()
        self._slot_cluster[slots] = cl_out.astype(np.int32)
        self._slot_pos[slots] = pos_out.astype(np.int32)
        cl_t, pos_t, slot_t = self._tensor(cl_out), self._tensor(pos_out), self._tensor(slots)
        self.buckets_slots[cl_t, pos_t] = slot_t
        c = self.corpus
        if self.bucket_vectors is not None:
            self.bucket_vectors[cl_t, pos_t] = c.vectors[slot_t]
            bias = (-c.sq_norms[slot_t] if self.metric == "l2"
                    else torch.zeros(len(slots), dtype=torch.float32, device=self.device))
            self.bucket_bias[cl_t, pos_t] = bias
            if self.bucket_scales is not None:
                self.bucket_scales[cl_t, pos_t] = c.scales[slot_t]
        elif self.bucket_bias is not None:  # PQ mode: validity-only bias
            self.bucket_bias[cl_t, pos_t] = 0.0

    def _vacate(self, slots: np.ndarray):
        """Clear the bucket entries of assigned slots (-1 / NEG_INF)."""
        assigned = slots[self._slot_cluster[slots] >= 0]
        if len(assigned) and self.buckets_slots is not None:
            cls = self._tensor(self._slot_cluster[assigned])
            ps = self._tensor(self._slot_pos[assigned])
            self.buckets_slots[cls, ps] = -1
            if self.bucket_bias is not None:
                self.bucket_bias[cls, ps] = NEG_INF
        self._slot_cluster[slots] = -1
        self._slot_pos[slots] = -1

    # --- mutation -------------------------------------------------------------

    def upsert(self, pks, vectors: np.ndarray):
        self._note_mutation()
        pks = list(pks)
        existing = [pk for pk in pks if pk in self.corpus._pk_slot]
        slots = self.corpus.upsert(pks, vectors)
        self._maybe_retrain()
        if not self.trained:
            return slots
        self._ensure_slot_arrays()
        if existing:
            # overwritten vectors may change cluster: vacate their old
            # entries (holes are skipped in search, reclaimed at the rebuild)
            eslots = self.corpus.slots_for_pks(existing)
            self._vacate(eslots[eslots >= 0])
        fresh = np.asarray(slots, np.int64)
        fresh = fresh[self._slot_cluster[fresh] < 0]
        if len(fresh):
            self._append_to_buckets(fresh, self._assign_clusters(fresh, self.N_CHOICES))
        if self.pq is not None:
            self._encode_slots(np.asarray(slots, np.int64))
        return slots

    def _encode_slots(self, slots: np.ndarray):
        """PQ codes of freshly written slots, into `codes` and (when
        placed) the contiguous bucket codes."""
        c = self.corpus
        v = self._stored_matrix_f32(slots)[:, : c.dims]
        self._ensure_slot_host()
        if self.pq_residual:
            # placement (possibly via rebuild) gave every fresh slot a slice
            sl = self._slot_cluster[slots]
            v = v - self.centroids_exp[self._tensor(np.maximum(sl, 0)), : c.dims]
        codes = pq_encode(self.pq.codebooks, v)
        if self.codes is None or self.codes.shape[0] < c.capacity:
            grown = torch.zeros((c.capacity, self.pq.m), dtype=torch.uint8, device=self.device)
            if self.codes is not None:
                grown[: self.codes.shape[0]] = self.codes
            self.codes = grown
        self.codes[self._tensor(slots)] = codes
        if self.bucket_codes is not None:
            cl = self._slot_cluster[slots]
            ps = self._slot_pos[slots]
            placed = cl >= 0
            if placed.any():
                scatter = self._pack_codes(codes) if self._pack_nibbles else codes
                self.bucket_codes[self._tensor(cl[placed]), :, self._tensor(ps[placed])] = \
                    scatter[self._tensor(np.flatnonzero(placed))]

    def delete(self, pks) -> int:
        self._note_mutation()
        # vacate bucket entries eagerly: a freed slot may be reused by a new
        # vector, and a stale entry would surface it from the wrong cluster
        slots = self.corpus.slots_for_pks(pks)
        n = self.corpus.delete(pks)
        live = slots[slots >= 0]
        if len(live):
            self._ensure_slot_host()
            if len(self._slot_cluster):
                self._vacate(live)
        return n

    def compact(self):
        self._note_mutation()
        self.corpus.compact()
        if self.trained:
            self._rebuild_buckets()

    def maybe_compact(self, ratio_threshold: float = 0.10):
        """Tombstone compaction trigger, the reference's 10% rule."""
        if self.corpus.deleted_ratio >= ratio_threshold and self.corpus.deleted_count > 0:
            self.compact()
            return True
        return False

    # --- search ---------------------------------------------------------------

    def _choose_dispatch(self, q, slot_mask: torch.Tensor | None, nprobe: int | None,
                         mode: str) -> tuple:
        """The device work of a search for `run_search`, as (dispatch, its
        arguments): the flat view's scan where it answers (an untrained
        index, mode 'exact', or a batch the flat scan serves faster than the
        probe), else the probe."""
        c = self.corpus
        qn = np.asarray(q)
        b_est = 1 if qn.ndim == 1 else qn.shape[0]
        if len(c) and not self.trained and mode != "exact" and not self.defer_retrain:
            # library-direct index: lazy first train (engine-owned indexes
            # stay on the flat scan until background maintenance trains)
            self.train()
        np_est = min(int(nprobe or self.nprobe),
                     self.centroids_exp.shape[0] if self.trained else 1)
        if (not self.trained or mode == "exact"
                or (mode != "probe" and self._flat_beats_probe(b_est, np_est))):
            return self._flat._dispatch, slot_mask, mode if mode in ("exact", "fast") else "auto"
        return self._probe, slot_mask, nprobe

    def _probe_graph_tensors(self) -> tuple:
        """The index's tensors that the raw contiguous probe's stages read,
        whose identities key its CUDA graphs."""
        return (self.centroids, self._slice_cluster_dev, self.slice_bias, self.buckets_slots,
                self.bucket_vectors, self.bucket_scales, self.bucket_bias)

    def _probe_index(self) -> ProbeIndex:
        """What `_ivf_probe` reads of this index (codebooks only where codes
        exist)."""
        c = self.corpus
        pq = self.pq is not None and (self.bucket_codes is not None or self.codes is not None)
        # positional, in field order: keywords cost twice as much on the search path
        return ProbeIndex(
            self.metric, c.dims, self.pq_residual, self.centroids, self._slice_cluster_dev,
            self.slice_bias, self.centroids_exp, self.buckets_slots, c.vectors, c.scales,
            c.valid, c.sq_norms, self.bucket_vectors, self.bucket_scales, self.bucket_bias,
            self.pq.codebooks if pq else None, self.codes, self.bucket_codes)

    def _probe(self, qt, qsq, k: int, hold, slot_mask: torch.Tensor | None,
               nprobe: int | None):
        """The probe's device work for `run_search`: (distances, slots) on
        the device from `_ivf_probe`. Where `_probe_graph_eligible` holds,
        its stages run through the CUDA graphs of the key (the search's
        shape; ops/graphs.py), whose entry's release goes to `hold`."""
        # nprobe counts SLICES: the scan budget is ~nprobe*cap rows
        np_probe = min(int(nprobe or self.nprobe), self.centroids_exp.shape[0])
        t = self._probe_index()
        raw_contig = t.codebooks is None and t.bucket_vectors is not None
        key = ((qt.shape[0], k, np_probe, self.metric)
               if _probe_graph_eligible(qt.device, raw_contig, slot_mask is not None,
                                        qt.shape[0]) else None)
        g = self._probe_graphs.stages(key, self._probe_graph_tensors(), qt, qsq)
        hold.append(g.release)
        qt, qsq = g.inputs
        # the re-rank pool: the JAX package's recall-derived floor of 512
        pool = self.pq_rerank or max(self.rerank_factor * k, 51 * k, 512)
        out = _ivf_probe(qt, t, k=k, nprobe=np_probe, rerank=pool, slot_mask=slot_mask,
                         run=g.run,
                         finish=lambda s, i: D.finalize_results(self.metric, s, i, qsq))
        if g.graphed:  # counted once the stages ran
            if g.captures:
                _kernels.count(PROBE_LAUNCHES, "ivf_probe_graph_capture")
            _kernels.count(PROBE_LAUNCHES, "ivf_probe_graph")
        return out

    def search_arrays(self, q, k: int, slot_mask: torch.Tensor | None = None,
                      nprobe: int | None = None, mode: str = "auto"):
        """Returns (distances [B, k], slots [B, k], pks [B, k]).

        mode='exact' bypasses the probe and runs the exact flat scan over
        the whole corpus (vector_index_manager.dart:475)."""
        return run_search(self.corpus, self.metric, q, k,
                          *self._choose_dispatch(q, slot_mask, nprobe, mode))

    def search(self, q, top_k: int = 10, threshold=None, slot_mask=None, nprobe=None,
               mode: str = "auto") -> list[VectorSearchResult]:
        return run_search(self.corpus, self.metric, q, top_k,
                          *self._choose_dispatch(q, slot_mask, nprobe, mode),
                          hits=True, threshold=threshold)

    # --- persistence ----------------------------------------------------------

    def state_dict(self) -> dict:
        """The JAX package's snapshot format (convert.py)."""
        from ..convert import ivf_index_to_reference_state

        return ivf_index_to_reference_state(self)

    @staticmethod
    def from_state_dict(d: dict, *, device) -> "IVFVectorIndex":
        from ..convert import ivf_index_from_reference

        return ivf_index_from_reference(d, device)
