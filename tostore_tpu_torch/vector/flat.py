"""FlatVectorIndex: kNN by a full scan of a DeviceCorpus (counterpart of
`tostore_tpu/vector/flat.py`).

The whole corpus is scored in one fused scan (ops/topk.py). Distance and
score semantics are the reference's (primaryKey, distance, score mapping
vector_index_manager.dart:1411-1423), including cosine query normalization
(:518) and the optional distance threshold.

A slot mask (bool [capacity] tensor on the corpus's device) folds into the
kernel's bias, so a filtered search costs the same scan.

On K1's route (`ops.topk.flat_route`, chosen on the whole capacity) the
scan reads only the corpus's live prefix (`ScanState.prefix`): the slots
past it were never used, so the answer is the whole capacity's, bit for
bit. On a CUDA corpus that route's bias, K1 and `finalize_results` run as
one stage through the CUDA graphs of the corpus's `ScanState`
(ops/graphs.py), keyed by the search's shape and the prefix's tensors.

`run_search` is the one skeleton of a single-device search, the flat
scan's and the IVF probe's (vector/ivf.py): an index supplies only its
device work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.results import VectorSearchResult
from ..ops import _kernels
from ..ops import distance as D
from ..ops import topk as T
from ..ops.graphs import GraphCache
from ..ops.runtime import ROW_BLOCK, round_up
from ..utils.spans import span
from .corpus import DeviceCorpus

_METRIC_ALIASES = {
    "cosine": "cosine",
    "l2": "l2",
    "innerProduct": "dot",
    "dot": "dot",
}


def hits_of(metric: str, dist: np.ndarray, hit: np.ndarray, pks: np.ndarray,
            threshold: float | None) -> list[VectorSearchResult]:
    """One query's results with the reference's semantics: places where
    `hit` is False (no row) and non-finite distances dropped, the distance
    threshold applied, the score mapped from the distance; in the order
    given."""
    finite = np.isfinite(dist)
    score = D.distances_to_scores(
        metric, torch.from_numpy(np.where(finite, dist, 0))
    ).numpy()
    keep = hit & finite
    if threshold is not None:
        keep &= ~(dist > threshold)
    return [
        VectorSearchResult(primary_key=p, distance=d, score=s)
        for p, d, s in zip(pks[keep].tolist(), dist[keep].tolist(), score[keep].tolist())
    ]


def prep_queries(corpus: DeviceCorpus, metric: str, q) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """The queries as a scan of `corpus` reads them, on its device: [B,
    d_pad] f32 rows (unit length for cosine, zero-padded), the squared
    norms of the queries as given [B] f32, and whether `q` was one query.
    A query of another dimension than the corpus's raises ValueError."""
    q = np.asarray(q, np.float32)
    single = q.ndim == 1
    if single:
        q = q[None, :]
    if q.shape[1] != corpus.dims:
        raise ValueError(f"query dims {q.shape[1]} != index dims {corpus.dims}")
    qsq = torch.from_numpy(np.sum(q * q, axis=1)).to(corpus.device)
    if metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    if corpus.d_pad != q.shape[1]:
        q = np.pad(q, ((0, 0), (0, corpus.d_pad - q.shape[1])))
    return torch.from_numpy(np.ascontiguousarray(q)).to(corpus.device), qsq, single


def to_host(dist: torch.Tensor, slots: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """A search's copy down: (distances f32, slots int64) as host arrays."""
    return dist.cpu().numpy().astype(np.float32), slots.cpu().numpy().astype(np.int64)


def search_host(corpus: DeviceCorpus, metric: str, q, k: int, dispatch,
                *args) -> tuple[np.ndarray, np.ndarray]:
    """(distances [B, k] f32, slots [B, k] i64, -1 for no-hit) on the host:
    inf / -1 for an empty corpus; else the queries' preparation, the index's
    device work `dispatch(qt, qsq, k, hold, *args)` -> (distances, slots) on
    the device, and their copy down, each a span. A dispatch whose outputs
    live in buffers it holds (a CUDA-graph entry, ops/graphs.py) appends
    their release to the list `hold`, called after the copy down on every
    path."""
    if corpus.capacity == 0 or len(corpus) == 0:
        b = 1 if np.asarray(q).ndim == 1 else np.asarray(q).shape[0]
        return np.full((b, k), np.inf, np.float32), np.full((b, k), -1, np.int64)
    with span("vector_search.prep"):
        qt, qsq, _ = prep_queries(corpus, metric, q)
    hold = []
    try:
        with span("vector_search.dispatch"):
            d_dev, s_dev = dispatch(qt, qsq, k, hold, *args)
        with span("vector_search.wait"):
            return to_host(d_dev, s_dev)
    finally:
        for release in hold:
            release()


def run_search(corpus: DeviceCorpus, metric: str, q, k: int, dispatch, *args,
               hits: bool = False, threshold: float | None = None):
    """`search_host`, then the results stage (a span): (distances, slots,
    pks [B, k] object), or with `hits` the first query's `hits_of`."""
    dist, slots = search_host(corpus, metric, q, k, dispatch, *args)
    with span("vector_search.results"):
        if hits:
            return hits_of(metric, dist[0], slots[0] >= 0, corpus.pks_for_slots(slots[0]),
                           threshold)
        return dist, slots, corpus.pks_for_slots(slots)


class ScanState:
    """What the flat scan derives from a corpus's tensors, held as its
    `DeviceCorpus.scan` (dropped where the corpus replaces them): the views
    of its live prefix and the CUDA graphs of K1's route over them."""

    def __init__(self):
        self.graphs = GraphCache()
        self._prefix = None  # (rows, the tensors cut, their views)

    def prefix(self, c: DeviceCorpus) -> tuple:
        """(vectors, valid, sq_norms, scales) of `c` cut to the slots a scan
        on K1's route reads: the high-water mark rounded up to whole K1
        blocks (ROW_BLOCK), at most the capacity. Slots at and past `_high`
        were never used: invalid, zero rows. The views are made once per
        length and set of tensors: cut anew, four tensors cost a search
        ~4 us of host time."""
        n = min(c.capacity, round_up(c._high, ROW_BLOCK))
        got = self._prefix
        if got is not None and got[0] == n:
            v, va, nr, sc = got[1]
            if v is c.vectors and va is c.valid and nr is c.sq_norms and sc is c.scales:
                return got[2]
        base = (c.vectors, c.valid, c.sq_norms, c.scales)
        views = tuple(None if t is None else t[:n] for t in base)
        self._prefix = (n, base, views)
        return views


def scan_state(c: DeviceCorpus) -> ScanState:
    """The corpus's `ScanState`, made on first use."""
    st = c.scan
    if st is None:
        st = c.scan = ScanState()
    return st


class FlatVectorIndex:
    """Flat full-scan index: metric in {'cosine','l2','dot'/'innerProduct'}.

    mode='auto' (default) may use the per-lane candidate selection (miss
    probability ~1e-5..1e-8 per query, ops/topk.py docstring);
    mode='exact' forces the exact chunked scan; mode='fused' forces the
    fused kernels; mode='fast' is served as 'auto' (the TPU's binned top-k
    has no counterpart on the card)."""

    index_type = "flat"
    search_mode = "auto"

    def __init__(self, dims: int, metric: str = "cosine", precision: str = "float32",
                 *, device):
        name = _METRIC_ALIASES.get(metric)
        if name is None:
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = name
        self.corpus = DeviceCorpus(dims, precision, normalize=(name == "cosine"),
                                   device=device)

    @property
    def device(self) -> torch.device:
        return self.corpus.device

    # --- mutation -------------------------------------------------------------

    def upsert(self, pks, vectors: np.ndarray):
        return self.corpus.upsert(pks, vectors)

    def delete(self, pks) -> int:
        return self.corpus.delete(pks)

    def compact(self):
        self.corpus.compact()

    def maybe_compact(self, ratio_threshold: float = 0.10):
        """Tombstone compaction trigger, reference 10% rule (vim:897)."""
        if self.corpus.deleted_ratio >= ratio_threshold and self.corpus.deleted_count > 0:
            self.corpus.compact()
            return True
        return False

    def __len__(self):
        return len(self.corpus)

    @property
    def dims(self):
        return self.corpus.dims

    # --- search -----------------------------------------------------------------

    def _prep_queries(self, q: np.ndarray):
        return prep_queries(self.corpus, self.metric, q)

    def _bias_alpha(self, slot_mask: torch.Tensor | None, tensors: tuple | None = None):
        """Per-slot additive bias folding the metric term, tombstones and
        the slot mask; plus the matmul scale alpha and the per-row int8
        dequant factors (sq_norms are stored dequantized, so only the q.e
        product needs them). Over `tensors` (vectors, valid, sq_norms,
        scales), by default the whole corpus's."""
        c = self.corpus
        _, valid, sq_norms, scales = tensors or (None, c.valid, c.sq_norms, c.scales)
        if slot_mask is not None:
            valid = torch.logical_and(valid, slot_mask)
        norms = sq_norms if self.metric == "l2" else None
        alpha = D.metric_alpha(self.metric)
        bias = D.make_bias(self.metric, norms, valid)
        return bias, alpha, scales

    def _dispatch(self, qt, qsq, k: int, hold, slot_mask: torch.Tensor | None, mode: str):
        """The flat scan's device work for `run_search`: (distances, slots)
        on the device. K1's route reads the live prefix, on a CUDA corpus
        as one stage of the CUDA graphs of the key (B, k, masked, mode),
        whose entry's release goes to `hold`; the other routes scan the
        whole capacity eagerly."""
        c = self.corpus
        b = qt.shape[0]
        if T.flat_route(b, c.vectors.shape, c.dtype, qt.device.type, k, mode) != "k1":
            return self._scan((c.vectors, c.valid, c.sq_norms, c.scales), mode, k, qt, qsq,
                              slot_mask)
        st = scan_state(c)
        prefix = st.prefix(c)
        inputs = (qt, qsq) if slot_mask is None else (qt, qsq, slot_mask[: prefix[0].shape[0]])
        key = (b, k, slot_mask is not None, mode) if qt.is_cuda else None
        g = st.graphs.stages(key, prefix, *inputs)
        hold.append(g.release)
        out = g.run(0, lambda: self._scan(prefix, "fused", k, *g.inputs))
        if g.graphed:  # counted once the stage ran
            if g.captures:
                _kernels.count(T.LAUNCHES, "flat_graph_capture")
            _kernels.count(T.LAUNCHES, "flat_graph")
        return out

    def _scan(self, tensors: tuple, mode: str, k: int, qt, qsq, mask=None):
        """`flat_search` over `tensors` (vectors, valid, sq_norms, scales:
        the whole corpus's, or its live prefix's with mode 'fused'): the
        bias (a span, the slot mask ANDed in), the scan, `finalize_results`."""
        with span("vector_search.bias"):
            bias, alpha, row_scale = self._bias_alpha(mask, tensors)
        scores, idx = T.flat_search(qt, tensors[0], bias, k=k, alpha=alpha, mode=mode,
                                    row_scale=row_scale)
        return D.finalize_results(self.metric, scores, idx, qsq)

    def search_arrays(self, q: np.ndarray, k: int,
                      slot_mask: torch.Tensor | None = None,
                      mode: str = "auto") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch search. Returns (distances [B,k] f32, slots [B,k] i64 with
        -1 for no-hit, pks [B,k] object)."""
        return run_search(self.corpus, self.metric, q, k, self._dispatch, slot_mask, mode)

    def search(self, q: np.ndarray, top_k: int = 10, threshold: float | None = None,
               slot_mask: torch.Tensor | None = None,
               mode: str = "auto") -> list[VectorSearchResult]:
        """Single-query search with reference result semantics."""
        return run_search(self.corpus, self.metric, q, top_k, self._dispatch, slot_mask, mode,
                          hits=True, threshold=threshold)

    # --- persistence ---------------------------------------------------------

    def state_dict(self) -> dict:
        """The JAX package's snapshot format (convert.py)."""
        from ..convert import flat_index_to_reference_state

        return flat_index_to_reference_state(self)

    @staticmethod
    def from_state_dict(d: dict, *, device) -> "FlatVectorIndex":
        from ..convert import flat_index_from_reference

        return flat_index_from_reference(d, device)
