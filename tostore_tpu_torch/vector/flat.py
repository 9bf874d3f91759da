"""FlatVectorIndex: kNN by a full scan of a DeviceCorpus (counterpart of
`tostore_tpu/vector/flat.py`).

The whole corpus is scored in one fused scan (ops/topk.py). Distance and
score semantics are the reference's (primaryKey, distance, score mapping
vector_index_manager.dart:1411-1423), including cosine query normalization
(:518) and the optional distance threshold.

A slot mask (bool [capacity] tensor on the corpus's device) folds into the
kernel's bias, so a filtered search costs the same scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.results import VectorSearchResult
from ..ops import distance as D
from ..ops import topk as T
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

    def _bias_alpha(self, slot_mask: torch.Tensor | None):
        """Per-slot additive bias folding the metric term, tombstones and
        the slot mask; plus the matmul scale alpha and the per-row int8
        dequant factors (sq_norms are stored dequantized, so only the q.e
        product needs them)."""
        c = self.corpus
        valid = c.valid
        if slot_mask is not None:
            valid = torch.logical_and(valid, slot_mask)
        norms = c.sq_norms if self.metric == "l2" else None
        alpha = D.metric_alpha(self.metric)
        bias = D.make_bias(self.metric, norms, valid)
        return bias, alpha, c.scales

    def _scan(self, q: np.ndarray, k: int, slot_mask: torch.Tensor | None,
              mode: str) -> tuple[np.ndarray, np.ndarray]:
        """(distances [B, k] f32, slots [B, k] i64 with -1 for no-hit):
        the queries' preparation, the scan and selection enqueued on the
        device, and the wait for their copy down, each a span."""
        c = self.corpus
        if c.capacity == 0 or len(c) == 0:
            b = 1 if np.asarray(q).ndim == 1 else np.asarray(q).shape[0]
            return np.full((b, k), np.inf, np.float32), np.full((b, k), -1, np.int64)
        with span("vector_search.prep"):
            qt, qsq, _ = self._prep_queries(q)
        with span("vector_search.dispatch"):
            with span("vector_search.bias"):
                bias, alpha, row_scale = self._bias_alpha(slot_mask)
            scores, idx = T.flat_search(
                qt, c.vectors, bias, k=k, alpha=alpha, mode=mode, row_scale=row_scale
            )
            d_dev, s_dev = D.finalize_results(self.metric, scores, idx, qsq)
        with span("vector_search.wait"):
            return to_host(d_dev, s_dev)

    def search_arrays(self, q: np.ndarray, k: int,
                      slot_mask: torch.Tensor | None = None,
                      mode: str = "auto") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch search. Returns (distances [B,k] f32, slots [B,k] i64 with
        -1 for no-hit, pks [B,k] object)."""
        dist, slots = self._scan(q, k, slot_mask, mode)
        with span("vector_search.results"):
            return dist, slots, self.corpus.pks_for_slots(slots)

    def search(self, q: np.ndarray, top_k: int = 10, threshold: float | None = None,
               slot_mask: torch.Tensor | None = None,
               mode: str = "auto") -> list[VectorSearchResult]:
        """Single-query search with reference result semantics."""
        dist, slots = self._scan(q, top_k, slot_mask, mode)
        with span("vector_search.results"):
            return hits_of(self.metric, dist[0], slots[0] >= 0,
                           self.corpus.pks_for_slots(slots[0]), threshold)

    # --- persistence ---------------------------------------------------------

    def state_dict(self) -> dict:
        """The JAX package's snapshot format (convert.py)."""
        from ..convert import flat_index_to_reference_state

        return flat_index_to_reference_state(self)

    @staticmethod
    def from_state_dict(d: dict, *, device) -> "FlatVectorIndex":
        from ..convert import flat_index_from_reference

        return flat_index_from_reference(d, device)
