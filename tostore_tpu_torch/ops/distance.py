"""Distance / similarity scoring (counterpart of `tostore_tpu/ops/distance.py`).

Every metric is one `[B, D] x [D, N]` product plus a per-row bias, so the
lane top-k kernels (ops/topk.py) treat all three metrics alike:

    score = alpha * (q @ corpus.T) + bias            (higher is better)

    dot    : alpha = 1, bias = 0,           distance = -score
    cosine : alpha = 1, bias = 0 (inputs L2-normalized), distance = 1 - score
    l2     : alpha = 2, bias = -||c||^2,    squared distance = ||q||^2 - score

Invalid, tombstoned and padded rows carry bias NEG_INF. The user-facing
score mapping is the reference's (vector_index_manager.dart:1411-1423):
l2 -> 1/(1+d), ip -> sigmoid(ip), cosine -> 1 - d.
"""

from __future__ import annotations

import numpy as np
import torch

from .runtime import NEG_INF, f32_dot, score_dtype

METRICS = ("cosine", "l2", "dot")


def l2_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 norms per row, f32."""
    xf = x.float()
    return torch.sum(xf * xf, dim=-1)


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (xf / torch.clamp(n, min=eps)).to(x.dtype)


def metric_alpha(metric: str) -> float:
    return 2.0 if metric == "l2" else 1.0


def make_bias(metric: str, corpus_sq_norms: torch.Tensor | None,
              valid: torch.Tensor) -> torch.Tensor:
    """Per-corpus-row additive bias folding the metric term and validity.

    valid: bool [N]; corpus_sq_norms: f32 [N] (required for l2).
    """
    if metric == "l2":
        if corpus_sq_norms is None:
            raise ValueError("l2 metric requires corpus squared norms")
        bias = -corpus_sq_norms.float()
    else:
        bias = torch.zeros(valid.shape, dtype=torch.float32, device=valid.device)
    return torch.where(valid, bias, torch.full_like(bias, NEG_INF))


def score_matrix(q: torch.Tensor, corpus: torch.Tensor, bias: torch.Tensor,
                 alpha: float) -> torch.Tensor:
    """Unfused scorer: [B, N] f32 scores. Used as an oracle."""
    s = f32_dot(q.to(score_dtype(corpus.dtype)), corpus)
    return alpha * s + bias[None, :]


def scores_to_distances(metric: str, scores: torch.Tensor,
                        q_sq_norms: torch.Tensor | None) -> torch.Tensor:
    """Convert kernel scores back to the metric's true distance.

    q_sq_norms: f32 [B] squared L2 norms of the (pre-normalization) queries.
    """
    if metric == "dot":
        return -scores
    if metric == "cosine":
        return 1.0 - scores
    if metric == "l2":
        return torch.sqrt(torch.clamp(q_sq_norms[:, None] - scores, min=0.0))
    raise ValueError(f"unknown metric {metric!r}")


def scores_to_distances_np(metric: str, scores, q_sq_norms) -> np.ndarray:
    """Host-side scores_to_distances for results already read back."""
    scores = np.asarray(scores, np.float32)
    if metric == "dot":
        return -scores
    if metric == "cosine":
        return (1.0 - scores).astype(np.float32)
    if metric == "l2":
        q = np.asarray(q_sq_norms, np.float32)
        return np.sqrt(np.maximum(q[:, None] - scores, 0.0)).astype(np.float32)
    raise ValueError(f"unknown metric {metric!r}")


def finalize_results(metric: str, scores: torch.Tensor, slots: torch.Tensor,
                     q_sq_norms: torch.Tensor):
    """Miss-masking plus distance conversion on the device, so the host
    reads back two arrays (distances, slots) per search. A miss is
    `score <= NEG_INF / 2`: slot -1, distance inf."""
    miss = scores <= NEG_INF / 2
    d = scores_to_distances(metric, scores, q_sq_norms)
    d = torch.where(miss, torch.full_like(d, float("inf")), d)
    s = torch.where(miss, torch.full_like(slots, -1), slots)
    return d, s


def distances_to_scores(metric: str, distances: torch.Tensor) -> torch.Tensor:
    """User-facing relevance score, identical to the reference mapping
    (vector_index_manager.dart:1411-1423)."""
    if metric == "l2":
        return 1.0 / (1.0 + distances)
    if metric == "dot":
        return torch.sigmoid(-distances)
    if metric == "cosine":
        return 1.0 - distances
    raise ValueError(f"unknown metric {metric!r}")
