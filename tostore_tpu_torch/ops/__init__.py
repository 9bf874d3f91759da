"""Kernel substrate of the port: distance scoring and the flat top-k scan.

Plain tensor code is PyTorch; the TPU's Pallas kernels are CUDA kernels
written for Hopper (csrc/), launched by the wrappers in ops/topk.py.
"""

from .distance import (
    distances_to_scores,
    l2_norms,
    normalize,
    score_matrix,
    scores_to_distances,
)
from .runtime import pad_rows, round_up
from .topk import flat_search, flat_topk_lane, flat_topk_xla, fused_flat_topk

__all__ = [
    "round_up",
    "pad_rows",
    "l2_norms",
    "normalize",
    "score_matrix",
    "scores_to_distances",
    "distances_to_scores",
    "flat_topk_xla",
    "flat_topk_lane",
    "fused_flat_topk",
    "flat_search",
]
