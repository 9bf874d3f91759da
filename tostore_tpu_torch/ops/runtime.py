"""Constants and padding helpers shared by the port's kernels
(counterpart of `tostore_tpu/ops/runtime.py`).

Device corpora are block-padded, so every kernel sees aligned shapes:
rows in multiples of ROW_BLOCK, columns in multiples of LANE. The kernels
on the card keep these units because the candidate buckets of the lane
top-k contract (ops/topk.py) are defined by them, not by the hardware.
"""

from __future__ import annotations

import numpy as np
import torch

# Row-block granularity for device corpora: the fused top-k kernel's
# corpus block, so capacities are always kernel-aligned.
ROW_BLOCK = 2048

# Lane width: a corpus row's candidate bucket within a block is row % LANE.
LANE = 128

# float32 min, not -inf: invalid rows carry this bias, so their scores stay
# finite and a miss is `score <= NEG_INF / 2`.
NEG_INF = float(np.finfo(np.float32).min)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_rows(a, n_rows: int, fill=0):
    """Pad axis 0 of a numpy array or tensor up to `n_rows` with `fill`."""
    cur = a.shape[0]
    if cur == n_rows:
        return a
    if cur > n_rows:
        raise ValueError(f"cannot pad {cur} rows down to {n_rows}")
    if isinstance(a, np.ndarray):
        pad_width = [(0, n_rows - cur)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, pad_width, constant_values=fill)
    pad = [0, 0] * (a.ndim - 1) + [0, n_rows - cur]
    return torch.nn.functional.pad(a, pad, value=fill)


def pad_cols(a, n_cols: int, fill=0):
    """Pad the trailing axis of a numpy array or tensor up to `n_cols`."""
    cur = a.shape[-1]
    if cur == n_cols:
        return a
    if cur > n_cols:
        raise ValueError(f"cannot pad {cur} cols down to {n_cols}")
    if isinstance(a, np.ndarray):
        pad_width = [(0, 0)] * (a.ndim - 1) + [(0, n_cols - cur)]
        return np.pad(a, pad_width, constant_values=fill)
    return torch.nn.functional.pad(a, (0, n_cols - cur), value=fill)


def score_dtype(corpus_dtype: torch.dtype) -> torch.dtype:
    """Type the queries are rounded to before the dot: the corpus's own, or
    bf16 for an int8 corpus (int8 storage is scored as bf16 values)."""
    return torch.bfloat16 if corpus_dtype == torch.int8 else corpus_dtype


def f32_dot(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[B, D] x [M, D]^T -> [B, M] float32 with every product exact in f32.

    `q` is already in `score_dtype(c.dtype)`. f32 corpora contract in true
    f32: callers keep TF32 off (torch's default), as the JAX package asks
    for Precision.HIGHEST. Products of bf16 values are exact in f32, so a
    bf16 (or int8-as-bf16) corpus only differs from f32 in summation order:
    on the card it multiplies in bf16 with f32 output; elsewhere it widens
    to f32 first (torch's CPU bf16 matmul rounds its output to bf16)."""
    if c.dtype == torch.int8:
        c = c.to(torch.bfloat16)
    if c.dtype == torch.bfloat16 and c.is_cuda:
        return torch.mm(q, c.t(), out_dtype=torch.float32)
    return torch.mm(q.float(), c.float().t())
