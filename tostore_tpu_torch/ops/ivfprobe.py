"""IVF bucket scans over bucket-contiguous layouts (counterpart of
`tostore_tpu/ops/ivfprobe.py`): kernels K3 and K4.

  - `bucket_probe_scores` (K3, `ivf_bucket_probe` in csrc/ivf_probe.cu):
    for each (query b, probe p) the [cap, D] bucket `probes[b, p]` of the
    contiguous corpus copy is scored against q_b:
        s[b, p, j] = (q_b . x_j) * scale_j + bias_j
    (alpha already folded into q; scale applied before the bias, as the
    Pallas kernel does).
  - `adc_bucket_scores` (K4, `ivf_adc`): PQ asymmetric distances over a
    probed bucket's codes, s[b, p, j] = -sum_m tab[b, p, m, code[m, j]]
    + bias_j, with 8-bit codes [C, M, cap] or 4-bit codes nibble-packed
    two per byte [C, M/2, cap] (high nibble = subspace 2r, low = 2r+1).

On a CUDA tensor each wrapper launches its kernel (built by
ops/_kernels.py) or raises; on a CPU tensor it runs the plain PyTorch
version (`_bucket_probe_scores_plain`, `_adc_bucket_scores_plain`). The
kernels take the B * P (query, probe) pairs grouped by bucket (a
pre-pass in the same call sorts them on the device, no host sync;
`bucket_groups` is its plain version), so a bucket that several queries
probe is read once. The top-k over [B, P * cap] runs outside, in
vector/ivf.py.
"""

from __future__ import annotations

import torch

from . import _kernels
from .runtime import score_dtype

# Lanes of (subspace, centroid) pairs the JAX package's one-hot ADC kernel
# folds per matmul group. Only `adc_kernel_supported` reads it: the CUDA
# kernel takes every (M, K), but both packages must pick the same path.
ADC_GROUP_LANES = 1024

# Shared memory of one chunk of K4's table ring: a (query, probe) table of
# more M * K bf16 entries streams in several chunks of subspaces.
ADC_SMEM_BYTES = 16 * 1024

# Pairs per kernel launch: the grouping pre-pass sorts them in one CTA's
# shared memory and every CTA of the kernel keeps their run starts there
# (RUN_MAX in csrc/ivf_probe.cu); more pairs take several launches, each
# sorting its own slice, so a bucket may be read once by each.
RUN_MAX = 4096

# Launches by kernel, counted where the wrapper launches it; every K3 / K4
# launch runs the grouping pre-pass (`ivf_group_pairs`) in the same C call.
LAUNCHES = {"ivf_bucket_probe": 0, "ivf_adc": 0, "ivf_group_pairs": 0}

_VEC_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def adc_kernel_supported(m: int, k: int) -> bool:
    """The JAX package's predicate for its one-hot LUT kernel (M*K a
    multiple of 128, K dividing the group width); unsupported (M, K) fall
    back to the gather path there, and so here (vector/ivf.py), so that
    both packages take the same path. K4 itself has no such limit."""
    return (m * k) % 128 == 0 and ADC_GROUP_LANES % k == 0


def bucket_groups(probes: torch.Tensor):
    """[B, P] probe ids -> (ids, order), both [B * P]: the ids in
    ascending order and each one's pair index b * P + p, from one stable
    sort. A run of equal ids is one bucket and the queries that probe it,
    in pair order; ids below 0 come first and ids >= C last."""
    return torch.sort(probes.reshape(-1), stable=True)


def _slices(n: int):
    """[start, stop) of the pairs each launch takes."""
    return [(s0, min(n, s0 + RUN_MAX)) for s0 in range(0, n, RUN_MAX)]


def _group_pairs_plain(probes, c: int):
    """Plain version of the kernels' grouping pre-pass (`ivf_group_kernel`
    in csrc/ivf_probe.cu): per launch's slice of RUN_MAX pairs,
    `bucket_groups` of the ids clamped to [-1, C] (so that no int64 id
    wraps into [0, C)), as int32 (ids, order)."""
    flat = probes.reshape(-1).clamp(-1, c)
    ids, order = [], []
    for s0, s1 in _slices(flat.numel()):
        i, o = bucket_groups(flat[s0:s1])
        ids.append(i)
        order.append(o + s0)
    return torch.cat(ids).to(torch.int32), torch.cat(order).to(torch.int32)


def _group_pairs_cuda(probes, c: int):
    """The grouping pre-pass alone on the card (`ivf_group_pairs`), to
    hold it against `_group_pairs_plain`; K3 and K4 run it inside their
    own call."""
    n = probes.numel()
    ids = torch.empty(n, dtype=torch.int32, device=probes.device)
    order = torch.empty_like(ids)
    with torch.cuda.device(probes.device):
        err = _kernels.library().ivf_group_pairs(
            probes.data_ptr(), int(probes.dtype == torch.int64), *probes.stride(),
            *probes.shape, c, ids.data_ptr(), order.data_ptr(),
            torch.cuda.current_stream(probes.device).cuda_stream)
    _kernels.check("ivf_group_pairs", err)
    _kernels.count(LAUNCHES, "ivf_group_pairs")
    return ids, order


def _check_common(probes, store, bias, c: int, cap: int):
    if probes.dim() != 2 or probes.dtype not in (torch.int32, torch.int64):
        raise ValueError("probes must be an integer [B, P] tensor")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (c, cap):
        raise ValueError(f"bucket_bias must be float32 [{c}, {cap}]")
    for t in (probes, bias):
        if t.device != store.device:
            raise ValueError("all inputs must be on the buckets' device")


# --------------------------------------------------------------------------
# K3: raw bucket probe
# --------------------------------------------------------------------------


def _bucket_probe_scores_plain(q, probes, bucket_vectors, bucket_bias, bucket_scale=None):
    """Plain PyTorch version of K3: one gather + batched product per probe
    column (bounds the gathered block to [B, cap, D])."""
    b, p = probes.shape
    cap = bucket_vectors.shape[1]
    qf = q.float()[:, :, None]  # exact: bf16 values widen to f32
    out = torch.empty((b, p, cap), dtype=torch.float32, device=q.device)
    pl = probes.long()
    for j in range(p):
        blk = bucket_vectors[pl[:, j]].float()  # [B, cap, D]; int8 widens exactly
        s = torch.bmm(blk, qf)[:, :, 0]
        if bucket_scale is not None:
            s = s * bucket_scale[pl[:, j]]
        out[:, j] = s + bucket_bias[pl[:, j]]
    return out


def _bucket_probe_cuda(q, probes, bucket_vectors, bucket_bias, bucket_scale):
    c, cap, d = bucket_vectors.shape
    b, p = probes.shape
    if bucket_vectors.dtype not in _VEC_CODE:
        raise TypeError(f"unsupported bucket dtype {bucket_vectors.dtype}")
    if q.dtype != score_dtype(bucket_vectors.dtype) or tuple(q.shape) != (b, d):
        raise ValueError(f"q must be {score_dtype(bucket_vectors.dtype)} [{b}, {d}]")
    if (d * bucket_vectors.element_size()) % 16 or (d * q.element_size()) % 16:
        raise ValueError(f"rows must be a multiple of 16 bytes, D={d}")
    _check_common(probes, bucket_vectors, bucket_bias, c, cap)
    if bucket_scale is not None and (bucket_scale.dtype != torch.float32
                                     or tuple(bucket_scale.shape) != (c, cap)):
        raise ValueError(f"bucket_scale must be float32 [{c}, {cap}]")
    for t in (q, bucket_vectors, bucket_bias, bucket_scale):
        if t is not None and (t.device != bucket_vectors.device or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError("kernel inputs must be contiguous, 16-byte aligned, on one device")
    out = torch.empty((b, p, cap), dtype=torch.float32, device=q.device)
    if b * p == 0 or cap == 0:
        return out
    n = b * p
    ids = torch.empty(n, dtype=torch.int32, device=q.device)
    order = torch.empty_like(ids)
    qs = torch.empty((n, d), dtype=q.dtype, device=q.device)  # each sorted pair's query
    with torch.cuda.device(q.device):
        err = _kernels.library().ivf_bucket_probe(
            q.data_ptr(), probes.data_ptr(), int(probes.dtype == torch.int64), *probes.stride(),
            b, p,
            bucket_vectors.data_ptr(), _VEC_CODE[bucket_vectors.dtype], bucket_bias.data_ptr(),
            bucket_scale.data_ptr() if bucket_scale is not None else None, c, cap, d,
            ids.data_ptr(), order.data_ptr(), qs.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _kernels.check("ivf_bucket_probe", err)
    _kernels.count(LAUNCHES, "ivf_bucket_probe", len(_slices(n)))
    _kernels.count(LAUNCHES, "ivf_group_pairs", len(_slices(n)))
    return out


def bucket_probe_scores(q, probes, bucket_vectors, bucket_bias, bucket_scale=None):
    """q [B, D] (alpha folded in; f32 for f32 buckets, bf16 for bf16 and
    int8 buckets), probes [B, P] int bucket ids, bucket_vectors [C, cap, D]
    f32 / bf16 / int8, bucket_bias [C, cap] f32 additive (NEG_INF = dead
    entry; -|x|^2 folded for l2), bucket_scale [C, cap] f32 optional
    per-row dequant factors (int8). Returns scores [B, P, cap] f32."""
    if not bucket_vectors.is_cuda:
        return _bucket_probe_scores_plain(q, probes, bucket_vectors, bucket_bias, bucket_scale)
    return _bucket_probe_cuda(q, probes, bucket_vectors, bucket_bias, bucket_scale)


# --------------------------------------------------------------------------
# K4: ADC over bucket-contiguous codes
# --------------------------------------------------------------------------


def _unpack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[..., M/2, cap] packed bytes -> [..., M, cap] codes in subspace
    order (row 2r = high nibble of byte row r, row 2r+1 = low nibble)."""
    hi, lo = codes >> 4, codes & 0xF
    return torch.stack([hi, lo], dim=-2).reshape(*codes.shape[:-2], -1, codes.shape[-1])


def round_tables(tabs: torch.Tensor) -> torch.Tensor:
    """ADC tables rounded to bf16 values, held in f32 (contiguous), as
    `adc_bucket_scores` gives them to K4's plain version."""
    return tabs.to(torch.bfloat16).float().contiguous()


def _adc_bucket_scores_plain(tabs, probes, bucket_codes, bucket_bias):
    """Plain PyTorch version of K4 on already-rounded tables
    (`round_tables`): a gather of each probe column's table entries,
    summed over M."""
    b, p, m, _ = tabs.shape
    cap = bucket_codes.shape[2]
    packed = bucket_codes.shape[1] * 2 == m
    pl = probes.long()
    out = torch.empty((b, p, cap), dtype=torch.float32, device=tabs.device)
    for j in range(p):
        codes = bucket_codes[pl[:, j]]  # [B, M or M/2, cap]
        if packed:
            codes = _unpack_nibbles(codes)
        d = torch.gather(tabs[:, j], 2, codes.long()).sum(dim=1)  # [B, cap]
        out[:, j] = -d + bucket_bias[pl[:, j]]
    return out


def _bf16_tables(tabs: torch.Tensor) -> torch.Tensor:
    """K4's tables: `round_tables`' values in bf16 (half the bytes),
    contiguous [B, P', M, Kp]. A table broadcast over P (stride 0, as a
    non-residual index passes it) keeps P' = 1 instead of being copied P
    times; Kp is K padded with zeros to a multiple of 8 (16-byte rows for
    the kernel's bulk copies)."""
    if tabs.shape[1] > 1 and tabs.stride(1) == 0:
        tabs = tabs[:, :1]
    t = tabs.to(torch.bfloat16)
    k = t.shape[3]
    if k % 8:
        t = torch.nn.functional.pad(t, (0, 8 - k % 8))
    return t.contiguous()


def _adc_cuda(tabs, probes, bucket_codes, bucket_bias, packed: bool):
    b, p, m, k = tabs.shape
    c, rows, cap = bucket_codes.shape
    if bucket_codes.dtype != torch.uint8:
        raise TypeError("bucket_codes must be uint8")
    if packed and k != 16:
        raise ValueError("nibble-packed codes need K = 16")
    _check_common(probes, bucket_codes, bucket_bias, c, cap)
    if tabs.device != bucket_codes.device:
        raise ValueError("kernel inputs must be on one device")
    for t in (bucket_codes, bucket_bias):
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    out = torch.empty((b, p, cap), dtype=torch.float32, device=tabs.device)
    if b * p == 0 or cap == 0:
        return out
    tb = _bf16_tables(tabs)
    if tb.data_ptr() % 16:
        raise ValueError("the bf16 tables must be 16-byte aligned")
    kp = tb.shape[3]
    # subspaces per table chunk; whole byte rows when packed
    m_chunk = max(2 if packed else 1, ADC_SMEM_BYTES // (2 * kp))
    m_chunk = min(m, m_chunk - (m_chunk % 2 if packed else 0))
    tab_p = tb.stride(1) if tb.shape[1] > 1 else 0
    n = b * p
    ids = torch.empty(n, dtype=torch.int32, device=tabs.device)
    order = torch.empty_like(ids)
    with torch.cuda.device(tabs.device):
        err = _kernels.library().ivf_adc(
            tb.data_ptr(), tb.stride(0), tab_p, probes.data_ptr(),
            int(probes.dtype == torch.int64), *probes.stride(), b, p, bucket_codes.data_ptr(),
            bucket_bias.data_ptr(), c, m, k, kp, cap, int(packed), m_chunk, ids.data_ptr(),
            order.data_ptr(), out.data_ptr(), torch.cuda.current_stream(tabs.device).cuda_stream,
        )
    _kernels.check("ivf_adc", err)
    _kernels.count(LAUNCHES, "ivf_adc", len(_slices(n)))
    _kernels.count(LAUNCHES, "ivf_group_pairs", len(_slices(n)))
    return out


def adc_bucket_scores(tabs, probes, bucket_codes, bucket_bias):
    """tabs [B, P, M, K] f32 per-(query, probe) ADC tables (lower =
    closer; non-residual callers broadcast one table per query over P),
    probes [B, P] int, bucket_codes [C, M, cap] u8 ([C, M/2, cap]
    nibble-packed when K = 16), bucket_bias [C, cap] f32. Returns
    [B, P, cap] f32 negated distances + bias.

    The tables are rounded to bf16 first, as the Pallas kernel rounds them
    for its one-hot product, so that K4, its plain version and the JAX
    package sum the same values and rank the same re-rank pool (K4 reads
    them as bf16, `_bf16_tables`; its plain version as f32,
    `round_tables`); the sums are f32."""
    m = tabs.shape[2]
    rows = bucket_codes.shape[1]
    if rows * 2 != m and rows != m:
        raise ValueError(f"bucket_codes rows {rows} fit neither M={m} nor M/2")
    if not bucket_codes.is_cuda:
        return _adc_bucket_scores_plain(round_tables(tabs), probes, bucket_codes, bucket_bias)
    return _adc_cuda(tabs, probes, bucket_codes, bucket_bias, packed=rows * 2 == m)
