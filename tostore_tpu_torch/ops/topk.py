"""Flat scan + top-k selection (counterpart of `tostore_tpu/ops/topk.py`).

All paths share one algorithmic core: score a chunk of corpus rows, keep
each chunk's per-lane top-2 (score, index) candidates (lane = row % 128),
and merge the candidates with `top_k_first`. Dispatched by
`flat_search(mode=...)`:

  - `fused_flat_topk`: 2048-row blocks, per-lane top-2 folded into a
    running per-lane top-T (B <= 32; kernel K1) or emitted per block
    (B > 32; kernel K2). On a CUDA tensor these launch the hand-written
    Hopper kernels (bf16 and int8 corpora: csrc/lane_scan.cuh, TMA +
    wgmma; f32 corpora: the f32 FMA kernels of csrc/lane_topk.cu); on a
    CPU tensor they run their plain PyTorch versions
    (`_fused_flat_topk_plain`, `_fused_block_emit_plain`), which give the
    same candidates.
  - `flat_topk_lane`: the same per-(chunk, lane) top-2 in plain PyTorch
    (chunked matmul + per-lane argmax). The JAX package runs it in XLA
    outside any kernel, and `auto` takes it for B > 32; the port's `auto`
    takes it there for CPU tensors and, on the card, for f32 corpora
    above 256 queries (`_auto_route`): elsewhere on the card K2 serves the
    same contract with finer buckets, faster.
  - `flat_topk_xla` (exact): chunked matmul + `top_k_first`, always exact.

Every selection is `top_k_first`, `jax.lax.top_k`'s contract: scores in
IEEE totalOrder, ties to the lower position in the candidate layout the
reference's kernel or scan emits (the row; t*128 + lane of K1's lists;
block, then tops before seconds, of K2 / K5 / K6; chunk, then tops before
seconds, of the lane scan), so each route returns the reference's hits in
the reference's order, exactly equal scores included. On a CUDA tensor it
launches the hand-written selection kernel (csrc/select_topk.cu,
`select_topk`), with no host sync; on a CPU tensor it runs its plain
version (`_top_k_first_plain`).

Outside the dispatch, as in the JAX package: `_fused_group_emit` folds
the per-block top-2 into a per-(group of gsz blocks, lane) top-2 (kernel
K5) and `pipe_topk` does the same with the selection of a tile overlapped
with the products of the next (kernel K6). On a CUDA tensor bf16 and int8
corpora take csrc/lane_scan_group.cu (TMA + wgmma, a group split by lane
halves across CTAs), f32 corpora the FMA kernels of csrc/lane_topk.cu;
their plain versions are `_fused_group_emit_plain` and `_pipe_topk_plain`.

Exactness contract of the approximate paths: the true global top-k is
recovered exactly unless more than 2 of the true top-k rows share one
(chunk, lane) candidate bucket. `mode="auto"` uses them only for
block-aligned corpora (N % 2048 == 0, D % 128 == 0, as the corpus always
pads) with N >= MIN_FUSED_N; everything else, and `mode="exact"`, takes
the exact path. `mode="fast"` is served by the `auto` dispatch: the JAX
package's `fast` path needs the TPU's PartialReduce unit (approx_max_k),
which the card does not have, and `auto` never misses more than `fast`
promised.

Scores are `alpha * row_scale_i * (q @ corpus.T)_i + bias_i`, higher is
better (ops/distance.py has the per-metric encoding). Invalid and padded
rows carry bias NEG_INF. f32 corpora are scored in true f32: callers keep
TF32 off, as torch does by default.
"""

from __future__ import annotations

import torch

from . import _kernels
from .runtime import LANE, NEG_INF, f32_dot, round_up, score_dtype

DEFAULT_BLK_N = 2048
MAX_BLK_B = 256
# Candidates harvested per (lane, block): top-2 -> exact unless 3+ of the
# true top-k share one (block, lane) bucket.
CANDS_PER_LANE = 2
# Running per-lane candidate depth accumulated across the whole corpus
# (bounds the final candidate width to T*128 regardless of N).
MAX_T_CANDS = 16
# Corpus chunk of the exact path.
EXACT_CHUNK = 65536
# Corpus size below which the exact path is always used (bucket collisions
# are likely at tiny N).
MIN_FUSED_N = 64 * DEFAULT_BLK_N
# The accumulating kernel (K1) serves query blocks up to this size.
ACC_MAX_BLK_B = 32
F32_FUSED_MAX_B = 256  # on a CUDA device, `auto` sends an f32 corpus to K2 up to here

# Query rows per CTA of K1 and K2. bf16 and int8 corpora (csrc/lane_scan.cuh):
# K1 serves the whole padded batch (8, 16, 24 or 32 queries) in one CTA, so
# the corpus is read once; K2 takes 64 queries per CTA. f32 corpora
# (csrc/lane_topk.cu): K1 takes 8 queries when the padded batch is 8, else
# 16; K2 takes 32.
ACC_TILE_B = (8, 16, 24, 32)
EMIT_TILE_B = 64
ACC_TILE_B_F32 = (8, 16)
EMIT_TILE_B_F32 = 32
# K5 / K6 on bf16 and int8 corpora (csrc/lane_scan_group.cu): query rows per
# CTA, the widest first; a CTA serves one lane half (64 of the 128 lanes) of
# one group for one query tile. The f32 kernels take 32 queries and a whole
# group per CTA.
GROUP_TILE_B = (64, 32)
# the share of the SMs that a grid of the wider tile must fill to be taken
_GROUP_FILL = 0.75
# CTAs per SM of a scan: the TMA ring of lane_scan.cuh fills an SM's shared
# memory, so one persistent CTA per SM walks a contiguous range of blocks;
# the f32 kernels fit two per SM.
_CTAS_PER_SM = 1
_CTAS_PER_SM_F32 = 2

# Launches of each hand-written kernel, counted where the wrapper launches
# it; a run reads them to show which kernels its path went through.
LAUNCHES = {"lane_topk_acc": 0, "lane_topk_emit": 0, "lane_topk_acc_f32": 0,
            "lane_topk_emit_f32": 0, "lane_topk_group": 0, "lane_topk_group_pipe": 0,
            "lane_topk_group_f32": 0, "lane_topk_group_pipe_f32": 0, "select_topk": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# --------------------------------------------------------------------------
# Selection in the reference's order
# --------------------------------------------------------------------------

# The plain selection (CPU tensors): up to this many scores it ranks one
# int64 key a candidate; above, torch.topk selects and only rows with ties
# reselect.
EXACT_SELECT_MAX = 1 << 20
# select_topk (csrc/select_topk.cu): the most candidates one CTA sorts in
# shared memory (64-bit keys, 64 KB); a larger k takes chunks of this many,
# each a full selection over the row.
SELECT_CAP = 8192
# rows longer than this take 512 threads a CTA, shorter ones 128
_SELECT_WIDE_N = 4096
_LOW32 = 0xFFFFFFFF
# A search's misses score at or below this (ops/distance.py
# `finalize_results`): their order among themselves is never read.
MISS_FLOOR = NEG_INF / 2


def _order_key(s: torch.Tensor) -> torch.Tensor:
    """float32 scores -> int32 keys in IEEE totalOrder (-NaN < -inf < ... <
    -0.0 < 0.0 < ... < inf < NaN), as XLA compares floats in its top-k:
    the bits of a negative float, all but the sign flipped."""
    b = s.float().contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _select_exact(s: torch.Tensor, k: int):
    """`top_k_first` by selecting over all N candidates one unique int64
    key each, (order key << 32) | (2^32 - 1 - position): the larger key is
    the better score, then the lower position."""
    n = s.shape[-1]
    key = (_order_key(s).long() << 32) | (_LOW32 - torch.arange(n, device=s.device))
    pos = torch.topk(key, min(k, n), dim=-1).indices
    return torch.gather(s, -1, pos), pos


def _select_fast(s: torch.Tensor, k: int, floor: float | None = None):
    """(values, positions, unsure [...] bool) of the top-k along the last
    axis, k < N: torch.topk's k + 1 best, in its order. Where they are
    strictly decreasing (IEEE `>`, false for equal values, -0.0 against
    0.0, and NaN), the first k are the exact answer: no two of them tie,
    and every candidate outside scores below the k-th. Other rows are
    unsure. With a floor, equal scores at or below it (a search's misses)
    do not make a row unsure."""
    v, p = torch.topk(s, k + 1, dim=-1)
    tie = ~(v[..., :-1] > v[..., 1:])
    if floor is not None:
        tie &= ~(v[..., 1:] <= floor)
    return v[..., :k], p[..., :k], tie.any(dim=-1)


def _unsure_rows(unsure: torch.Tensor):
    """The flat indices of the unsure rows, or None: one host sync, and a
    second only where some row is unsure."""
    if not bool(unsure.any()):
        return None
    return unsure.reshape(-1).nonzero().flatten()


def top_k_first(s: torch.Tensor, k: int, floor: float | None = None):
    """Top-k along the last axis with `jax.lax.top_k`'s contract: scores
    descending in IEEE totalOrder (0.0 before -0.0, NaN first), and among
    equal scores the lower position first, both for membership at the k-th
    place and for order. Returns (values, positions int64), min(k, N) wide.

    On a CUDA tensor this launches `select_topk` (`_select_topk_cuda`) for
    every shape and k, with no host sync; it is exact for every score, so
    `floor` is not read. On a CPU tensor it runs the plain version,
    `_top_k_first_plain`."""
    if s.is_cuda:
        return _top_k_first_cuda(s, k)
    return _top_k_first_plain(s, k, floor)


def _top_k_first_plain(s: torch.Tensor, k: int, floor: float | None = None):
    """Plain PyTorch version of `top_k_first`. `torch.topk` fixes no order
    among equal values: up to EXACT_SELECT_MAX scores the selection ranks
    unique (score, position) keys, one int64 each; above, torch.topk's
    answer stands where its k + 1 best are strictly decreasing, and only
    the other rows select again over the keys (one host sync). A floor
    (MISS_FLOOR for a search) leaves the order of the scores at or below it
    to torch.topk."""
    n = s.shape[-1]
    kk = min(k, n)
    if s.numel() <= EXACT_SELECT_MAX or kk >= n or kk == 0:
        return _select_exact(s, kk)
    v, p, unsure = _select_fast(s, kk, floor)
    rows = _unsure_rows(unsure)
    if rows is not None:
        lead = s.shape[:-1]
        ev, ep = _select_exact(s.reshape(-1, n)[rows], kk)
        v = v.reshape(-1, kk).index_copy(0, rows, ev).reshape(*lead, kk)
        p = p.reshape(-1, kk).index_copy(0, rows, ep).reshape(*lead, kk)
    return v, p


def _top_k_first_cuda(s: torch.Tensor, k: int):
    """`top_k_first` on the card: the leading axes flattened to rows, a
    float input other than f32 widened to f32 for the keys (as
    `_order_key` does) and its values gathered from the input; k = 0, N = 0
    or no rows give empty tensors without a launch."""
    lead, n = s.shape[:-1], s.shape[-1]
    kk = min(k, n)
    if kk <= 0 or s.numel() == 0:
        return (torch.empty((*lead, max(kk, 0)), dtype=s.dtype, device=s.device),
                torch.empty((*lead, max(kk, 0)), dtype=torch.int64, device=s.device))
    if not s.is_floating_point():
        raise TypeError(f"top_k_first takes float scores on the card, got {s.dtype}")
    v, p = _select_topk_cuda(s.float().contiguous().reshape(-1, n), kk)
    v, p = v.reshape(*lead, kk), p.reshape(*lead, kk)
    if s.dtype != torch.float32:
        v = torch.gather(s, -1, p)
    return v, p


def _select_plan(n: int, k: int):
    """(threads a CTA, buffer keys) of select_topk for rows of n scores: the
    buffer holds the k winners (SELECT_CAP at most, then chunks) and at
    least 4 keys a thread, so that a histogram pass ends early where the
    k-th's bin is small."""
    threads = 512 if n > _SELECT_WIDE_N else 128
    want = 1 << (min(k, SELECT_CAP) - 1).bit_length()
    return threads, min(SELECT_CAP, max(want, 4 * threads))


def _check_select_inputs(s: torch.Tensor, k: int):
    """Raise on what select_topk does not take: f32 [R, N] contiguous rows,
    1 <= k <= N, N < 2^31 - 1 and R < 2^31 (int32 positions and grid)."""
    if s.dtype != torch.float32:
        raise TypeError(f"select_topk takes float32 scores, got {s.dtype}")
    if s.dim() != 2:
        raise ValueError(f"select_topk takes [rows, n] scores, got {tuple(s.shape)}")
    if not s.is_contiguous():
        raise ValueError("select_topk takes contiguous rows")
    rows, n = s.shape
    if not 1 <= k <= n:
        raise ValueError(f"select_topk takes 1 <= k <= n = {n}, got k = {k}")
    if n >= 2**31 - 1 or rows >= 2**31:
        raise ValueError(f"select_topk takes rows < 2^31 of n < 2^31 - 1, got {tuple(s.shape)}")


def _select_topk_cuda(s: torch.Tensor, k: int):
    """select_topk on the card: s [R, N] f32 -> (values [R, k] f32, bit for
    bit the scores, positions [R, k] int64) in `top_k_first`'s order."""
    if not s.is_cuda:
        raise ValueError(f"select_topk takes a CUDA tensor, got one on {s.device}")
    _check_select_inputs(s, k)
    rows, n = s.shape
    threads, cap = _select_plan(n, k)
    out_v = torch.empty((rows, k), dtype=torch.float32, device=s.device)
    out_p = torch.empty((rows, k), dtype=torch.int64, device=s.device)
    lib = _kernels.library()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.select_topk(s.data_ptr(), rows, n, k, threads, cap, out_v.data_ptr(),
                              out_p.data_ptr(), stream)
    _kernels.check("select_topk", err)
    _kernels.count(LAUNCHES, "select_topk")
    return out_v, out_p


def _topk_pad(flat_s, flat_i, k: int):
    """Top-k over the candidate axis (flat_i None: the candidates are the
    rows themselves), ties to the lower position (`top_k_first`); a k
    above the candidate width pads with NEG_INF / index 0."""
    kk = min(k, flat_s.shape[1])
    top_s, pos = top_k_first(flat_s, kk, MISS_FLOOR)
    top_i = pos if flat_i is None else torch.gather(flat_i, 1, pos)
    if kk < k:
        top_s = torch.nn.functional.pad(top_s, (0, k - kk), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, k - kk))
    return top_s, top_i.long()


def _scores(qc, cblk, bblk, sblk, alpha):
    s = f32_dot(qc, cblk)
    if sblk is not None:
        s = s * sblk[None, :]
    return alpha * s + bblk[None, :]


# --------------------------------------------------------------------------
# Exact path
# --------------------------------------------------------------------------


def flat_topk_xla(q, corpus, bias, alpha, k, row_scale=None):
    """Exact scan. Chunks the corpus so peak memory stays ~[B, EXACT_CHUNK]
    while `top_k_first` does the selection, ties to the lower row (the
    chunks' candidates lie chunk by chunk, as the reference's scan stacks
    them). Returns (scores [B, k] f32 desc, idx [B, k] int64)."""
    n = corpus.shape[0]
    qc = q.to(score_dtype(corpus.dtype))
    if n <= 2 * EXACT_CHUNK or n % EXACT_CHUNK != 0:
        return _topk_pad(_scores(qc, corpus, bias, row_scale, alpha), None, k)
    kk = min(k, EXACT_CHUNK)
    parts_s, parts_i = [], []
    for off in range(0, n, EXACT_CHUNK):
        sl = slice(off, off + EXACT_CHUNK)
        s = _scores(qc, corpus[sl], bias[sl],
                    row_scale[sl] if row_scale is not None else None, alpha)
        ts, ti = top_k_first(s, kk, MISS_FLOOR)
        parts_s.append(ts)
        parts_i.append(ti + off)
    return _topk_pad(torch.cat(parts_s, 1), torch.cat(parts_i, 1), k)


# --------------------------------------------------------------------------
# Per-lane candidates, plain PyTorch
# --------------------------------------------------------------------------


def _lane_top2(s, width: int, off: int = 0):
    """Per-(group of `width` rows, lane) top-2 of a score tile.

    s: [B, M] f32 with M % width == 0. Returns candidates [B, (M/width)*256]
    laid out group-major, each group's lane tops first, then its seconds;
    indices are row numbers (+ off). Ties go to the lower row, as the
    reference's `v > best` sweep (argmax returns the first maximum)."""
    b, m = s.shape
    g, r = m // width, width // LANE
    s4 = s.view(b, g, r, LANE)
    a1 = s4.argmax(dim=2, keepdim=True)
    m1 = s4.gather(2, a1)
    s4b = s4.scatter(2, a1, NEG_INF)
    a2 = s4b.argmax(dim=2, keepdim=True)
    m2 = s4b.gather(2, a2)
    base = torch.arange(g, device=s.device)[None, :, None] * width + off
    lane = torch.arange(LANE, device=s.device)
    g1 = base + a1.squeeze(2) * LANE + lane
    g2 = base + a2.squeeze(2) * LANE + lane
    cs = torch.stack([m1.squeeze(2), m2.squeeze(2)], dim=2).reshape(b, g * 2 * LANE)
    ci = torch.stack([g1, g2], dim=2).reshape(b, g * 2 * LANE)
    return cs, ci


def _block_cands_plain(qp, corpus, bias, row_scale, alpha, blk_n):
    """Every block's per-lane top-2: [B_pad, n_blocks*256], the layout K2
    writes. Scored a chunk of whole blocks at a time to bound the tile."""
    n = corpus.shape[0]
    step = max(blk_n, ((1 << 25) // max(qp.shape[0], 1)) // blk_n * blk_n)
    parts_s, parts_i = [], []
    for off in range(0, n, step):
        sl = slice(off, min(n, off + step))
        s = _scores(qp, corpus[sl], bias[sl],
                    row_scale[sl] if row_scale is not None else None, alpha)
        cs, ci = _lane_top2(s, blk_n, off)
        parts_s.append(cs)
        parts_i.append(ci)
    return torch.cat(parts_s, 1), torch.cat(parts_i, 1)


def _lane_top_t(vs, vi, t_cands: int):
    """The reference's per-lane running top-T (K1's bubble insert) from a
    lane's candidates in insertion order: [B, 128, L] -> [B, T*128] laid
    out t-major (t*128 + lane), the layout whose positions break the final
    top-k's ties. The insert compares with `>`: a score <= NEG_INF (or NaN)
    never enters, so its entry is (NEG_INF, index 0) as in the initial
    list, and equal scores, -0.0 and 0.0 among them, keep insertion order.
    Lanes with fewer than T candidates pad with NEG_INF / index 0."""
    b, _, width = vs.shape
    # the insert's order as a selection key, written row-contiguous in one
    # pass: + 0.0 turns -0.0 into 0.0, NaN and -inf become NEG_INF
    key = torch.empty(vs.shape, dtype=torch.float32, device=vs.device)
    torch.add(vs, 0.0, out=key)
    torch.nan_to_num_(key, nan=NEG_INF, posinf=float("inf"), neginf=NEG_INF)
    _, pos = top_k_first(key, t_cands)
    vs, vi = torch.gather(vs, 2, pos), torch.gather(vi, 2, pos)
    live = vs > NEG_INF
    vs = torch.where(live, vs, NEG_INF)
    vi = torch.where(live, vi, 0)
    if width < t_cands:
        pad = t_cands - width
        vs = torch.nn.functional.pad(vs, (0, pad), value=NEG_INF)
        vi = torch.nn.functional.pad(vi, (0, pad))
    return (vs.transpose(1, 2).reshape(b, t_cands * LANE),
            vi.transpose(1, 2).reshape(b, t_cands * LANE))


def _running_top_t(cs, ci, t_cands: int):
    """Per-lane top-T of the per-block candidates, as K1's bubble insert
    leaves it: [B, n_blocks*256] -> [B, T*128] laid out t-major. The
    insertion order is block by block, top then second."""
    b = cs.shape[0]
    nb = cs.shape[1] // (2 * LANE)
    return _lane_top_t(cs.view(b, nb * 2, LANE).transpose(1, 2),
                       ci.view(b, nb * 2, LANE).transpose(1, 2), t_cands)


# --------------------------------------------------------------------------
# Kernel wrappers (K1, K2)
# --------------------------------------------------------------------------


def _check_kernel_inputs(qp, corpus, bias, row_scale, blk_n):
    if corpus.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported corpus dtype {corpus.dtype}")
    if qp.dtype != score_dtype(corpus.dtype):
        raise TypeError(f"queries must be {score_dtype(corpus.dtype)}, got {qp.dtype}")
    n, d = corpus.shape
    if n % blk_n or d % LANE or blk_n % LANE:
        raise ValueError(f"corpus must be block-padded: N={n} (blk {blk_n}), D={d}")
    if qp.dim() != 2 or qp.shape[1] != d or qp.shape[0] % 8:
        raise ValueError(f"queries must be [B_pad % 8 == 0, {d}], got {tuple(qp.shape)}")
    if n >= 2**31:
        raise ValueError("corpus rows must fit int32 indices")
    tensors = [qp, corpus, bias] + ([row_scale] if row_scale is not None else [])
    for t in tensors:
        if t.device != corpus.device:
            raise ValueError("all inputs must be on the corpus's device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous and 16-byte aligned")
    for t in tensors[2:]:
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"bias/row_scale must be float32 [{n}]")


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_plan(n_blocks: int, b_tiles: int, sms: int, ctas_per_sm: int = _CTAS_PER_SM):
    """(blocks per split, splits): contiguous block ranges, the last one
    possibly shorter, so that b_tiles query tiles x splits CTAs fill about
    ctas_per_sm CTAs per SM."""
    want = max(1, -(-sms * ctas_per_sm // b_tiles))
    per = max(1, -(-n_blocks // want))
    return per, -(-n_blocks // per)


def _grid_plan(emit: bool, b_pad: int, n_blocks: int, sms: int, f32: bool):
    """(query rows per CTA, query tiles, blocks per split, splits) of K1
    (emit False) or K2 on a card with `sms` SMs; the grid is query tiles x
    splits CTAs. K1 on bf16 / int8 serves the whole padded batch in one
    tile."""
    if f32:
        tile_b = EMIT_TILE_B_F32 if emit else (
            ACC_TILE_B_F32[0] if b_pad <= ACC_TILE_B_F32[0] else ACC_TILE_B_F32[1])
        ctas = _CTAS_PER_SM_F32
    else:
        if not emit and b_pad not in ACC_TILE_B:
            raise ValueError(f"K1 takes a padded batch in {ACC_TILE_B}, got {b_pad}")
        tile_b = EMIT_TILE_B if emit else b_pad
        ctas = _CTAS_PER_SM
    q_tiles = -(-b_pad // tile_b)
    return (tile_b, q_tiles) + _split_plan(n_blocks, q_tiles, sms, ctas)


def _list_width(per: int, t_cands: int) -> int:
    """Entries per (query, split, lane) list of K1 on bf16 / int8: a split
    of at most T/2 blocks keeps every block's pair (unsorted), a longer one
    the sorted top-T."""
    return 2 * per if 2 * per <= t_cands else t_cands


def _merge_split_lists(out_s, out_i, t_cands: int, k: int, card: bool | None = None):
    """K1's per-split lists [B, splits * W, 128] -> the reference's top-k
    (scores, rows) [B, k]: the top-k of its per-lane top-T lists by
    (score, t * 128 + lane). A split holds its blocks' per-lane candidates
    in insertion order (W = 2 * blocks, unsorted) or its sorted top-T,
    equal scores in insertion order (W = T); splits are contiguous block
    ranges in ascending order, so a lane's lists side by side are in
    insertion order among equal scores, and its top-T of them by (score,
    position) is the reference's list (`_lane_top_t`).

    On the card (`card` None: where the lists are CUDA tensors; True takes
    that branch on any tensors, with the plain selection on the CPU) it is
    always that per-lane merge: two selections, no host sync. On the CPU,
    where the k + 1 best of all lists are strictly decreasing (misses
    aside) and k <= T, they are the answer as they stand (`_select_fast`):
    no lane holds more than k of them, so none is cut at T, and with no
    equal scores the order is the score's. The other rows (one host sync
    finds them) take the per-lane merge."""
    if card is None:
        card = out_s.is_cuda
    b = out_s.shape[0]
    flat_s, flat_i = out_s.reshape(b, -1), out_i.reshape(b, -1)
    if card or k > t_cands or k >= flat_s.shape[1]:
        return _lane_merge(out_s, out_i, t_cands, k)
    top_s, pos, unsure = _select_fast(flat_s, k, MISS_FLOOR)
    top_i = torch.gather(flat_i, 1, pos).long()
    rows = _unsure_rows(unsure)
    if rows is not None:
        es, ei = _lane_merge(out_s[rows], out_i[rows], t_cands, k)
        top_s, top_i = top_s.index_copy(0, rows, es), top_i.index_copy(0, rows, ei)
    return top_s, top_i


def _lane_merge(out_s, out_i, t_cands: int, k: int):
    """The reference's top-k from K1's split lists by way of its per-lane
    top-T lists."""
    return _topk_pad(*_lane_top_t(out_s.transpose(1, 2), out_i.transpose(1, 2), t_cands), k)


def _scale_ptr(row_scale):
    return row_scale.data_ptr() if row_scale is not None else None


def _lane_topk_acc_cuda(qp, corpus, bias, row_scale, alpha, blk_n, t_cands):
    """K1 on the card: each split of the block range keeps its own
    per-lane top-T lists, [B_pad, splits * W, 128] (`_merge_split_lists`
    merges them)."""
    _check_kernel_inputs(qp, corpus, bias, row_scale, blk_n)
    b_pad, d = qp.shape
    n, n_blocks = corpus.shape[0], corpus.shape[0] // blk_n
    f32 = corpus.dtype == torch.float32
    tile_b, _, per, splits = _grid_plan(False, b_pad, n_blocks, _sm_count(corpus.device), f32)
    width = t_cands if f32 else _list_width(per, t_cands)
    out_s = torch.empty((b_pad, splits * width, LANE), dtype=torch.float32,
                        device=corpus.device)
    out_i = torch.empty((b_pad, splits * width, LANE), dtype=torch.int32,
                        device=corpus.device)
    lib = _kernels.library()
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        if f32:
            name = "lane_topk_acc_f32"
            err = lib.lane_topk_acc_f32(
                qp.data_ptr(), corpus.data_ptr(), bias.data_ptr(), _scale_ptr(row_scale),
                float(alpha), b_pad, d, blk_n, n_blocks, per, splits, tile_b, t_cands,
                out_s.data_ptr(), out_i.data_ptr(), stream)
        else:
            name = "lane_topk_acc"
            err = lib.lane_topk_acc(
                qp.data_ptr(), corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], bias.data_ptr(),
                _scale_ptr(row_scale), float(alpha), b_pad, d, n, blk_n, n_blocks, per,
                splits, t_cands, out_s.data_ptr(), out_i.data_ptr(), stream)
    _kernels.check(name, err)
    _kernels.count(LAUNCHES, name)
    return out_s, out_i


def _lane_topk_emit_cuda(qp, corpus, bias, row_scale, alpha, blk_n):
    """K2 on the card: every block's per-lane top-2, [B_pad, n_blocks*256]."""
    _check_kernel_inputs(qp, corpus, bias, row_scale, blk_n)
    b_pad, d = qp.shape
    n, n_blocks = corpus.shape[0], corpus.shape[0] // blk_n
    f32 = corpus.dtype == torch.float32
    tile_b, q_tiles, per, splits = _grid_plan(True, b_pad, n_blocks,
                                              _sm_count(corpus.device), f32)
    cw = n_blocks * CANDS_PER_LANE * LANE
    out_s = torch.empty((b_pad, cw), dtype=torch.float32, device=corpus.device)
    out_i = torch.empty((b_pad, cw), dtype=torch.int32, device=corpus.device)
    lib = _kernels.library()
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        if f32:
            name = "lane_topk_emit_f32"
            err = lib.lane_topk_emit_f32(
                qp.data_ptr(), corpus.data_ptr(), bias.data_ptr(), _scale_ptr(row_scale),
                float(alpha), b_pad, d, blk_n, n_blocks, per, splits,
                out_s.data_ptr(), out_i.data_ptr(), stream)
        else:
            name = "lane_topk_emit"
            # the kernel reads whole 64-query tiles: pad the rows with zeros
            q_rows = q_tiles * tile_b
            if q_rows != b_pad:
                qp = torch.nn.functional.pad(qp, (0, 0, 0, q_rows - b_pad))
            err = lib.lane_topk_emit(
                qp.data_ptr(), corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], bias.data_ptr(),
                _scale_ptr(row_scale), float(alpha), q_rows, b_pad, d, n, blk_n, n_blocks,
                per, splits, out_s.data_ptr(), out_i.data_ptr(), stream)
    _kernels.check(name, err)
    _kernels.count(LAUNCHES, name)
    return out_s, out_i


# --------------------------------------------------------------------------
# Fused paths (K1 / K2 and their plain versions)
# --------------------------------------------------------------------------


def _pad_queries(q, blk_b: int, corpus_dtype):
    b = q.shape[0]
    b_pad = round_up(b, blk_b)
    q = q.to(score_dtype(corpus_dtype))
    if b_pad != b:
        q = torch.nn.functional.pad(q, (0, 0, 0, b_pad - b))
    return q.contiguous()


def _acc_plan(q, corpus, k, blk_n):
    """(blk_n, blk_b, t_cands, use_emit) as the reference picks them
    (topk.py:523-548)."""
    b, d = q.shape
    n = corpus.shape[0]
    if blk_n is None:
        blk_n = (
            4096
            if round_up(b, 8) > ACC_MAX_BLK_B and n % 4096 == 0
            else DEFAULT_BLK_N
        )
    if n % blk_n != 0 or d % LANE != 0:
        raise ValueError(f"corpus must be block-padded: N={n} (blk {blk_n}), D={d}")
    blk_b = min(MAX_BLK_B, round_up(b, 8))
    t_cands = min(
        MAX_T_CANDS if blk_b <= 64 else 8,
        max(CANDS_PER_LANE, round_up(min(k, 16), 8)),
    )
    return blk_n, blk_b, t_cands, round_up(b, 8) > ACC_MAX_BLK_B


def fused_flat_topk(q, corpus, bias, *, k: int, alpha: float = 1.0,
                    blk_n: int | None = None, row_scale=None):
    """Fused flat scan: returns (scores [B, k] f32 desc, idx [B, k] int64).

    q: [B, D] float; corpus: [N, D] (N % blk_n == 0, D % 128 == 0);
    bias: [N] f32 with NEG_INF on invalid/padded rows. B <= 32 runs K1
    (running per-lane top-T); B > 32 runs K2 (`_fused_block_emit`).
    On a CPU tensor this is `_fused_flat_topk_plain`."""
    blk_n, blk_b, t_cands, emit = _acc_plan(q, corpus, k, blk_n)
    if emit:
        return _fused_block_emit(q, corpus, bias, k=k, alpha=alpha, blk_n=blk_n,
                                 row_scale=row_scale)
    if not corpus.is_cuda:
        return _fused_flat_topk_plain(q, corpus, bias, k=k, alpha=alpha,
                                      blk_n=blk_n, row_scale=row_scale)
    qp = _pad_queries(q, blk_b, corpus.dtype)
    out_s, out_i = _lane_topk_acc_cuda(qp, corpus, bias, row_scale, alpha, blk_n, t_cands)
    return _merge_split_lists(out_s[: q.shape[0]], out_i[: q.shape[0]], t_cands, k)


def _fused_flat_topk_plain(q, corpus, bias, *, k: int, alpha: float = 1.0,
                           blk_n: int | None = None, row_scale=None):
    """Plain PyTorch version of K1 with the same candidates: per-block
    per-lane top-2, then the per-lane running top-T, then top-k."""
    blk_n, blk_b, t_cands, _ = _acc_plan(q, corpus, k, blk_n)
    qp = _pad_queries(q, blk_b, corpus.dtype)
    cs, ci = _block_cands_plain(qp, corpus, bias, row_scale, alpha, blk_n)
    cs, ci = _running_top_t(cs[: q.shape[0]], ci[: q.shape[0]], t_cands)
    return _topk_pad(cs, ci, k)


def _fused_block_emit(q, corpus, bias, *, k, alpha, blk_n, row_scale=None):
    """Per-block candidate emission (K2) + `top_k_first` merge over
    [B, n_blocks*256]. On a CPU tensor this is `_fused_block_emit_plain`."""
    if not corpus.is_cuda:
        return _fused_block_emit_plain(q, corpus, bias, k=k, alpha=alpha,
                                       blk_n=blk_n, row_scale=row_scale)
    qp = _pad_queries(q, min(MAX_BLK_B, round_up(q.shape[0], 8)), corpus.dtype)
    cs, ci = _lane_topk_emit_cuda(qp, corpus, bias, row_scale, alpha, blk_n)
    return _topk_pad(cs[: q.shape[0]], ci[: q.shape[0]], k)


def _fused_block_emit_plain(q, corpus, bias, *, k, alpha, blk_n, row_scale=None):
    """Plain PyTorch version of K2 with the same candidates."""
    if corpus.shape[0] % blk_n or corpus.shape[1] % LANE:
        raise ValueError(f"corpus must be block-padded: N={corpus.shape[0]} (blk {blk_n})")
    qp = _pad_queries(q, min(MAX_BLK_B, round_up(q.shape[0], 8)), corpus.dtype)
    cs, ci = _block_cands_plain(qp, corpus, bias, row_scale, alpha, blk_n)
    return _topk_pad(cs[: q.shape[0]], ci[: q.shape[0]], k)


# --------------------------------------------------------------------------
# Grouped emission (K5) and its pipelined form (K6). No dispatch takes them:
# the JAX package reaches them only directly (tests, experiments), and so
# does the port.
# --------------------------------------------------------------------------


def _merge_top2(r1, r2, i1, i2, m1, m2, g1, g2):
    """The reference's sorted 4-way merge (topk.py:403-421): a running pair
    (r1 >= r2) and a block's (m1 >= m2) -> the union's top-2. The running
    pair wins a tie for the top; the second is the larger of the tops'
    loser and the winner's second, the loser winning a tie."""
    w = r1 >= m1
    c2a = torch.where(w, m1, r1)
    j2a = torch.where(w, g1, i1)
    c2b = torch.where(w, r2, m2)
    j2b = torch.where(w, i2, g2)
    w2 = c2a >= c2b
    return (torch.where(w, r1, m1), torch.where(w2, c2a, c2b),
            torch.where(w, i1, g1), torch.where(w2, j2a, j2b))


def _group_cands_plain(qp, corpus, bias, row_scale, alpha, blk_n, gsz):
    """Per-(group of gsz blocks, lane) top-2: [B_pad, n_groups*256], each
    group's lane tops first, then its seconds, the layout K5 and K6 write.
    Each block's per-lane top-2 folds into a running pair that starts at
    (NEG_INF, index 0), block by block, as the reference's scratch does;
    the last group may hold fewer blocks."""
    cs, ci = _block_cands_plain(qp, corpus, bias, row_scale, alpha, blk_n)
    b = cs.shape[0]
    nb = cs.shape[1] // (CANDS_PER_LANE * LANE)
    ng = -(-nb // gsz)
    cs = cs.view(b, nb, CANDS_PER_LANE, LANE)
    ci = ci.view(b, nb, CANDS_PER_LANE, LANE)
    run = (torch.full((b, ng, LANE), NEG_INF, dtype=cs.dtype, device=cs.device),
           torch.full((b, ng, LANE), NEG_INF, dtype=cs.dtype, device=cs.device),
           torch.zeros((b, ng, LANE), dtype=ci.dtype, device=ci.device),
           torch.zeros((b, ng, LANE), dtype=ci.dtype, device=ci.device))
    first = torch.arange(ng, device=cs.device) * gsz
    for j in range(gsz):
        blk = first + j
        live = (blk < nb)[None, :, None]  # the last group may end early
        blk = blk.clamp(max=nb - 1)
        new = _merge_top2(*run, cs[:, blk, 0], cs[:, blk, 1], ci[:, blk, 0], ci[:, blk, 1])
        run = tuple(torch.where(live, n, o) for n, o in zip(new, run))
    r1, r2, i1, i2 = run
    return (torch.stack([r1, r2], 2).reshape(b, ng * CANDS_PER_LANE * LANE),
            torch.stack([i1, i2], 2).reshape(b, ng * CANDS_PER_LANE * LANE))


def _n_blocks(corpus, blk_n):
    """Blocks of a non-empty, block-padded corpus. Unlike the reference,
    which skips rows past the last whole block, an unpadded corpus raises."""
    n, d = corpus.shape
    if blk_n <= 0 or n % blk_n or d % LANE or n == 0:
        raise ValueError(f"corpus must be block-padded: N={n} (blk {blk_n}), D={d}")
    return n // blk_n


def _group_plan(q, corpus, blk_n, gsz):
    """(blk_b, gsz) of `_fused_group_emit` as the reference picks them
    (topk.py:433-446): the largest group that keeps >= 16 groups (>= 2048
    exactness buckets); the last group may be partial."""
    n_blocks = _n_blocks(corpus, blk_n)
    if gsz is None:
        gsz = max(1, n_blocks // 16)
    if gsz < 1:
        raise ValueError(f"gsz must be >= 1, got {gsz}")
    return min(MAX_BLK_B, round_up(q.shape[0], 8)), gsz


def _pipe_plan(q, corpus, blk_n, blk_b, gsz):
    """(blk_b, gsz) of `pipe_topk` as the reference picks them
    (_exp_pipe.py:146-152): gsz >= 2 and a divisor of n_blocks."""
    n_blocks = _n_blocks(corpus, blk_n)
    if blk_b <= 0 or blk_b % 8:
        raise ValueError(f"blk_b must be a positive multiple of 8, got {blk_b}")
    if gsz is None:
        gsz = max(2, n_blocks // 16)
        while n_blocks % gsz:
            gsz -= 1
    if gsz < 2 or n_blocks % gsz:
        raise ValueError(f"gsz must be >= 2 and divide n_blocks = {n_blocks}, got {gsz}")
    return min(blk_b, round_up(q.shape[0], 8)), gsz


def _group_outputs(corpus, b_pad, n_groups):
    cw = n_groups * CANDS_PER_LANE * LANE
    return (torch.empty((b_pad, cw), dtype=torch.float32, device=corpus.device),
            torch.empty((b_pad, cw), dtype=torch.int32, device=corpus.device))


def _group_grid_plan(b_pad: int, n_groups: int, sms: int):
    """(query rows per CTA, query tiles) of K5 / K6 on bf16 and int8 corpora
    on a card with `sms` SMs. The grid is n_groups x 2 lane halves x query
    tiles CTAs, each walking its whole group, so the candidates do not
    depend on the plan. The wider tile reads the corpus fewer times; it is
    taken where its grid fills `_GROUP_FILL` of the SMs, else the narrower
    one, whose grid is twice as large."""
    for tile_b in GROUP_TILE_B:
        q_tiles = -(-b_pad // tile_b)
        if 2 * n_groups * q_tiles >= _GROUP_FILL * sms:
            break
    return tile_b, q_tiles


def _group_cta(x: int, q_tiles: int):
    """(group, lane half, query tile) of CTA x of K5 / K6's grid, as the
    kernel decodes blockIdx.x: the CTAs of one group are adjacent, and
    within a group those of one lane half, which read the same rows."""
    return x // (2 * q_tiles), (x // q_tiles) % 2, x % q_tiles


def _lane_topk_group_cuda(qp, corpus, bias, row_scale, alpha, blk_n, gsz):
    """K5 on the card: [B_pad, n_groups*256] candidates. A CTA scans a
    whole group (f32) or one lane half of a whole group (bf16, int8) in
    ascending block order, so they are the reference's."""
    _check_kernel_inputs(qp, corpus, bias, row_scale, blk_n)
    if gsz < 1:
        raise ValueError(f"gsz must be >= 1, got {gsz}")
    return _launch_group("lane_topk_group", qp, corpus, bias, row_scale, alpha, blk_n, gsz)


def _lane_topk_group_pipe_cuda(qp, corpus, bias, alpha, blk_n, gsz):
    """K6 on the card: K5's candidates, bit for bit, for a gsz dividing
    n_blocks, with the selection of a tile overlapping the products of the
    next."""
    _check_kernel_inputs(qp, corpus, bias, None, blk_n)
    n_blocks = corpus.shape[0] // blk_n
    if gsz < 1 or n_blocks % gsz:
        raise ValueError(f"gsz must divide n_blocks = {n_blocks}, got {gsz}")
    return _launch_group("lane_topk_group_pipe", qp, corpus, bias, None, alpha, blk_n, gsz)


def _launch_group(name, qp, corpus, bias, row_scale, alpha, blk_n, gsz):
    """Launch K5 (`lane_topk_group`) or K6 (`lane_topk_group_pipe`; no row
    scale) on checked inputs and count it."""
    pipe = name == "lane_topk_group_pipe"
    b_pad, d = qp.shape
    n, n_blocks = corpus.shape[0], corpus.shape[0] // blk_n
    n_groups = -(-n_blocks // gsz)
    out_s, out_i = _group_outputs(corpus, b_pad, n_groups)
    lib = _kernels.library()
    scale = () if pipe else (_scale_ptr(row_scale),)
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream(corpus.device).cuda_stream
        if corpus.dtype == torch.float32:
            name += "_f32"
            err = getattr(lib, name)(
                qp.data_ptr(), corpus.data_ptr(), bias.data_ptr(), *scale, float(alpha),
                b_pad, d, blk_n, n_blocks, gsz, out_s.data_ptr(), out_i.data_ptr(), stream)
        else:
            tile_b, q_tiles = _group_grid_plan(b_pad, n_groups, _sm_count(corpus.device))
            # the kernel reads whole query tiles: pad the rows with zeros
            q_rows = q_tiles * tile_b
            if q_rows != b_pad:
                qp = torch.nn.functional.pad(qp, (0, 0, 0, q_rows - b_pad))
            err = getattr(lib, name)(
                qp.data_ptr(), corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], bias.data_ptr(),
                *scale, float(alpha), q_rows, b_pad, d, n, blk_n, n_blocks, gsz, tile_b,
                out_s.data_ptr(), out_i.data_ptr(), stream)
    _kernels.check(name, err)
    _kernels.count(LAUNCHES, name)
    return out_s, out_i


def _fused_group_emit(q, corpus, bias, *, k, alpha, blk_n, gsz=None, row_scale=None):
    """Stage 1 = grouped emission (K5): per-(group of gsz blocks, lane)
    top-2; stage 2 = `top_k_first` over [B, n_groups*256]. Returns (scores
    [B, k] f32 desc, idx [B, k] int64). The exactness bucket count is
    n_groups * 128. f32 corpora score in true f32, as the reference's
    Precision.HIGHEST. On a CPU tensor this is `_fused_group_emit_plain`."""
    if not corpus.is_cuda:
        return _fused_group_emit_plain(q, corpus, bias, k=k, alpha=alpha, blk_n=blk_n,
                                       gsz=gsz, row_scale=row_scale)
    blk_b, gsz = _group_plan(q, corpus, blk_n, gsz)
    qp = _pad_queries(q, blk_b, corpus.dtype)
    cs, ci = _lane_topk_group_cuda(qp, corpus, bias, row_scale, alpha, blk_n, gsz)
    return _topk_pad(cs[: q.shape[0]], ci[: q.shape[0]], k)


def _fused_group_emit_plain(q, corpus, bias, *, k, alpha, blk_n, gsz=None, row_scale=None):
    """Plain PyTorch version of K5 with the same candidates."""
    blk_b, gsz = _group_plan(q, corpus, blk_n, gsz)
    qp = _pad_queries(q, blk_b, corpus.dtype)
    cs, ci = _group_cands_plain(qp, corpus, bias, row_scale, alpha, blk_n, gsz)
    return _topk_pad(cs[: q.shape[0]], ci[: q.shape[0]], k)


def pipe_topk(q, corpus, bias, *, k, alpha=1.0, blk_n=2048, blk_b=256, gsz=None):
    """The pipelined grouped scan (K6): the candidates of
    `_fused_group_emit`, bit for bit, at a gsz >= 2 dividing n_blocks
    (default: the largest such gsz keeping >= 16 groups), no row scale;
    then `top_k_first`.
    f32 corpora score in true f32. (The TPU experiment scored f32 at the
    default matmul precision, which is not this module's exactness
    contract.) On a CPU tensor this is `_pipe_topk_plain`."""
    if not corpus.is_cuda:
        return _pipe_topk_plain(q, corpus, bias, k=k, alpha=alpha, blk_n=blk_n, blk_b=blk_b,
                                gsz=gsz)
    blk_b, gsz = _pipe_plan(q, corpus, blk_n, blk_b, gsz)
    qp = _pad_queries(q, blk_b, corpus.dtype)
    cs, ci = _lane_topk_group_pipe_cuda(qp, corpus, bias, alpha, blk_n, gsz)
    return _topk_pad(cs[: q.shape[0]], ci[: q.shape[0]], k)


def _pipe_topk_plain(q, corpus, bias, *, k, alpha=1.0, blk_n=2048, blk_b=256, gsz=None):
    """Plain PyTorch version of K6 with the same candidates."""
    blk_b, gsz = _pipe_plan(q, corpus, blk_n, blk_b, gsz)
    qp = _pad_queries(q, blk_b, corpus.dtype)
    cs, ci = _group_cands_plain(qp, corpus, bias, None, alpha, blk_n, gsz)
    return _topk_pad(cs[: q.shape[0]], ci[: q.shape[0]], k)


# --------------------------------------------------------------------------
# Lane-candidate path in plain PyTorch (the auto path for B > 32 on the CPU)
# --------------------------------------------------------------------------

# score-chunk budget: CH ~ 8M elements / B, clamped
_LANE_CH_MIN = 16384
_LANE_CH_MAX = 131072


def _lane_chunk_for(b: int, n: int) -> int:
    target = max(_LANE_CH_MIN, min(_LANE_CH_MAX, (8 << 20) // max(b, 1)))
    # bucket-count floor: at least ~16 chunks so candidate buckets stay
    # >= 2048 and the top-k miss probability stays negligible
    target = max(_LANE_CH_MIN, min(target, ((n // 16) // LANE) * LANE))
    # prefer a 128-aligned divisor of n near the target
    best = None
    lo, hi = max(LANE, target // 2), target * 2
    cand = (target // LANE) * LANE
    for delta in range(0, hi - lo, LANE):
        for c in (cand - delta, cand + delta):
            if lo <= c <= hi and c > 0 and n % c == 0:
                best = c
                break
        if best:
            return best
    # no divisor: round target down to a power-of-two multiple of the min
    ch = _LANE_CH_MIN
    while ch * 2 <= target:
        ch *= 2
    return ch


def flat_topk_lane(q, corpus, bias, *, k: int, alpha: float = 1.0,
                   ch: int | None = None, row_scale=None):
    """Lane-candidate flat scan: per-(chunk, lane) top-2 over chunks of
    `ch` rows, then `top_k_first`. No alignment requirements: the remainder
    after CH-chunking is scanned separately, padded to 128 rows with
    NEG_INF bias."""
    b = q.shape[0]
    n = corpus.shape[0]
    if ch is None:
        ch = _lane_chunk_for(b, n)
    qc = q.to(score_dtype(corpus.dtype))
    nch = n // ch
    rem = n - nch * ch
    parts_s, parts_i = [], []
    for off in range(0, nch * ch, ch):
        sl = slice(off, off + ch)
        s = _scores(qc, corpus[sl], bias[sl],
                    row_scale[sl] if row_scale is not None else None, alpha)
        cs, ci = _lane_top2(s, ch, off)
        parts_s.append(cs)
        parts_i.append(ci)
    if rem:
        off = nch * ch
        s = _scores(qc, corpus[off:], bias[off:],
                    row_scale[off:] if row_scale is not None else None, alpha)
        rpad = round_up(rem, LANE)
        if rpad != rem:
            s = torch.nn.functional.pad(s, (0, rpad - rem), value=NEG_INF)
        cs, ci = _lane_top2(s, rpad, off)
        parts_s.append(cs)
        parts_i.append(ci)
    return _topk_pad(torch.cat(parts_s, 1), torch.cat(parts_i, 1), k)


def _auto_route(b_pad: int, corpus_dtype, device_type: str) -> str:
    """The approximate path `auto` takes for a padded batch of b_pad
    queries: "fused" (`fused_flat_topk`: K1 up to 32 queries, K2 above) or
    "lane" (`flat_topk_lane`, plain PyTorch). Up to ACC_MAX_BLK_B queries
    K1 serves everywhere. Above, CPU tensors keep the reference's route,
    the lane scan (its rule was fitted to a TPU, where XLA beat the
    emitting kernel). On a CUDA device bf16 and int8 corpora go to K2,
    whose (block, lane) buckets are finer than the lane scan's (chunk,
    lane) ones: on an H100 it measured 4-9x faster than the lane scan at
    B = 40..256. An f32 corpus takes the f32 FMA K2, which reads the corpus
    once per 32 queries, so its time doubles with the batch while the lane
    scan's stays flat: 1.5-2.5x faster at B = 40..128, a tie at B = 256, so
    f32 goes to K2 up to F32_FUSED_MAX_B queries and to the lane scan above
    (PERF.md section 6 has the times, B = 512 among them)."""
    if b_pad <= ACC_MAX_BLK_B:
        return "fused"
    if device_type != "cuda":
        return "lane"
    if corpus_dtype == torch.float32 and b_pad > F32_FUSED_MAX_B:
        return "lane"
    return "fused"


def flat_search(q, corpus, bias, *, k: int, alpha: float = 1.0,
                mode: str = "auto", row_scale=None):
    """Dispatch:
      auto:  B <= 32  -> K1 (fused_flat_topk, running per-lane top-T);
             B > 32   -> K2 (fused_flat_topk) on a CUDA corpus (f32: up
                         to 256 queries), else the lane-candidate scan in
                         plain PyTorch (`_auto_route`);
             small N or huge k -> exact chunked path.
      'fused' forces fused_flat_topk (K1, or K2 for B > 32); 'exact' forces
      the chunked exact scan; 'fast' is served as 'auto' (module
      docstring). So on the card `auto` at B > 32 holds the reference's
      mode="fused" contract, ties included (K2's (block, lane) buckets and
      their order), not its `auto` one (the lane scan's (chunk, lane)
      buckets), which may keep another row among equal scores."""
    n, d = corpus.shape
    aligned = n % DEFAULT_BLK_N == 0 and d % LANE == 0
    approx_ok = aligned and k <= CANDS_PER_LANE * LANE
    if mode == "fused":
        return fused_flat_topk(q, corpus, bias, k=k, alpha=alpha, row_scale=row_scale)
    if mode == "exact" or not approx_ok or n < MIN_FUSED_N:
        return flat_topk_xla(q, corpus, bias, alpha, k, row_scale=row_scale)
    if _auto_route(round_up(q.shape[0], 8), corpus.dtype, corpus.device.type) == "fused":
        return fused_flat_topk(q, corpus, bias, k=k, alpha=alpha, row_scale=row_scale)
    return flat_topk_lane(q, corpus, bias, k=k, alpha=alpha, row_scale=row_scale)
