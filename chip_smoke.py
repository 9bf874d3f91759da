"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--profile]

Needs one CUDA device, nvcc (the kernels in tostore_tpu_torch/csrc/ are
built at first use; g++ for the optional native helper) and this
repository's tostore_tpu_torch package; it
imports nothing of JAX or tostore_tpu. Phases:

  1. K1 (lane_topk_acc) and K2 (lane_topk_emit) against their plain PyTorch
     versions on the same CUDA tensors: bf16 and int8+scale (the TMA /
     wgmma kernels of csrc/lane_scan.cuh) and f32 (the f32 FMA kernels
     lane_topk_acc_f32 / lane_topk_emit_f32); dot, l2 and cosine; N =
     131072, D = 768; K1 at B = 1, 7, 8, 9, 16, 24, 32 (every query width
     it instantiates), K2 at B = 40, 128, 256; blk_n 2048 and 4096; and,
     for l2, again with the split plan forced to 9 blocks per CTA (a CTA
     range that folds several blocks, more than T/2 so K1 bubble-inserts
     into sorted lists, the last split shorter). Scores within 1e-5 (f32)
     or 1e-4 (bf16, int8) of max(1, |score|), indices equal as sets
     outside near-ties at the k-th score.
  2. The main path at size: FlatVectorIndex(768, l2 / dot, "bfloat16") on
     the card, 1,000,000 seeded vectors upserted in chunks, 1% deleted, and
     an int8 and an f32 l2 index of the first 250,000 rows (the other
     corpus types; f32 takes the f32 FMA kernels); search_arrays at k = 10
     for B = 1, 8, 32 (auto -> K1), B = 256 auto (on the card -> K2) and
     B = 256 mode="fused" (K2), plus single-query search(). The kernels'
     launch counters are zeroed just before and read just after; each must
     equal what the dispatch rule says (auto at B = 256 among K2's). Top-10
     agreement with mode="exact" >= 0.999, the distances of the pks both
     return within the bf16 tolerance of the exact ones, and no deleted pk
     may come back; select_topk (the final selection) must launch. Then
     the device part of the l2 index's calls (`flat_search` auto at B = 1,
     8, 32, 256: K1 / K2 with their selections) and K5 with its merge at B
     = 256 run once under torch.cuda.set_sync_debug_mode("error"): no host
     sync.
  3. K1 and K2 against their plain versions on the main path's own inputs
     (every index's corpus, bias and scales, at capacity 1,048,576 a CTA
     folds several blocks), with the dtype's tolerance; then median ms per
     scan of the l2 index (CUDA events around the wrapper's call, its final
     top-k included), kernel beside plain version, for each B, with the
     kernel's own device time (torch.profiler), the bound (bytes over 3.35
     TB/s or FLOPs over 989 TFLOP/s, H100 SXM data sheet), the share of
     it, and `product_ms`: torch.mm of the same [B, 768] x [768, N] score
     product alone (cuBLAS; not the same function, no single PyTorch call
     computes the lane top-k); at B = 256 also the plain lane scan and
     mode="exact"; the f32 FMA K1 / K2 the same on the f32 index (B = 8,
     256). Then the flat auto route's crossover: for bf16 (1M rows), int8
     and f32 (250,000 rows) at B = 40, 64, 128, 256, 512, the K2 path beside the
     plain lane scan, ms per call in turns, and the route `auto` takes.
  4. With --profile: the corpus's read floors on this card (a device copy
     and an int16 max over it) and, from torch.profiler, each kernel's
     device time beside the device time of its whole call and the three
     largest other kernels of the call.
  5. K3 (ivf_bucket_probe) and K4 (ivf_adc) against their plain versions
     on CUDA tensors at the 1M / C = 1024 layout (C_exp = 1024, cap =
     1984, D = 768), B = 1, 8, 64 with random probe ids and B = 64 queries
     probing 16 of the same 32 buckets (shared buckets), P = 16, dead
     entries included: K3 for f32, bf16 and int8 + scale rows, dot / l2 /
     cosine; K4 for residual l2 and dot tables, M = 96 / K = 256 and M =
     192 / K = 16 packed; their grouping pre-pass (the pairs sorted by
     bucket) against its plain version, a stable sort, exactly.
  6. The IVF path at size, after the flat indexes are freed: 1,000,000
     seeded clustered rows (natural modes x3 + unit noise) at 768 dims,
     bf16, in IVFVectorIndex(768, "l2", "bfloat16", num_clusters=1024,
     nprobe=16); IVF-PQ on the first 500,000 with pq_subspaces=192 (K =
     16, packed) and 96 (K = 256). Each index is loaded, trained (timed),
     1% deleted and given 1,000 more rows (the append path). With every
     launch counter zeroed: search_arrays at B = 1, 8, 64 mode="probe",
     B = 8 auto, and one search(); K3, K4 and select_topk must each
     launch; the host syncs of a raw and a PQ probe call at B = 8 under
     set_sync_debug_mode("warn") are printed (a finding). Recall@10
     against mode="exact" >= 0.95 raw / 0.85 PQ, no deleted pk back, and
     shared pks' scores within the bf16 tolerance. The raw index's CUDA
     graphs (ops/graphs.py): one B = 1 key searched IVF_GRAPH_SEARCHES
     times, each answer equal to the eager probe's bit for bit; the first
     search eager, the second captures, each later one a replay that counts
     one launch of K3, one of its pre-pass and two of select_topk, as an
     eager search does; host ms of eager and replayed searches in turns (a
     finding). Then K3 and K4 against
     their plain versions on the indexes' own buckets, codes, bias and
     probes, and the grouping pre-pass against its plain version on the
     same probes, exactly; at B = 8 and 64, the L2 flushed before each timed call, the
     median ms of each call (CUDA events) and of its plain version, the
     kernel alone and its grouping pre-pass (torch.profiler), bound and
     share (K4's tables at 2 bytes an entry, with the share under the
     earlier f32-table bound beside it, and the shared-memory wavefronts
     of its table lookups), and K3's product_ms (torch.mm of the distinct probed
     buckets' rows with the queries) and the grouping pre-pass alone
     beside its plain version; then search_arrays probe against the flat
     scan at B = 1 to 256 (host clock) with the route `auto` takes at each
     B and whether it was the faster one here (marked, not asserted, and
     marked apart where the two are within the host clock's spread); with
     --profile, the device-time breakdown of a probe call.
  7. K5 (lane_topk_group) and K6 (lane_topk_group_pipe) against their
     plain versions: first on random CUDA tensors at N = 131072 (f32: the
     f32 FMA kernels; bf16 and int8: the TMA / wgmma kernels of
     csrc/lane_scan_group.cu; int8 with row scales for K5 only; l2 and dot;
     B = 40, 128, 256; K5 at gsz = 5, so its last group is partial; K6 at
     its default gsz; and B = 72, no multiple of a query tile, on a bias
     with whole lane halves, a whole group and single lanes dead, where
     K6's candidates must equal K5's bit for bit), then on the f32 index
     and on phase 2's l2 index (capacity 1,048,576, default gsz 32: 16
     groups). Candidates within twice the phase-1 tolerance, a row that
     differs on a near-tie checked for its bucket and its score, and the
     top-k as in phase 1. Then median ms of each kernel's call beside its
     plain version at B = 128 and 256, each kernel alone (torch.profiler)
     with its share of the bound, the kernel alone at each query tile
     width forced (what the grid plan chooses between), and top-10
     agreement with the exact scan (>= 0.999).
  8. Hybrid filtered search on the main path: a float column `price`
     (uniform [0, 1)) and an int column `ts` (epoch ms 1.7e12 + pk, every
     97th None) written through `filter_columns.update` into phase 2's l2
     index and phase 6's raw and M = 192 IVF indexes; three conditions
     (price < 0.25; a ts range whose ends cut between rows 1 ms apart; IS
     NOT NULL ts AND (the first OR the second)) compiled as the engine does
     (compilable, ensure, device_mask), their selectivity and device_mask
     ms. With every launch counter zeroed: flat search_arrays B = 1, 8, 32
     auto (K1), 256 auto, 256 fused (K2); K5 and K6 at B = 128 and 256 on
     the filtered bias; the same four kernels' f32 forms on the f32 index
     (for the conditions that select rows of it); IVF probe B = 8 and 64
     (K3 raw, K4 PQ). All six kernels and the four f32 forms must launch.
     Every hit must satisfy its predicate (evaluated
     on the host from the numpy columns) and no deleted pk may come back;
     flat and K5/K6 top-10 agreement with the exact scan under the same
     mask >= 0.999; IVF recall@10 against exact-with-mask is printed (the
     JAX package sets no filtered-IVF floor).

  9. The engine, through the facade only (tostore_tpu_torch.ToStoreTPU on
     the default device). (a) A memory database with a flat bf16 l2 table
     of 1,000,000 x 768 rows and `price` / `ts` fields, loaded through
     batch_insert in chunks of 20,000: ingest rows/s; the first search
     (which flushes the staged rows to the card); with the launch counters
     zeroed, 32 vector_search calls (one query a call: K1 must launch once
     per search; host-clock ms beside K1's kernel ms of phase 3); the same
     searches from 8 threads at once (equal results, K1 once per search,
     searches/s); a B = 256 search_arrays on the table's own index object
     (must launch K2); top-10 agreement with mode="exact" >= 0.999 over
     100 queries; a filtered search through the device mask whose every hit
     satisfies the predicate on the host; a delete that never comes back.
     (b) An IVF and an IVF-PQ (M = 192) table of 250,000 clustered rows, C
     = 512, nprobe 16: run_vector_maintenance trains each off-lock (timed),
     then vector_search(mode="probe") must launch K3 / K4 (`auto` takes the
     flat scan at this depth, by its fitted cost model), recall@10 against
     mode="exact" over the floors of phase 6. (c) Durability on a file
     database in a temporary directory at 250,000 rows (a table snapshot is
     one frame with a u32 length, and 1M rows of 768 f32 + 768 bf16 values
     are 4.7 GB; 500,000 fit, and phase 10c checkpoints two tables of
     250,000): ingest rows/s with the WAL on, flush() (checkpoint s and
     bytes), 2,000 more rows and a delete that live only in the WAL, the
     handle dropped without close(), reopen (s), first search (s): the same
     searches must give the same pks. Last, whether the native helper
     (tostore_tpu_torch/native, g++) or its Python form ran.

 10. The sharded path (tostore_tpu_torch/parallel/) at full width, on
     meshes whose 4 cells all live on cuda:0: (1, 4) and, for the query
     axis, (2, 2). The times of this phase are "4 cells on one card": they
     show what the sharded path costs over the single-device one, not how
     it scales. (a) ShardedFlatIndex(768, mesh, "l2", "bfloat16") with
     phase 2's 1,000,000 rows (4 stripes of 251,904, or 2 of 501,760 in
     two copies), 1% deleted: search_arrays at B = 1, 8, 256 against phase
     2's single-device index on the same queries (top-10 agreement >=
     0.999, shared pks' distances within the bf16 tolerance, no deleted
     pk); K1 / K2 launches must equal cells x calls; then K1 / K2 against
     their plain versions on every cell's own stripe, bias and queries
     (phase 3's tolerance); host-clock ms per call beside the
     single-device call, and the stripe scans' kernel time. (d) NCCL at world size 1 through parallel.mesh.init_distributed,
     a mesh built after it, and (a)'s B = 8 search through that mesh's
     collectives: equal results; the group is destroyed after. (b)
     ShardedIVFIndex raw (C = 1,024, nprobe 16) on phase 6's clustered
     rows over (1, 4) and residual PQ (M = 192, packed) on their first
     500,000 over (2, 2): the contiguous stripes must be the active route,
     K3 / K4 launches = cells x calls, recall@10 against mode="exact" over
     the floors of phase 6, K3 / K4 against their plain versions on every
     cell's own stripe, bias and probes (phase 6's tolerances, every score
     of every probed bucket), build s, probe ms; a search after deletes
     refreshes the stale bias; a slot mask hides its rows. (c) The engine:
     ToStoreTPU.memory(device="cuda:0", mesh_shape=(4,)) with a flat table
     of 1,000,000 rows (sharded_flat: K1 = 4 x searches, agreement with
     mode="exact", a filtered search whose hits all satisfy the predicate)
     and an IVF-PQ table of 250,000 clustered rows (sharded_ivf: trained
     inline on its first 20,000 rows, then run_vector_maintenance installs
     the 4x-growth retrain; K4 = 4 x searches; recall), K1 and K4 against
     their plain versions on each cell's tensors of these tables; then a
     file database of 250,000 rows a table (9c's depth, two tables) that
     checkpoints under (4,) and reopens under () and (2, 2): both return
     the same pks (two restores of one snapshot), and the live index's
     nearest rows. (e) dryrun_multichip(4) of __graft_entry_torch__.py on
     its default device, the card: K1 (f32) and K4 once per cell.

 11. The measuring scripts, each run from this checkout in a process of its
     own, as a user runs them: bench_torch.py (the headline line at 1M x
     768 bf16, B = 256: its metric name, value > 0, K2 launched by its
     counters), _verify_drive_torch.py (crash and reopen; must end in
     "VERIFY DRIVE OK") and bench_all_torch.py configs 1, 2, 4, 5 and 7
     (no error; recall or agreement against the exact scan >= 0.999 for
     #1, #2's auto-served rows and #4, every hit of #4 inside its
     predicate, #7's top-10 agreement with bf16 >= 0.95, #5's dry run
     passed; each config's kernels launched: K1 f32 / K1 and K2 / K1 /
     K1 f32 and K4 / K2 int8).

 12. The engine against the JAX package's own suites, and its untried
     entry points. (a) The nine reference suites that build vector tables
     (test_engine, test_review_regressions, test_aux, test_txn_buffered,
     test_surface_r4, test_durability_incremental, test_differential,
     test_concurrency, test_storage_seam), run unchanged through their
     shims (tests/test_torch_suite_*.py, tests/torch_suites.py) by pytest
     in a child process with every database's corpora on cuda:0: passed,
     failed, skipped and seconds per suite and the kernels each launched;
     any failed case fails the phase. (b) One file database (WAL on, the
     default config) with a flat bf16 l2 table of 250,000 x 768 rows
     (phase 9c's depth): (i) a transaction that inserts 1,000 vector rows
     and updates the vectors of 1,000 more, then raises: no rolled-back pk
     may come back and every updated row is found by its old vector; the
     same writes committed: each written row in the top-10 of its own
     vector + N(0, 0.01), top-10 agreement with mode="exact" >= 0.999
     over 256 queries; (ii) update_schema().rename_field("emb", "emb2"),
     which rebuilds the vector index from the column store at the next
     search: the count unchanged, top-10 agreement with a numpy exact
     oracle over the column store's vectors >= 0.999, the migration's and
     the first search's seconds; (iii) a writer process (this script with
     --kill9-writer) that batch_inserts 1,000-row vector batches on the card
     and is killed with SIGKILL after 5 acknowledgements: after the reopen
     every acknowledged row is there with its vector, no pk twice,
     check_integrity() clean, each acknowledged row in the top-10 of its
     own vector + noise; reopen s and first search ms. K1 must launch.

 13. Ties at full width (run after phase 8, on phase 6's IVF indexes; 13e
     after phase 10d). Every selection breaks exactly equal scores as the
     reference does (ops/topk.py `top_k_first`). A separate 1,048,576-slot
     bf16 l2 index (1,000,000 seeded rows) with one row copied to other
     lanes of its block, to its lane in 11 other blocks (two a block:
     more than T = 16 equal candidates in one lane; on both sides of K1's
     split boundaries and in both halves of K2's 4,096-row blocks) and to
     far blocks; an int8 and an f32 index of 250,000 rows with the same
     copies; 25 copies of one row appended to the raw and M = 192 IVF
     indexes. (a) Whether the copies score bit-identically in each
     kernel's raw candidates (K1, K2, K5, K1 int8 / f32, K3, K4, and the
     plain torch.mm); a route where they do not is named on a line. (b)
     With every counter zeroed: search_arrays at B = 1, 8, 32 (K1) and 256
     auto and fused (K2) on the bf16 index, B = 8 and 256 on the int8 and
     f32 ones, K5 and K6 at B = 256 (bf16, f32), IVF probe B = 8 (K3, K4);
     every kernel must launch. (c) Each route against its plain version on
     the same tensors: the same hits in the same order, no tolerance on
     order (scores within the dtype's), the plain versions with their
     selections plain too (`_plain_selection`); search_arrays' slots are
     the kernel's; the IVF probes against the same search with K3 / K4's
     plain versions swapped in. (d) select_topk against its plain version
     `_select_exact`, bit for bit in values and positions, on K2's real
     [256, 65,536] candidates, K1's per-lane lists and their final at B =
     32, an exact-scan chunk and K5's candidates (all on the copied rows),
     and one input a route at full width (`SELECT_SYNTH`: IVF probe
     selection, final top-k and re-rank pools at k = 10 and 100, k-means
     assignment, the sharded merge, the PQ scan, all-equal rows, +-0.0 /
     +-inf / NaN, misses, k = N, k above SELECT_CAP); then its median ms
     over K2's candidates, on the copies and on random scores, beside
     torch.topk (the library call), `_select_exact` and its bytes bound.
     (e) One (1, 4) sharded B = 8 call with copies in all 4 stripes
     against the same call through K1's plain version.

Prints the card's name and power limit, the torch and CUDA versions, the
build time, a JSON line of the kernels (each with its launches on its
path, max_abs_err, ms, plain_ms, bound_ms / bound_by computed from this
run's shapes, library_ms, null where no single PyTorch call computes the
function, kernel_ms where the kernel alone was timed, product_ms for
the lane scans and K3, and for K1-K4 engine_launches, their launches in
phase 9, sharded_launches, those of phase 10, and bench_launches, those
of phase 11's script processes summed, suite_launches, those of
phase 12a's child, entry_launches, K1's in phase 12b, and tie_launches, those
of phase 13b; the six kernels, then
their f32 forms, the IVF grouping pre-pass and the final selection
select_topk, with its launches in phases 2, 6, 8, 9, 10, 12b and 13b and
its times on random scores beside those on the copies), and last
`{"ok": true, ...}`. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 1234
N_ROWS = 1_000_000
DIMS = 768
K = 10
CHECK_N = 131072
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4, torch.int8: 1e-4}
NEG_INF = float(np.finfo(np.float32).min)
AGREEMENT_MIN = 0.999
# H100 SXM data sheet: HBM rate and dense peaks by operand type
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def _bound(nbytes, flops, peak="bf16"):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak rate of their type."""
    tb, tf = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[peak] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _scan_bound(b, c, bias, scale, out_cols):
    """Bound of a lane scan of B queries: the corpus, bias, scales and bf16
    queries read once, [B, out_cols] f32 + int32 candidates written once,
    2 B N D operations in bf16."""
    n, d = c.shape
    return _bound(_nbytes(c, bias, scale) + b * d * 2 + b * out_cols * 8, 2 * b * n * d)


def _check_topk(ks, ki, ps, pi, tol):
    """Kernel (ks, ki) vs plain (ps, pi) top-k; returns max |score diff|."""
    ks, ps = ks.double().cpu(), ps.double().cpu()
    err = (ks - ps).abs()
    if bool((err > tol * ps.abs().clamp(min=1.0)).any()):
        raise AssertionError(f"scores differ beyond {tol}: max abs err {err.max().item()}")
    ki, pi = ki.cpu().tolist(), pi.cpu().tolist()
    for b in range(ps.shape[0]):
        hit = ps[b] > NEG_INF / 2
        if not bool(hit.any()):
            continue
        last = ps[b][hit].min().item()
        got = {i: s for i, s, h in zip(ki[b], ks[b].tolist(), hit.tolist()) if h}
        want = {i: s for i, s, h in zip(pi[b], ps[b].tolist(), hit.tolist()) if h}
        for i in set(got) ^ set(want):
            v = got.get(i, want.get(i))
            if abs(v - last) > 2 * tol * max(1.0, abs(last)):
                raise AssertionError(f"row {b}: index {i} (score {v}) in one result only")
    return err.max().item()


def _corpus(rng, n, dtype, metric, dev):
    """(corpus, bias, row_scale, alpha) for one scan, made from the seed."""
    from tostore_tpu_torch.ops import distance as D

    scale = None
    if dtype == torch.int8:
        c = torch.from_numpy(rng.integers(-127, 128, (n, DIMS), dtype=np.int8)).to(dev)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32) / 127).to(dev)
        cf = c.float() * scale[:, None]
    else:
        cf = torch.from_numpy(rng.standard_normal((n, DIMS), dtype=np.float32)).to(dev)
        if metric == "cosine":
            cf = cf / cf.norm(dim=1, keepdim=True)
        c = cf.to(dtype)
        cf = c.float()
    valid = torch.from_numpy(rng.random(n) >= 0.01).to(dev)
    bias = D.make_bias(metric, (cf * cf).sum(1) if metric == "l2" else None, valid)
    return c, bias, scale, D.metric_alpha(metric)


K1_B = (1, 7, 8, 9, 16, 24, 32)
K2_B = (40, 128, 256)
FOLD_PER = 9  # blocks per CTA of a forced split plan: more than T/2, so K1 bubble-inserts


def _kernel_vs_plain(T, q, c, bias, scale, alpha, blk_n):
    """(name, kernel top-k, plain top-k): K1 for B <= 32, else K2; f32
    corpora take the f32 FMA kernels."""
    suffix = "_f32" if c.dtype == torch.float32 else ""
    if q.shape[0] <= 32:
        return ("lane_topk_acc" + suffix,
                T.fused_flat_topk(q, c, bias, k=K, alpha=alpha, blk_n=blk_n, row_scale=scale),
                T._fused_flat_topk_plain(q, c, bias, k=K, alpha=alpha, blk_n=blk_n,
                                         row_scale=scale))
    return ("lane_topk_emit" + suffix,
            T._fused_block_emit(q, c, bias, k=K, alpha=alpha, blk_n=blk_n, row_scale=scale),
            T._fused_block_emit_plain(q, c, bias, k=K, alpha=alpha, blk_n=blk_n,
                                      row_scale=scale))


def phase_kernels(dev, T):
    """Phase 1: each kernel against its plain version at N = 131072, every
    query width, both block sizes, and a forced plan that folds several
    blocks per CTA."""
    rng = np.random.default_rng(SEED)
    errs = {}
    plan = T._split_plan
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for metric in ("dot", "l2", "cosine"):
            c, bias, scale, alpha = _corpus(rng, CHECK_N, dtype, metric, dev)
            folds = (False, True) if metric == "l2" else (False,)
            for fold, blk_n, b in ((f, blk, b) for f in folds for blk in (2048, 4096)
                                   for b in K1_B + K2_B):
                q = rng.standard_normal((b, DIMS), dtype=np.float32)
                if metric == "cosine":
                    q = q / np.linalg.norm(q, axis=1, keepdims=True)
                q = torch.from_numpy(q).to(dev)
                if fold:
                    T._split_plan = lambda n_blocks, *_: (FOLD_PER, -(-n_blocks // FOLD_PER))
                try:
                    name, (ks, ki), (ps, pi) = _kernel_vs_plain(T, q, c, bias, scale, alpha,
                                                                blk_n)
                    torch.cuda.synchronize()
                finally:
                    T._split_plan = plan
                err = _check_topk(ks, ki, ps, pi, TOL[dtype])
                errs[name] = max(errs.get(name, 0.0), err)
                print(f"phase1 {name} {str(dtype)[6:]} {metric} B={b} blk_n={blk_n}"
                      f"{f' {FOLD_PER} blocks per CTA' if fold else ''}: max_abs_err {err}",
                      flush=True)
            del c, bias, scale
    return errs


SIDE_ROWS = 250_000  # the int8 and f32 l2 indexes: the first rows of the bf16 ones


def build_indexes(dev):
    """The two 1M bf16 indexes of the main path and, from their first
    SIDE_ROWS rows, an int8 and an f32 l2 index: the other corpus types of
    the flat path (f32 corpora take the f32 FMA kernels)."""
    from tostore_tpu_torch import FlatVectorIndex

    rng = np.random.default_rng(SEED + 1)
    idxs = {m: FlatVectorIndex(DIMS, m, "bfloat16", device=dev) for m in ("l2", "dot")}
    side = {p: FlatVectorIndex(DIMS, "l2", p, device=dev) for p in ("int8", "float32")}
    t0 = time.perf_counter()
    chunk = 125_000
    for off in range(0, N_ROWS, chunk):
        x = rng.standard_normal((chunk, DIMS), dtype=np.float32)
        pks = list(range(off, off + chunk))
        for idx in list(idxs.values()) + (list(side.values()) if off < SIDE_ROWS else []):
            idx.upsert(pks, x)
    deleted = set(rng.choice(N_ROWS, N_ROWS // 100, replace=False).tolist())
    for idx in idxs.values():
        idx.delete(sorted(deleted))
    for idx in side.values():
        idx.delete(sorted(p for p in deleted if p < SIDE_ROWS))
    torch.cuda.synchronize()
    print(f"built 2 indexes of {N_ROWS} x {DIMS} bf16 (capacity "
          f"{idxs['l2'].corpus.capacity}) and an int8 and an f32 one of {SIDE_ROWS} rows "
          f"(capacity {side['int8'].corpus.capacity}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return idxs, side, deleted


MAIN_CALLS = [(1, "auto"), (8, "auto"), (32, "auto"), (256, "auto"), (256, "fused")]
SIDE_CALLS = [(8, "auto"), (256, "auto"), (256, "fused")]
TIMED_B = (1, 8, 32, 256)
# the batches of the flat auto route's crossover (f32's routes cross past 256)
ROUTE_B = (40, 64, 128, 256, 512)


# ops/topk.py's counters of the flat scan's CUDA graphs (searches and keys), and K1's kernels
FLAT_GRAPH_COUNTERS = ("flat_graph", "flat_graph_capture")
FLAT_K1 = ("lane_topk_acc", "lane_topk_acc_f32")


def _flat_launches(T, calls):
    """The launches that (corpus dtype, B, mode) flat searches must make,
    by kernel: K1 up to 32 padded queries, K2 above for mode 'fused' and
    where `auto` takes the fused path on the card."""
    want = {}
    for dtype, b, mode in calls:
        b_pad = -(-b // 8) * 8
        if b_pad <= T.ACC_MAX_BLK_B:
            name = "lane_topk_acc"
        elif mode == "fused" or T._auto_route(b_pad, dtype, "cuda") == "fused":
            name = "lane_topk_emit"
        else:
            continue
        name += "_f32" if dtype == torch.float32 else ""
        want[name] = want.get(name, 0) + 1
    return want


def phase_main_path(idxs, side, deleted, T):
    """Phase 2: the main path through the public index API."""
    rng = np.random.default_rng(SEED + 2)
    queries = {b: rng.standard_normal((b, DIMS), dtype=np.float32)
               for b in sorted({b for b, _ in MAIN_CALLS} | set(ROUTE_B))}
    single = rng.standard_normal(DIMS, dtype=np.float32)
    calls = {**{name: MAIN_CALLS for name in idxs}, **{name: SIDE_CALLS for name in side}}
    idxs = {**idxs, **side}
    for key in T.LAUNCHES:
        T.LAUNCHES[key] = 0
    results = {}
    for name, idx in idxs.items():
        for b, mode in calls[name]:
            results[name, b, mode] = idx.search_arrays(queries[b], K, mode=mode)
        results[name, "single"] = idx.search(single, top_k=K)
    torch.cuda.synchronize()
    launches = dict(T.LAUNCHES)
    print(f"phase2 launches on the main path: {launches}", flush=True)
    want = _flat_launches(T, [(idx.corpus.vectors.dtype, b, mode) for name, idx in idxs.items()
                              for b, mode in calls[name] + [(1, "auto")]])
    # a search that captures its key's CUDA graph (vector/flat.py) runs K1 twice: eagerly, then
    # replayed
    captures = launches["flat_graph_capture"]
    for key in ("lane_topk_acc", "lane_topk_emit", "lane_topk_acc_f32", "lane_topk_emit_f32"):
        # K5/K6 run in phases 7-8; auto at B = 256 is among K2's launches
        extra = captures if key in FLAT_K1 else 0
        if launches[key] <= 0 or not want[key] <= launches[key] <= want[key] + extra:
            raise AssertionError(f"kernel {key}: {launches[key]} launches on the main path, "
                                 f"expected {want[key]} (+ up to {extra} captures)")
    if sum(launches[key] - want[key] for key in FLAT_K1) != captures:
        raise AssertionError(f"K1 launches on the main path: {captures} captures unaccounted")
    if launches["select_topk"] <= 0:
        raise AssertionError("select_topk was not launched on the main path")
    _no_host_sync(idxs["l2"], queries, T)

    agree = total = 0
    dist_err = 0.0
    for name, idx in idxs.items():
        for b, mode in calls[name]:
            dist, slots, pks = results[name, b, mode]
            if dist.shape != (b, K) or not np.isfinite(dist).all() or (slots < 0).any():
                raise AssertionError(f"{name} B={b} {mode}: bad result shape or values")
            if any(p in deleted for p in pks.ravel()):
                raise AssertionError(f"{name} B={b} {mode}: a deleted pk came back")
            edist, _, epks = idx.search_arrays(queries[b], K, mode="exact")
            for row in range(b):
                agree += len(set(pks[row].tolist()) & set(epks[row].tolist()))
                total += K
                err = _check_shared_dists(idx.metric, queries[b][row], pks[row], dist[row],
                                          epks[row], edist[row])
                dist_err = max(dist_err, err)
        hits = results[name, "single"]
        edist, _, epks = idx.search_arrays(single, K, mode="exact")
        if len(hits) != K or any(h.primary_key in deleted for h in hits):
            raise AssertionError(f"{name}: single-query search returned {len(hits)} hits")
        agree += len({h.primary_key for h in hits} & set(epks[0].tolist()))
        total += K
        err = _check_shared_dists(idx.metric, single, np.array([h.primary_key for h in hits]),
                                  np.array([h.distance for h in hits]), epks[0], edist[0])
        dist_err = max(dist_err, err)
    rate = agree / total
    print(f"phase2 top-{K} agreement with mode='exact': {rate} over {total // K} queries; "
          f"max |score diff| of shared pks {dist_err}", flush=True)
    if rate < AGREEMENT_MIN:
        raise AssertionError(f"top-{K} agreement {rate} < {AGREEMENT_MIN}")
    return launches, queries


SYNC_FREE_B = (1, 8, 32, 256)


def _no_host_sync(idx, queries, T):
    """The device part of phase 2's flat calls (`flat_search` auto: K1 at B
    = 1, 8, 32, K2 at 256, each with its selection) and K5 with its merge
    at B = 256, once each under torch.cuda.set_sync_debug_mode("error"): a
    host sync raises. The queries' upload and the results' copy to the host
    stay outside, as the caller's."""
    c = idx.corpus.vectors
    bias, alpha, scale = idx._bias_alpha(None)
    qts = {b: idx._prep_queries(queries[b])[0] for b in SYNC_FREE_B}
    calls = [(f"flat_search auto B={b}", lambda b=b: T.flat_search(
        qts[b], c, bias, k=K, alpha=alpha, row_scale=scale)) for b in SYNC_FREE_B]
    calls.append(("_fused_group_emit B=256", lambda: T._fused_group_emit(
        qts[256], c, bias, k=K, alpha=alpha, blk_n=BLK_N, row_scale=scale)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _, fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("phase2 no host sync (set_sync_debug_mode('error')) in: "
          + ", ".join(name for name, _ in calls), flush=True)


def _count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): the number of
    synchronizing CUDA operations it made."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def _check_shared_dists(metric, q, pks, dist, epks, edist, shift=None):
    """Distances of the pks that a search and the exact path both return,
    compared as scores (l2 before the sqrt) within the bf16 tolerance of
    max(1, |score|), after `shift(pk)`: a known difference of the two
    paths' score terms (None: none). An l2 distance of 0 was clamped from
    a negative squared distance (bf16 rounding of a near-duplicate) and
    carries no score, so it is not compared. Returns the largest |score
    difference|."""
    tol = TOL[torch.bfloat16]
    qsq = float(np.dot(q.astype(np.float64), q.astype(np.float64)))

    def score(d):
        d = float(d)
        return qsq - d * d if metric == "l2" else -d

    want = {p: score(d) for p, d in zip(epks.tolist(), edist.tolist())
            if not (metric == "l2" and d == 0.0)}  # clamped: the score is lost
    worst = 0.0
    for p, d in zip(pks.tolist(), dist.tolist()):
        if p not in want or (metric == "l2" and d == 0.0):
            continue
        err = abs(score(d) - want[p] - (shift(p) if shift is not None else 0.0))
        if err > tol * max(1.0, abs(want[p])):
            raise AssertionError(f"{metric}: pk {p} score {score(d)} vs exact {want[p]}")
        worst = max(worst, err)
    return worst


def _l2_flush(dev):
    """A thunk that evicts the 50 MB L2 by writing 64 MB, for timing a
    call that meets its data cold, as a search meets its buckets."""
    buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    return buf.zero_


def _median_ms(fn, reps=15, flush=None):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _kernel_device_ms(fn, calls=5, names=("lane_scan", "lane_topk"), flush=None):
    """Device time of the port's kernels (those whose names hold one of
    `names`) in one call of fn, from torch.profiler over `calls` calls,
    each after `flush` where one is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and any(n in ev.key for n in names))
    return us / calls / 1e3


def _pairs(idx, qt, b, T):
    """(name, fn) of the fused kernel at B and its plain version, on the
    index's own corpus, bias and scales, then the score product alone
    (torch.mm, cuBLAS); the lane scan and the exact scan join at B > 32.
    On an f32 corpus the kernels are the f32 FMA ones."""
    c = idx.corpus.vectors
    bias, alpha, scale = idx._bias_alpha(None)
    qb = qt.to(c.dtype)
    if c.dtype == torch.float32:
        product = ("product", lambda: torch.mm(qb, c.t()))
    else:
        product = ("product", lambda: torch.mm(qb, c.t(), out_dtype=torch.float32))
    if b <= 32:
        return (("lane_topk_acc", lambda: T.fused_flat_topk(
                    qt, c, bias, k=K, alpha=alpha, row_scale=scale)),
                ("plain", lambda: T._fused_flat_topk_plain(
                    qt, c, bias, k=K, alpha=alpha, row_scale=scale)),
                product)
    return (("lane_topk_emit", lambda: T._fused_block_emit(
                qt, c, bias, k=K, alpha=alpha, blk_n=4096, row_scale=scale)),
            ("plain", lambda: T._fused_block_emit_plain(
                qt, c, bias, k=K, alpha=alpha, blk_n=4096, row_scale=scale)),
            ("lane_scan", lambda: T.flat_topk_lane(
                qt, c, bias, k=K, alpha=alpha, row_scale=scale)),
            ("exact", lambda: T.flat_topk_xla(qt, c, bias, alpha, K, row_scale=scale)),
            product)


def _pair_bound(idx, b, T):
    """Bound of K1 (B <= 32: its [B, T*128] lists) or K2 (its [B, n_blocks
    * 256] candidates at blk_n 4096) on the index's corpus."""
    c = idx.corpus.vectors
    bias, _, scale = idx._bias_alpha(None)
    if b <= 32:
        return _scan_bound(b, c, bias, scale, T.MAX_T_CANDS * 128)
    return _scan_bound(b, c, bias, scale, c.shape[0] // 4096 * 256)


def phase_auto_route(idxs, queries, T):
    """Phase 3b: what `flat_search(mode="auto")` may take for B > 32 on
    the card, timed on each corpus type's l2 index: the fused path (K2)
    beside the plain lane scan, median ms per call in turns, and the route
    `_auto_route` takes. Returns {(dtype name, B): (K2 ms, lane ms)}."""
    out = {}
    for idx in idxs:
        c = idx.corpus.vectors
        bias, alpha, scale = idx._bias_alpha(None)
        name = str(c.dtype)[6:]
        for b in ROUTE_B:
            qt, _, _ = idx._prep_queries(queries[b])
            fns = (("fused", lambda: T.fused_flat_topk(qt, c, bias, k=K, alpha=alpha,
                                                       row_scale=scale)),
                   ("lane", lambda: T.flat_topk_lane(qt, c, bias, k=K, alpha=alpha,
                                                     row_scale=scale)))
            ms = {}
            for which, fn in fns + fns[::-1]:
                ms[which] = min(ms.get(which, np.inf), _median_ms(fn, reps=7))
            route = T._auto_route(-(-b // 8) * 8, c.dtype, "cuda")
            faster = min(ms, key=ms.get)
            out[name, b] = (ms["fused"], ms["lane"])
            print(f"phase3 auto route {name} N={c.shape[0]} B={b}: K2 path {ms['fused']:.4f} ms, "
                  f"lane scan {ms['lane']:.4f} ms; auto takes {route}, the faster is {faster}"
                  f"{'' if route == faster else ' (NOT the one taken)'}", flush=True)
    return out


def phase_main_kernels(idxs, side, queries, T, errs):
    """Phase 3: each kernel against its plain version on the main path's
    inputs, then device time per scan of the l2 index, kernel vs plain;
    the f32 FMA kernels the same on the f32 index at B = 8 and 256 (times
    keyed ("float32", B, name))."""
    for metric, idx in {**idxs, **side}.items():
        dtype = idx.corpus.vectors.dtype
        for b in TIMED_B:
            qt, _, _ = idx._prep_queries(queries[b])
            (_, kernel), (_, plain) = _pairs(idx, qt, b, T)[:2]
            name = ("lane_topk_acc" if b <= 32 else "lane_topk_emit") + (
                "_f32" if dtype == torch.float32 else "")
            ks, ki = kernel()
            ps, pi = plain()
            torch.cuda.synchronize()
            err = _check_topk(ks, ki, ps, pi, TOL[dtype])
            errs[name] = max(errs[name], err)
            print(f"phase3 {name} {metric} main-path inputs B={b}: max_abs_err {err}",
                  flush=True)
    times, bounds = {}, {}
    idx = side["float32"]
    for b in (8, 256):
        qt, _, _ = idx._prep_queries(queries[b])
        pair = _pairs(idx, qt, b, T)
        for name, fn in list(pair) + list(reversed(pair)):
            times.setdefault(("float32", b, name), []).append(_median_ms(fn, reps=7))
        c = idx.corpus.vectors
        bias, _, _ = idx._bias_alpha(None)
        cols = T.MAX_T_CANDS * 128 if b <= 32 else c.shape[0] // 4096 * 256
        # f32 queries (4 bytes an element) and f32 FMA operations
        bounds["float32", b] = _bound(_nbytes(c, bias) + b * c.shape[1] * 4 + b * cols * 8,
                                      2 * b * c.shape[0] * c.shape[1], "f32")
        print(f"phase3 f32 N={c.shape[0]} B={b}: " + "  ".join(
            f"{name} {min(times['float32', b, name]):.4f} ms" for name, _ in pair)
            + f"  |  bound {bounds['float32', b][0]:.4f} ms ({bounds['float32', b][1]})",
            flush=True)
    idx = idxs["l2"]
    for b in TIMED_B:
        qt, _, _ = idx._prep_queries(queries[b])
        pair = _pairs(idx, qt, b, T)
        # kernel, plain, ..., plain, kernel: each measured twice in turns
        order = list(pair) + list(reversed(pair))
        for name, fn in order:
            times.setdefault((b, name), []).append(_median_ms(fn))
        bounds[b] = _pair_bound(idx, b, T)
        kname = pair[0][0]
        times[b, "kernel"] = [_kernel_device_ms(pair[0][1])]
        t0 = time.perf_counter()
        for _ in range(5):
            idx.search_arrays(queries[b], K)
        host = (time.perf_counter() - t0) / 5 * 1e3
        row = "  ".join(f"{name} {min(times[b, name]):.4f} ms" for name, _ in pair)
        kms = times[b, "kernel"][0]
        print(f"phase3 B={b}: {row}  |  {kname} kernel alone {kms:.4f} ms device; bound "
              f"{bounds[b][0]:.4f} ms ({bounds[b][1]}), share {bounds[b][0] / kms:.4f} of the "
              f"kernel, {bounds[b][0] / min(times[b, kname]):.4f} of the call  |  "
              f"search_arrays(auto) {host:.3f} ms host clock", flush=True)
    return {key: min(v) for key, v in times.items()}, bounds


def phase_profile(idx, queries, T):
    """Phase 4 (--profile): the corpus's read floors, and each kernel's
    device time within its whole call from torch.profiler (5 calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    c = idx.corpus.vectors
    gb = c.numel() * c.element_size() / 1e9
    for name, fn in (("device copy", lambda: c.clone()),
                     ("int16 max", lambda: c.view(torch.int16).amax())):
        ms = _median_ms(fn)
        print(f"profile floor {name} of the {gb:.4f} GB corpus: {ms:.4f} ms", flush=True)
    for b in TIMED_B:
        qt, _, _ = idx._prep_queries(queries[b])
        name, fn = _pairs(idx, qt, b, T)[0]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        kern = total = 0.0
        other = {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            total += ev.self_device_time_total
            if "lane_scan" in ev.key or "lane_topk" in ev.key:
                kern += ev.self_device_time_total
            else:
                other[ev.key[:60]] = other.get(ev.key[:60], 0.0) + ev.self_device_time_total
        top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
        print(f"profile B={b}: {name} kernel {kern / 5e3:.4f} ms of {total / 5e3:.4f} ms "
              f"device per call; next: " + "; ".join(f"{k} {v / 5e3:.4f} ms" for k, v in top),
              flush=True)


# The 1M / C = 1024 bucket layout of phase 6: C_exp slices of cap rows.
IVF_C, IVF_CAP, IVF_D, IVF_P = 1024, 1984, 768, 16
IVF_B = (1, 8, 64)
ADC_CONFIGS = ((96, 256, False), (192, 16, True))  # (M, K, nibble-packed)
SHARED = (64, 32)  # shared-bucket inputs: B = 64 queries probing 16 of the same 32 buckets


def _check_grouping(IP, probes, c):
    """K3/K4's grouping pre-pass against its plain version (a stable sort
    by id): the same ids and pair order, exactly. Returns the measured
    max |difference| over both outputs (0 where it passes)."""
    got, want = IP._group_pairs_cuda(probes, c), IP._group_pairs_plain(probes, c)
    diff = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))
    if diff or got[0].shape != want[0].shape or got[1].shape != want[1].shape:
        raise AssertionError("the grouping pre-pass differs from its plain version: "
                             f"max |difference| {diff}")
    return float(diff)


def _probe_cases(gen, c, p, bs, dev):
    """(label, probes) of phase 5: random ids at each B, then SHARED."""
    cases = [(f"B={b}", torch.randint(0, c, (b, p), generator=gen, device=dev,
                                      dtype=torch.int32)) for b in bs]
    b, pool = SHARED
    buckets = torch.randperm(c, generator=gen, device=dev)[:pool]
    pick = torch.rand((b, pool), generator=gen, device=dev).argsort(dim=1)[:, :p]
    cases.append((f"B={b} sharing {pool} buckets", buckets[pick].to(torch.int32)))
    return cases


def _dead_bias(gen, base, dev):
    """base with NEG_INF on 1% of entries and past a random fill of each
    bucket (partly filled slices)."""
    c, cap = base.shape
    dead = torch.rand((c, cap), generator=gen, device=dev) < 0.01
    fill = torch.randint(cap // 2, cap + 1, (c, 1), generator=gen, device=dev)
    dead |= torch.arange(cap, device=dev)[None, :] >= fill
    return torch.where(dead, torch.full_like(base, NEG_INF), base)


def _bucket_store(gen, dtype, metric, dev, c=IVF_C, cap=IVF_CAP, d=IVF_D):
    """(bucket_vectors [c, cap, d], bias [c, cap], scale [c, cap] or None)."""
    scale = None
    if dtype == torch.int8:
        v = torch.randint(-127, 128, (c, cap, d), generator=gen, device=dev,
                          dtype=torch.int16).to(torch.int8)
        scale = (torch.rand((c, cap), generator=gen, device=dev) + 0.5) / 127
    else:
        v = torch.randn((c, cap, d), generator=gen, device=dev)
        if metric == "cosine":
            v = v / v.norm(dim=2, keepdim=True)
        v = v.to(dtype)
    base = torch.zeros((c, cap), device=dev)
    if metric == "l2":
        for i in range(0, c, 64):
            x = v[i : i + 64].float()
            if scale is not None:
                x = x * scale[i : i + 64, :, None]
            base[i : i + 64] = -(x * x).sum(dim=2)
    return v, _dead_bias(gen, base, dev), scale


def _check_scores(name, got, want, lim):
    """Kernel vs plain [B, P, cap] scores: dead entries dead in both, live
    ones within lim (a tensor of the same shape). Returns max |diff|."""
    live = want > NEG_INF / 2
    if not torch.equal(got > NEG_INF / 2, live):
        raise AssertionError(f"{name}: dead entries differ")
    err = (got - want).abs()
    if bool((err[live] > lim[live]).any()):
        raise AssertionError(f"{name}: scores differ beyond the tolerance: "
                             f"max abs err {err[live].max().item()}")
    return err[live].max().item() if bool(live.any()) else 0.0


def _k3_pair(IP, qf, probes, v, bias, scale):
    return (lambda: IP.bucket_probe_scores(qf, probes, v, bias, scale),
            lambda: IP._bucket_probe_scores_plain(qf, probes, v, bias, scale))


def _k4_pair(IP, tabs, probes, codes, bias):
    rounded = IP.round_tables(tabs)
    return (lambda: IP.adc_bucket_scores(tabs, probes, codes, bias),
            lambda: IP._adc_bucket_scores_plain(rounded, probes, codes, bias))


def phase_ivf_kernels(dev, IP, c=IVF_C, cap=IVF_CAP, d=IVF_D, p=IVF_P, bs=IVF_B,
                      adc_configs=ADC_CONFIGS):
    """Phase 5: K3 and K4 against their plain versions on CUDA tensors at
    the 1M / C = 1024 layout. K3: f32, bf16, int8 + scale for dot, l2 and
    cosine, within 1e-5 (f32) or 1e-4 (bf16, int8) of max(1, sum_i |q_i x_i|
    * scale), the scale of a dot product's rounding error: a score near 0
    is a sum that cancelled, and its error does not shrink with it. K4:
    residual l2 and dot tables, M = 96 / K = 256 and M = 192 / K = 16
    packed, within 1e-5 of sum_m |tab|. Dead entries in both. Each on
    random probe ids at every B and on SHARED inputs, where queries share
    buckets and the kernels read each once for all of them."""
    from tostore_tpu_torch.ops.runtime import score_dtype
    from tostore_tpu_torch.vector.pq import adc_tables_probed

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    errs = {"ivf_bucket_probe": 0.0, "ivf_adc": 0.0, "ivf_group_pairs": 0.0}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for metric in ("dot", "l2", "cosine"):
            v, bias, scale = _bucket_store(gen, dtype, metric, dev, c, cap, d)
            v_abs, zeros = v.abs(), torch.zeros_like(bias)
            alpha = 2.0 if metric == "l2" else 1.0
            for label, probes in _probe_cases(gen, c, p, bs, dev):
                q = torch.randn((probes.shape[0], d), generator=gen, device=dev)
                if metric == "cosine":
                    q = q / q.norm(dim=1, keepdim=True)
                qf = (q * alpha).to(score_dtype(dtype))
                errs["ivf_group_pairs"] = max(errs["ivf_group_pairs"],
                                              _check_grouping(IP, probes, c))
                kernel, plain = _k3_pair(IP, qf, probes, v, bias, scale)
                got, want = kernel(), plain()
                mag = IP._bucket_probe_scores_plain(qf.abs(), probes, v_abs, zeros, scale)
                torch.cuda.synchronize()
                lim = TOL[dtype] * mag.clamp(min=1.0)
                err = _check_scores("ivf_bucket_probe", got, want, lim)
                errs["ivf_bucket_probe"] = max(errs["ivf_bucket_probe"], err)
                print(f"phase5 ivf_bucket_probe {str(dtype)[6:]} {metric} {label}: "
                      f"max_abs_err {err}", flush=True)
            del v, v_abs, bias, scale
    for m, k, packed in adc_configs:
        rows = m // 2 if packed else m
        codes = torch.randint(0, 256 if packed else k, (c, rows, cap), generator=gen,
                              device=dev, dtype=torch.int16).to(torch.uint8)
        bias = _dead_bias(gen, torch.zeros((c, cap), device=dev), dev)
        codebooks = torch.randn((m, k, d // m), generator=gen, device=dev)
        cents = torch.randn((c, d), generator=gen, device=dev)
        for metric in ("l2", "dot"):
            for label, probes in _probe_cases(gen, c, p, bs, dev):
                q = torch.randn((probes.shape[0], d), generator=gen, device=dev)
                errs["ivf_group_pairs"] = max(errs["ivf_group_pairs"],
                                              _check_grouping(IP, probes, c))
                tabs, _ = adc_tables_probed(codebooks, q, cents, probes, metric=metric)
                kernel, plain = _k4_pair(IP, tabs, probes, codes, bias)
                got, want = kernel(), plain()
                mag = -IP._adc_bucket_scores_plain(IP.round_tables(tabs).abs(), probes, codes,
                                                   torch.zeros_like(bias))
                torch.cuda.synchronize()
                err = _check_scores("ivf_adc", got, want, 1e-5 * mag)
                errs["ivf_adc"] = max(errs["ivf_adc"], err)
                print(f"phase5 ivf_adc M={m} K={k}{' packed' if packed else ''} {metric} "
                      f"{label}: max_abs_err {err}", flush=True)
        del codes, bias
    return errs


# Phase 6: the IVF path at full size (bench_all.py:132 and :310).
IVF_N = 1_000_000
PQ_N = 500_000
IVF_NAT = 2000  # natural modes of the clustered data (bench_all.py:319)
IVF_CHUNK = 125_000
IVF_MAIN_CALLS = [(1, "probe"), (8, "probe"), (64, "probe"), (8, "auto")]
IVF_TIMED_B = (8, 64)
CROSSOVER_B = (1, 8, 32, 64, 128, 256)
HOST_SPREAD = 0.4  # host-clock ms of one call moved by this share between runs (PERF.md 7)
RECALL_MIN = {"raw": 0.95, "pq192": 0.85, "pq96": 0.85}  # test_vector_indexes.py:362,369
N_FRESH = 1000  # rows upserted after the build: the append path
IVF_CLUSTERS = 1024
PQ_CONFIGS = {"pq192": {"pq_subspaces": 192},  # auto K = 16, nibble-packed
              "pq96": {"pq_subspaces": 96, "pq_centroids": 256}}


def _clustered_rows(seed, n):
    """The JAX package's hard clustered data (test_vector_indexes.py:345-348):
    natural modes x3 plus unit noise, in host chunks."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((IVF_NAT, DIMS), dtype=np.float32) * 3
    chunks = []
    for off in range(0, n, IVF_CHUNK):
        m = min(IVF_CHUNK, n - off)
        chunks.append(centers[rng.integers(0, IVF_NAT, m)]
                      + rng.standard_normal((m, DIMS), dtype=np.float32))
    return chunks, rng


def build_ivf_indexes(dev):
    """The three IVF indexes of phase 6, each loaded in chunks, trained
    once (timed: train + buckets), then 1% deleted and N_FRESH rows
    appended to the trained layout."""
    from tostore_tpu_torch import IVFVectorIndex

    chunks, rng = _clustered_rows(SEED + 6, IVF_N)
    deleted = set(rng.choice(IVF_N, IVF_N // 100, replace=False).tolist())
    fresh = (chunks[0][rng.integers(0, IVF_CHUNK, N_FRESH)]
             + rng.standard_normal((N_FRESH, DIMS), dtype=np.float32) * 0.5)
    configs = {"raw": (IVF_N, {}), **{name: (PQ_N, kw) for name, kw in PQ_CONFIGS.items()}}
    idxs, build_s = {}, {}
    for name, (n, kw) in configs.items():
        idx = IVFVectorIndex(DIMS, "l2", "bfloat16", num_clusters=IVF_CLUSTERS, nprobe=16,
                             device=dev, **kw)
        idx.defer_retrain = True  # one build after the load, timed below
        for i, x in enumerate(chunks[: n // IVF_CHUNK]):
            idx.upsert(range(i * IVF_CHUNK, (i + 1) * IVF_CHUNK), x)
        idx.defer_retrain = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.train(force=True)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
        idx.delete(sorted(p for p in deleted if p < n))
        idx.upsert(range(IVF_N, IVF_N + N_FRESH), fresh)
        torch.cuda.synchronize()
        contig = idx.bucket_codes if idx.pq is not None else idx.bucket_vectors
        print(f"phase6 built {name}: {n} x {DIMS} bf16, C={IVF_CLUSTERS}, layout "
              f"{tuple(idx.buckets_slots.shape)}, contiguous {tuple(contig.shape)}; "
              f"train + buckets {build_s[name]:.4f} s", flush=True)
        idxs[name] = idx
    queries = {b: chunks[0][rng.integers(0, IVF_CHUNK, b)]
               + rng.standard_normal((b, DIMS), dtype=np.float32) * 0.1
               for b in sorted({b for b, _ in IVF_MAIN_CALLS} | set(CROSSOVER_B))}
    queries["single"] = fresh[3] + 0.01
    return idxs, deleted, queries, build_s


def phase_ivf_main_path(idxs, deleted, queries, T, IP):
    """Phase 6a: the IVF main path through the public API, with every
    kernel counter zeroed just before and read just after."""
    for table in (T.LAUNCHES, IP.LAUNCHES):
        for key in table:
            table[key] = 0
    results = {}
    for name, idx in idxs.items():
        for b, mode in IVF_MAIN_CALLS:
            results[name, b, mode] = idx.search_arrays(queries[b], K, mode=mode)
        results[name, "single"] = idx.search(queries["single"], top_k=K)
    torch.cuda.synchronize()
    launches = {**T.LAUNCHES, **IP.LAUNCHES}
    print(f"phase6 launches on the IVF main path: {launches}", flush=True)
    for key in ["ivf_bucket_probe", "ivf_adc", "ivf_group_pairs", "select_topk"]:
        if launches[key] <= 0:
            raise AssertionError(f"kernel {key} was not launched on the IVF main path")
    for name in ("raw", "pq192"):  # a finding, not a condition
        n_sync = _count_syncs(lambda: idxs[name].search_arrays(queries[8], K, mode="probe"))
        print(f"phase6 {name} search_arrays probe B=8: {n_sync} host syncs under "
              f"set_sync_debug_mode('warn') (the queries' upload and the results' copy to the "
              f"host among them)", flush=True)

    for name, idx in idxs.items():
        hit = total = 0
        dist_err = 0.0
        for b, mode in IVF_MAIN_CALLS:
            dist, slots, pks = results[name, b, mode]
            if dist.shape != (b, K) or not np.isfinite(dist).all() or (slots < 0).any():
                raise AssertionError(f"{name} B={b} {mode}: bad result shape or values")
            if any(p in deleted for p in pks.ravel()):
                raise AssertionError(f"{name} B={b} {mode}: a deleted pk came back")
            edist, _, epks = idx.search_arrays(queries[b], K, mode="exact")
            probed = mode == "probe" or not idx._flat_beats_probe(b, idx.nprobe)
            shift = _bias_shift(idx) if probed else None
            for row in range(b):
                hit += len(set(pks[row].tolist()) & set(epks[row].tolist()))
                total += K
                dist_err = max(dist_err, _check_shared_dists(
                    "l2", queries[b][row], pks[row], dist[row], epks[row], edist[row], shift))
        hits = results[name, "single"]
        if len(hits) != K or hits[0].primary_key != IVF_N + 3 or \
                any(h.primary_key in deleted for h in hits):
            raise AssertionError(f"{name}: single-query search returned {hits[:2]}")
        recall = hit / total
        print(f"phase6 {name}: recall@{K} vs mode='exact' {recall} over {total // K} queries; "
              f"max |score diff| of shared pks {dist_err}", flush=True)
        if recall < RECALL_MIN[name]:
            raise AssertionError(f"{name}: recall@{K} {recall} < {RECALL_MIN[name]}")
    return launches


# ops/ivfprobe.py's counters of the probe's CUDA graphs: searches and keys, not kernels
GRAPH_COUNTERS = ("ivf_probe_graph", "ivf_probe_graph_capture")
IVF_GRAPH_SEARCHES = 6  # one key: eager, capture, then replays
IVF_GRAPH_TIMED = 200  # B = 1 searches a side, in turns


def phase_ivf_graph(idx, queries, IP, T):
    """Phase 6a (graphs): the probe's stages as CUDA graphs on the raw 1M
    index, held to the eager probe bit for bit, with the launches each
    search counts."""
    from tostore_tpu_torch.vector import ivf as ivf_mod

    rows = queries[64]
    eligible = ivf_mod._probe_graph_eligible

    def eager(q):
        ivf_mod._probe_graph_eligible = lambda *a: False
        try:
            return idx.search_arrays(q, K, mode="probe")
        finally:
            ivf_mod._probe_graph_eligible = eligible

    keys = (*GRAPH_COUNTERS, "ivf_bucket_probe", "ivf_group_pairs", "select_topk")

    def counts():
        return {key: {**T.LAUNCHES, **IP.LAUNCHES}[key] for key in keys}

    idx._probe_graphs.clear()
    per = []
    for i in range(IVF_GRAPH_SEARCHES):
        q = rows[i: i + 1]
        want = eager(q)
        before = counts()
        got = idx.search_arrays(q, K, mode="probe")
        per.append({key: v - before[key] for key, v in counts().items()})
        if not (np.array_equal(got[1], want[1])
                and np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32))):
            raise AssertionError(f"graph search {i}: answers differ from the eager probe's")
    print(f"phase6 graphs: launches of {IVF_GRAPH_SEARCHES} searches of one B = 1 key "
          f"(eager, capture, replays): {per}", flush=True)
    one = {"ivf_bucket_probe": 1, "ivf_group_pairs": 1, "select_topk": 2}
    if per[0] != {"ivf_probe_graph": 0, "ivf_probe_graph_capture": 0, **one}:
        raise AssertionError(f"the key's first search did not run eagerly: {per[0]}")
    # the capture search runs each stage once eagerly on the capture stream, then replays it
    if per[1] != {"ivf_probe_graph": 1, "ivf_probe_graph_capture": 1,
                  **{key: 2 * n for key, n in one.items()}}:
        raise AssertionError(f"the key's second search did not capture: {per[1]}")
    for i, d in enumerate(per[2:], 2):
        if d != {"ivf_probe_graph": 1, "ivf_probe_graph_capture": 0, **one}:
            raise AssertionError(f"search {i} of the key did not replay once: {d}")
    ms = {"eager": [], "replay": []}
    for i in range(IVF_GRAPH_TIMED):
        q = rows[i % 64: i % 64 + 1]
        for side in ("eager", "replay") if i % 2 else ("replay", "eager"):
            t0 = time.perf_counter()
            eager(q) if side == "eager" else idx.search_arrays(q, K, mode="probe")
            ms[side].append((time.perf_counter() - t0) * 1e3)
    print("phase6 graphs: search_arrays B = 1 probe, host ms (median, p90 of "
          f"{IVF_GRAPH_TIMED}): " + "; ".join(
              f"{side} {np.median(v):.4f}, {np.percentile(v, 90):.4f}"
              for side, v in ms.items()), flush=True)


def _bias_shift(idx):
    """pk -> (probe score - exact score) term by term: the raw probe's l2
    bias of a row placed by the build is -|x|^2 of its stored bf16 row (as
    the JAX package builds it, ivf.py:329-333), the exact scan's the f32
    row's -sq_norm; rows appended later and the PQ re-rank use sq_norm."""
    if idx.bucket_vectors is None:
        return None
    idx._ensure_slot_host()
    c = idx.corpus

    def shift(pk):
        slot = c._pk_slot[pk]
        sl, pos = int(idx._slot_cluster[slot]), int(idx._slot_pos[slot])
        return float(idx.bucket_bias[sl, pos]) + float(c.sq_norms[slot])

    return shift


def _adc_wavefronts(codes, kp, packed):
    """Shared-memory wavefronts per warp-wide table lookup of K4 (1 = no
    bank conflict), mean over the lookups of these [n, rows, cap] codes:
    lane l of warp w looks up column 128 w + 4 l + j of its tile (j = 0..3,
    one instruction each) in a bf16 table of kp entries a row; a bank holds
    4-byte words, and a warp takes one wavefront per distinct word in its
    busiest bank."""
    n, rows, cap = codes.shape
    c = codes[:, :, : cap // 128 * 128].long()
    c = c.reshape(n, rows, -1, 32, 4).transpose(-1, -2)  # [..., j, lane]
    r = torch.arange(rows, device=c.device).view(1, rows, 1, 1, 1)
    if packed:  # byte row r: high nibble in table row 2r, low nibble in 2r + 1
        words = torch.stack([((2 * r) * kp + (c >> 4)) // 2, ((2 * r + 1) * kp + (c & 15)) // 2])
    else:
        words = (r * kp + c) // 2
    words = words.sort(dim=-1).values
    new = torch.ones_like(words, dtype=torch.float32)
    new[..., 1:] = (words[..., 1:] != words[..., :-1]).float()
    per_bank = torch.zeros(*words.shape[:-1], 32, device=c.device)
    per_bank.scatter_add_(-1, words % 32, new)
    return per_bank.amax(dim=-1).mean().item()


def _probe_args(idx, q, IP):
    """What search_arrays hands K3 or K4 for these queries, on the index's
    own tensors: a dict of the kernel's name, its thunk, its plain
    version's, a tolerance thunk and its bound; K3 adds `product`, the
    score product of the distinct probed buckets' rows with the queries
    (torch.mm, cuBLAS: a superset of the work, not the same
    function); K4 adds `bound_f32`, the bound with f32 tables, and
    `wavefronts`. The bound reads each probed bucket once (its rows or
    codes, bias and scales), the queries or the bf16 tables, and writes
    the [B, P, cap] scores."""
    from tostore_tpu_torch.ops.runtime import score_dtype
    from tostore_tpu_torch.vector.ivf import _pq_tables, _select_probes

    qt = torch.from_numpy(np.pad(q, ((0, 0), (0, idx.corpus.d_pad - DIMS)))).to(idx.device)
    probe = _select_probes(qt, idx.centroids, idx._slice_cluster_dev, idx.slice_bias, True,
                           idx.nprobe)
    zeros = torch.zeros_like(idx.bucket_bias)
    b, p = probe.shape
    probed = torch.unique(probe)
    n_probed = int(probed.numel())
    if idx.pq is None:
        qf = (qt * 2.0).to(score_dtype(idx.bucket_vectors.dtype)).contiguous()
        kernel, plain = _k3_pair(IP, qf, probe, idx.bucket_vectors, idx.bucket_bias,
                                 idx.bucket_scales)
        _, cap, d = idx.bucket_vectors.shape
        per_bucket = _nbytes(idx.bucket_vectors[0], idx.bucket_bias[0],
                             None if idx.bucket_scales is None else idx.bucket_scales[0])
        bound = _bound(n_probed * per_bucket + _nbytes(qf) + b * p * cap * 4,
                       2 * b * p * cap * d)
        rows = idx.bucket_vectors[probed].reshape(-1, d)
        return {"name": "ivf_bucket_probe", "kernel": kernel, "plain": plain, "probe": probe,
                "lim": lambda: TOL[torch.bfloat16] * IP._bucket_probe_scores_plain(
                    qf.abs(), probe, idx.bucket_vectors.abs(), zeros,
                    idx.bucket_scales).clamp(min=1.0),
                "bound": bound,
                "product": lambda: torch.mm(rows, qf.t(), out_dtype=torch.float32)}
    tabs, _ = _pq_tables(idx.pq.codebooks, qt[:, :DIMS], idx.centroids_exp[:, :DIMS], probe,
                         "l2", True)
    kernel, plain = _k4_pair(IP, tabs, probe, idx.bucket_codes, idx.bucket_bias)
    cap, m, k = idx.bucket_codes.shape[2], tabs.shape[2], tabs.shape[3]
    codes = _nbytes(idx.bucket_codes[0], idx.bucket_bias[0])
    packed = idx.bucket_codes.shape[1] * 2 == m
    return {"name": "ivf_adc", "kernel": kernel, "plain": plain, "probe": probe,
            "lim": lambda: -1e-5 * IP._adc_bucket_scores_plain(
                IP.round_tables(tabs).abs(), probe, idx.bucket_codes, zeros),
            # the tables carry bf16 values: 2 bytes an entry
            "bound": _bound(n_probed * codes + tabs.numel() * 2 + b * p * cap * 4,
                            b * p * cap * m, "f32"),
            "bound_f32": _bound(n_probed * codes + tabs.numel() * 4 + b * p * cap * 4,
                                b * p * cap * m, "f32"),
            "wavefronts": lambda: _adc_wavefronts(idx.bucket_codes[probed], k + (-k) % 8,
                                                  packed)}


# K3's and K4's main kernels, by name (the grouping pre-pass is ivf_group_kernel)
IVF_MAIN = ("ivf_probe_wgmma", "ivf_probe_f32", "ivf_adc_kernel")


def phase_ivf_kernels_main(idxs, queries, errs, IP):
    """Phase 6b: K3 and K4 against their plain versions on the indexes'
    own inputs (contiguous copies, bias, probes of the main path's
    queries) and the grouping pre-pass against its plain version on the
    same probes (errs["ivf_group_pairs"]), then, at B = 8 and 64, each timed call after the L2 is
    flushed (a search meets its buckets cold): the call's median ms (CUDA
    events), the kernel alone and the grouping pre-pass alone
    (torch.profiler), the plain version's ms, the bound
    and share; K3's product_ms; K4's share under the earlier bound with f32 tables
    and the bank wavefronts of its table lookups."""
    times, bounds = {}, {}
    flush = _l2_flush(next(iter(idxs.values())).device)
    for name, idx in idxs.items():
        for b in (1, 8, 64):
            a = _probe_args(idx, queries[b], IP)
            got, want, lim = a["kernel"](), a["plain"](), a["lim"]()
            torch.cuda.synchronize()
            err = _check_scores(a["name"], got, want, lim)
            errs[a["name"]] = max(errs[a["name"]], err)
            pre = _check_grouping(IP, a["probe"], idx.bucket_bias.shape[0])
            errs["ivf_group_pairs"] = max(errs["ivf_group_pairs"], pre)
            print(f"phase6 {a['name']} {name} main-path inputs B={b}: max_abs_err {err}; "
                  f"grouping pre-pass max |difference| {pre}", flush=True)
        for b in IVF_TIMED_B:
            a = _probe_args(idx, queries[b], IP)
            fns = [("kernel", a["kernel"]), ("plain", a["plain"])]
            if "product" in a:
                fns.append(("product", a["product"]))
            for which, fn in fns + fns[::-1]:  # each twice, in turns
                times.setdefault((name, b, which), []).append(_median_ms(fn, flush=flush))
            times[name, b, "kernel_alone"] = [_kernel_device_ms(a["kernel"], names=IVF_MAIN,
                                                                flush=flush)]
            times[name, b, "prepass"] = [_kernel_device_ms(a["kernel"], names=("ivf_group",),
                                                           flush=flush)]
            bound = bounds[name, b] = a["bound"]
            ms, alone = min(times[name, b, "kernel"]), times[name, b, "kernel_alone"][0]
            extra = ""
            if "product" in a:
                extra = f"  product_ms {min(times[name, b, 'product']):.4f}"
            else:
                extra = (f"  (earlier bound, f32 tables, {a['bound_f32'][0]:.4f} ms: share "
                         f"{a['bound_f32'][0] / alone:.4f} of the kernel); table lookups "
                         f"{a['wavefronts']():.4f} wavefronts each")
            if a["name"] == "ivf_bucket_probe" and b == IVF_TIMED_B[-1]:
                # the grouping pre-pass alone (K3 and K4 run it inside their call)
                probe, n_slices = a["probe"], idx.bucket_bias.shape[0]
                for which, fn in (("group_pairs", lambda: IP._group_pairs_cuda(probe, n_slices)),
                                  ("group_pairs plain",
                                   lambda: IP._group_pairs_plain(probe, n_slices))):
                    times[name, b, which] = [_median_ms(fn)]
                bounds[name, b, "group_pairs"] = _bound(3 * _nbytes(probe), 0)
                print(f"phase6 ivf_group_pairs {name} B={b}: call "
                      f"{times[name, b, 'group_pairs'][0]:.4f} ms, plain "
                      f"{times[name, b, 'group_pairs plain'][0]:.4f} ms", flush=True)
            print(f"phase6 {a['name']} {name} B={b}: call {ms:.4f} ms, kernel alone "
                  f"{alone:.4f} ms device (grouping pre-pass "
                  f"{times[name, b, 'prepass'][0]:.4f} ms), plain "
                  f"{min(times[name, b, 'plain']):.4f} ms; "
                  f"bound {bound[0]:.4f} ms ({bound[1]}), share {bound[0] / alone:.4f} of the "
                  f"kernel, {bound[0] / ms:.4f} of the call{extra}", flush=True)
    return {key: min(v) for key, v in times.items()}, bounds


def phase_ivf_crossover(idxs, queries):
    """Phase 6c: search_arrays with the probe (mode='probe') against the
    flat scan that auto may take instead, host clock per call (the median
    of 7, the better of two turns), with the route `_flat_beats_probe`
    takes at each B. A route that is not the faster one measured here is
    marked, not asserted: as the slower one where it loses by more than
    HOST_SPREAD, the spread of host-clock calls between runs, and as within
    the spread otherwise. Returns {(index, B): (probe ms, flat ms, route)}."""
    out = {}
    for name, idx in idxs.items():
        flat = idx._flat  # the index's flat view: the exact scan of its corpus
        row = []
        for b in CROSSOVER_B:
            q = queries[b]
            ms = {}
            for which, fn in (("probe", lambda: idx.search_arrays(q, K, mode="probe")),
                              ("flat", lambda: flat.search_arrays(q, K)),
                              ("flat", lambda: flat.search_arrays(q, K)),
                              ("probe", lambda: idx.search_arrays(q, K, mode="probe"))):
                fn()
                t = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    fn()
                    t.append((time.perf_counter() - t0) * 1e3)
                ms[which] = min(ms.get(which, np.inf), float(np.median(t)))
            route = "flat" if idx._flat_beats_probe(b, idx.nprobe) else "probe"
            faster = min(ms, key=ms.get)
            out[name, b] = (ms["probe"], ms["flat"], route)
            mark = ""
            if route != faster:
                mark = (" (the slower one here)" if ms[route] > (1 + HOST_SPREAD) * ms[faster]
                        else " (the slower one here, within the spread)")
            row.append(f"B={b} probe {ms['probe']:.3f} flat {ms['flat']:.3f} auto takes {route}"
                       f"{mark}")
        print(f"phase6 crossover {name} (ms per search_arrays, host clock): " + "; ".join(row),
              flush=True)
    return out


def phase_ivf_profile(idxs, queries):
    """Phase 6d (--profile): device time of one search_arrays(mode='probe')
    call on each IVF index, K3 / K4 beside the whole call, and the three
    largest other kernels, from torch.profiler (5 calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, idx in idxs.items():
        for b in IVF_TIMED_B:
            q = queries[b]
            idx.search_arrays(q, K, mode="probe")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    idx.search_arrays(q, K, mode="probe")
                torch.cuda.synchronize()
            kern = total = 0.0
            other = {}
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA:
                    continue
                total += ev.self_device_time_total
                if "ivf_" in ev.key:
                    kern += ev.self_device_time_total
                else:
                    other[ev.key[:60]] = other.get(ev.key[:60], 0.0) + ev.self_device_time_total
            top = sorted(other.items(), key=lambda kv: -kv[1])[:3]
            print(f"profile IVF {name} B={b}: kernel {kern / 5e3:.4f} ms of {total / 5e3:.4f} ms "
                  f"device per call; next: "
                  + "; ".join(f"{k} {v / 5e3:.4f} ms" for k, v in top), flush=True)


# Phase 7: K5 and K6 (groups of gsz 2048-row blocks).
BLK_N = 2048
GROUP_B = (40, 128, 256)
GROUP_TIMED_B = (128, 256)
GROUP_PARTIAL_GSZ = 5  # 64 blocks at CHECK_N: 13 groups, the last of 4 blocks


def _check_group_cands(name, kc, pc, qp, corpus, bias, scale, alpha, tol, group_rows):
    """K5/K6 candidates [B_pad, n_groups * 256] vs the plain version's: the
    same live entries, scores within 2 * tol of max(1, |score|), and where
    the rows differ (a near-tie made the other pick) the kernel's row lies
    in the same (group, lane) bucket and really has the score it reports.
    Returns (max |score diff|, number of rows that differ)."""
    ks, ki = kc[0].double(), kc[1].long()
    ps, pi = pc[0].double(), pc[1].long()
    live = ps > NEG_INF / 2
    if not torch.equal(ks > NEG_INF / 2, live):
        raise AssertionError(f"{name}: live candidates differ")
    err = (ks - ps).abs()
    lim = 2 * tol * ps.abs().clamp(min=1.0)
    if bool((err > lim)[live].any()):
        raise AssertionError(f"{name}: candidate scores differ beyond the tolerance: "
                             f"max abs err {err[live].max().item()}")
    bs, pos = (live & (ki != pi)).nonzero(as_tuple=True)
    rows = ki[bs, pos]
    if not bool(((rows % 128 == pos % 128) & (rows // group_rows == pos // 256)).all()):
        raise AssertionError(f"{name}: a candidate row outside its (group, lane) bucket")
    x = corpus[rows].double()
    if scale is not None:
        x = x * scale[rows, None].double()
    true = alpha * (qp[bs].double() * x).sum(1) + bias[rows].double()
    if bool(((true - ks[bs, pos]).abs() > lim[bs, pos]).any()):
        raise AssertionError(f"{name}: a candidate row does not have the score it reports")
    return (err[live].max().item() if bool(live.any()) else 0.0), len(rows)


def _group_check(T, name, q, c, bias, scale, alpha, gsz, label, errs):
    """One kernel against its plain version, candidates and top-k, with
    the wrapper's own padding and gsz rule; errs is keyed by the kernel's
    counter (`_f32` for an f32 corpus)."""
    key = name + ("_f32" if c.dtype == torch.float32 else "")
    if name == "lane_topk_group":
        blk_b, gsz = T._group_plan(q, c, BLK_N, gsz)
        qp = T._pad_queries(q, blk_b, c.dtype)
        kc = T._lane_topk_group_cuda(qp, c, bias, scale, alpha, BLK_N, gsz)
    else:
        blk_b, gsz = T._pipe_plan(q, c, BLK_N, 256, gsz)
        qp = T._pad_queries(q, blk_b, c.dtype)
        kc = T._lane_topk_group_pipe_cuda(qp, c, bias, alpha, BLK_N, gsz)
    pc = T._group_cands_plain(qp, c, bias, scale, alpha, BLK_N, gsz)
    torch.cuda.synchronize()
    err, ties = _check_group_cands(name, kc, pc, qp, c, bias, scale, alpha, TOL[c.dtype],
                                   gsz * BLK_N)
    b = q.shape[0]
    ks, ki = T._topk_pad(*kc, K)
    ps, pi = T._topk_pad(*pc, K)
    err = max(err, _check_topk(ks[:b], ki[:b], ps[:b], pi[:b], TOL[c.dtype]))
    errs[key] = max(errs[key], err)
    print(f"phase7 {key} {label} B={b} gsz={gsz} ({kc[0].shape[1] // 256} groups): "
          f"max_abs_err {err}; {ties} candidate rows differ on near-ties", flush=True)
    return kc


def _dead_halves(bias, blk_n, gsz):
    """bias with whole lane halves dead: lanes 0-63 of the first group's
    rows, lanes 64-127 of the second's, every row of the third group, and
    lanes 7 and 100 everywhere."""
    row = torch.arange(bias.shape[0], device=bias.device)
    lane, grp = row % 128, row // (blk_n * gsz)
    dead = (((grp == 0) & (lane < 64)) | ((grp == 1) & (lane >= 64)) | (grp == 2)
            | (lane == 7) | (lane == 100))
    return torch.where(dead, torch.full_like(bias, NEG_INF), bias)


def _group_pair(T, qt, c, bias, alpha):
    return (("lane_topk_group", lambda: T._fused_group_emit(
                qt, c, bias, k=K, alpha=alpha, blk_n=BLK_N)),
            ("lane_topk_group plain", lambda: T._fused_group_emit_plain(
                qt, c, bias, k=K, alpha=alpha, blk_n=BLK_N)),
            ("lane_topk_group_pipe", lambda: T.pipe_topk(qt, c, bias, k=K, alpha=alpha)),
            ("lane_topk_group_pipe plain", lambda: T._pipe_topk_plain(
                qt, c, bias, k=K, alpha=alpha)))


GROUP_NAMES = ("lane_scan_group", "lane_topk")  # the grouped kernels' names, all corpus types


def phase_group_kernels(dev, flat, f32_idx, T):
    """Phase 7: K5 and K6 against their plain versions on random inputs and
    on the main path's corpus, their device times and top-10 agreement."""
    rng = np.random.default_rng(SEED + 7)
    errs = {name + sfx: 0.0 for name in ("lane_topk_group", "lane_topk_group_pipe")
            for sfx in ("", "_f32")}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for metric in ("dot", "l2"):
            c, bias, scale, alpha = _corpus(rng, CHECK_N, dtype, metric, dev)
            label = f"{str(dtype)[6:]} {metric}"
            for b in GROUP_B:
                q = torch.from_numpy(rng.standard_normal((b, DIMS), dtype=np.float32)).to(dev)
                _group_check(T, "lane_topk_group", q, c, bias, scale, alpha, GROUP_PARTIAL_GSZ,
                             label, errs)
                _group_check(T, "lane_topk_group_pipe", q, c, bias, None, alpha, None, label,
                             errs)
            # whole lane halves dead, B = 72: no multiple of either query tile;
            # K6's candidates must equal K5's bit for bit
            q = torch.from_numpy(rng.standard_normal((72, DIMS), dtype=np.float32)).to(dev)
            dead = _dead_halves(bias, BLK_N, 4)
            k5 = _group_check(T, "lane_topk_group", q, c, dead, None, alpha, 4,
                              label + " dead lane halves", errs)
            k6 = _group_check(T, "lane_topk_group_pipe", q, c, dead, None, alpha, 4,
                              label + " dead lane halves", errs)
            if not (torch.equal(k5[0], k6[0]) and torch.equal(k5[1], k6[1])):
                raise AssertionError(f"{label}: K6's candidates differ from K5's")
            del c, bias, scale, dead

    times, bounds = {}, {}
    # the f32 FMA kernels on the f32 index's corpus
    c = f32_idx.corpus.vectors
    bias, alpha, _ = f32_idx._bias_alpha(None)
    b = GROUP_TIMED_B[-1]
    qt, _, _ = f32_idx._prep_queries(rng.standard_normal((b, DIMS), dtype=np.float32))
    for name in ("lane_topk_group", "lane_topk_group_pipe"):
        _group_check(T, name, qt, c, bias, None, alpha, None, "f32 index", errs)
    pair = _group_pair(T, qt, c, bias, alpha)
    for name, fn in list(pair) + list(reversed(pair)):
        times.setdefault(("float32", b, name), []).append(_median_ms(fn, reps=5))
    groups = -(-(c.shape[0] // BLK_N) // max(1, c.shape[0] // BLK_N // 16))
    bounds["float32", b] = _bound(_nbytes(c, bias) + b * c.shape[1] * 4 + b * groups * 256 * 8,
                                  2 * b * c.shape[0] * c.shape[1], "f32")
    print(f"phase7 f32 kernels N={c.shape[0]} B={b}: " + "  ".join(
        f"{name} {min(times['float32', b, name]):.4f} ms" for name, _ in pair)
        + f"  |  bound {bounds['float32', b][0]:.4f} ms ({bounds['float32', b][1]})", flush=True)

    c = flat.corpus.vectors
    bias, alpha, scale = flat._bias_alpha(None)
    if scale is not None:
        raise AssertionError("the main path's bf16 corpus carries no row scale")
    agree, total = {}, 0
    plan = T._group_grid_plan
    for b in GROUP_TIMED_B:
        qt, _, _ = flat._prep_queries(rng.standard_normal((b, DIMS), dtype=np.float32))
        for name in ("lane_topk_group", "lane_topk_group_pipe"):
            _group_check(T, name, qt, c, bias, None, alpha, None, "main-path inputs", errs)
        pair = _group_pair(T, qt, c, bias, alpha)
        qb = qt.to(c.dtype)
        product = ("product", lambda: torch.mm(qb, c.t(), out_dtype=torch.float32))
        for name, fn in list(pair) + [product] + list(reversed(pair)):  # twice, in turns
            times.setdefault((b, name), []).append(_median_ms(fn))
        for name, fn in pair[::2]:  # the kernel alone, device time
            times[b, name + " alone"] = [_kernel_device_ms(fn, names=GROUP_NAMES)]
        # each query tile width forced, kernel alone: what the grid plan chooses between
        width = {}
        for tile_b in T.GROUP_TILE_B:
            T._group_grid_plan = lambda b_pad, *_, tile_b=tile_b: (tile_b, -(-b_pad // tile_b))
            try:
                for name, fn in pair[::2]:
                    width[name, tile_b] = _kernel_device_ms(fn, names=GROUP_NAMES)
            finally:
                T._group_grid_plan = plan
        n_groups = c.shape[0] // (32 * BLK_N)
        print(f"phase7 B={b} query tile widths (kernel alone, ms; the plan takes "
              f"{plan(qt.shape[0], n_groups, T._sm_count(c.device))[0]}): " + "  ".join(
                  f"{name} NQ={tile_b} {ms:.4f}" for (name, tile_b), ms in width.items()),
              flush=True)
        _, ei = T.flat_topk_xla(qt, c, bias, alpha, K)
        ei = ei.cpu().tolist()
        for name, fn in pair[::2]:
            _, ki = fn()
            ki = ki.cpu().tolist()
            agree[name] = agree.get(name, 0) + sum(len(set(x) & set(y)) for x, y in zip(ki, ei))
        total += b * K
        # K5 and K6 write [B, 16 groups * 256] candidates at gsz 32
        bounds[b] = _scan_bound(b, c, bias, None, n_groups * 256)
        print(f"phase7 B={b}: " + "  ".join(f"{name} {min(times[b, name]):.4f} ms"
                                             for name, _ in list(pair) + [product])
              + "  |  kernel alone (device): " + "  ".join(
                  f"{name} {times[b, name + ' alone'][0]:.4f} ms" for name, _ in pair[::2])
              + f"  |  bound {bounds[b][0]:.4f} ms ({bounds[b][1]}), share "
              + " / ".join(f"{bounds[b][0] / times[b, name + ' alone'][0]:.4f}"
                           for name, _ in pair[::2]) + " of the kernels", flush=True)
    for name, n in agree.items():
        rate = n / total
        print(f"phase7 {name} top-{K} agreement with the exact scan: {rate} over "
              f"{total // K} queries", flush=True)
        if rate < AGREEMENT_MIN:
            raise AssertionError(f"{name}: top-{K} agreement {rate} < {AGREEMENT_MIN}")
    return errs, {key: min(v) for key, v in times.items()}, bounds


# Phase 8: hybrid filtered search (BASELINE.json config #4: price < 0.25).
T0_MS = 1_700_000_000_000
TS_NULL_EVERY = 97
TS_RANGE = (T0_MS + 250_001, T0_MS + 500_000)
HYBRID_FLAT_CALLS = [(1, "auto"), (8, "auto"), (32, "auto"), (256, "auto"), (256, "fused")]
HYBRID_GROUP_B = (128, 256)
HYBRID_IVF_CALLS = [(8, "probe"), (64, "probe")]
HYBRID_IVF = ("raw", "pq192")
HYBRID_F32_CALLS = [(8, "auto"), (256, "fused")]
HYBRID_F32_GROUP_B = 128
HYBRID_KERNELS = ("lane_topk_acc", "lane_topk_emit", "ivf_bucket_probe", "ivf_adc",
                  "lane_topk_group", "lane_topk_group_pipe", "lane_topk_acc_f32",
                  "lane_topk_emit_f32", "lane_topk_group_f32", "lane_topk_group_pipe_f32")


def _hybrid_conditions(QC):
    price = QC().where("price", "<", 0.25)
    ts = QC().where("ts", "between", TS_RANGE)
    either = QC().or_(QC().where("price", "<", 0.25)).or_(QC().where("ts", "between", TS_RANGE))
    return {"price<0.25": price, "ts between": ts,
            "ts isNot null & (price<0.25 | ts between)": QC().where("ts", "isNot", None)
            .and_(either)}


def _write_filter_columns(corpus, price, ts_null):
    """Both columns for every live pk (pk = row of the host arrays)."""
    pks = np.arange(len(price))
    slots = corpus.slots_for_pks(pks.tolist())
    live = slots >= 0
    s, p = slots[live], pks[live]
    fc = corpus.filter_columns
    fc.update("price", s, price[p].tolist(), corpus.capacity)
    fc.update("ts", s, [None if ts_null[x] else T0_MS + x for x in p.tolist()], corpus.capacity,
              kind="int")


def _compile_mask(filters, cond, corpus):
    """The engine's order (engine/database.py:2689-2695): compilable, ensure
    every referenced column, then the mask."""
    fc = corpus.filter_columns
    if not filters.compilable(cond, fc.names()):
        raise AssertionError(f"{cond!r} does not compile to a device mask")
    for name in cond.referenced_fields():
        fc.ensure(name, corpus.capacity)
    return filters.device_mask(cond, fc, corpus.capacity)


def phase_hybrid(flat, f32_idx, deleted, ivf_idxs, ivf_deleted, ivf_queries, T, IP):
    """Phase 8: filtered search through the flat (bf16 and f32) and IVF
    indexes and K5/K6 on the filtered bias, every kernel counter zeroed
    just before and read just after; predicates, tombstones, agreement and
    recall checked."""
    from tostore_tpu_torch.query import QueryCondition
    from tostore_tpu_torch.vector import filters

    rng = np.random.default_rng(SEED + 8)
    n = IVF_N + N_FRESH
    price = rng.random(n, dtype=np.float32)
    ts_null = np.arange(n) % TS_NULL_EVERY == 0
    idxs = {"flat": flat, "f32": f32_idx, **{name: ivf_idxs[name] for name in HYBRID_IVF}}
    t0 = time.perf_counter()
    for idx in idxs.values():
        _write_filter_columns(idx.corpus, price, ts_null)
    torch.cuda.synchronize()
    print(f"phase8 filter columns written to {len(idxs)} indexes in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    conds = _hybrid_conditions(QueryCondition)
    masks = {(key, name): _compile_mask(filters, cond, idx.corpus)
             for name, cond in conds.items() for key, idx in idxs.items()}
    live = flat.corpus.valid
    fc, cap = flat.corpus.filter_columns, flat.corpus.capacity
    for name, cond in conds.items():
        m = masks["flat", name]
        sel = (m & live).sum().item() / live.sum().item()
        ms = _median_ms(lambda: filters.device_mask(cond, fc, cap))
        print(f"phase8 condition {name}: selectivity {sel} of the flat index's live rows; "
              f"device_mask {ms:.4f} ms", flush=True)
    # the range's ends cut between rows 1 ms apart
    edge = [TS_RANGE[0] - T0_MS - 1, TS_RANGE[0] - T0_MS, TS_RANGE[1] - T0_MS,
            TS_RANGE[1] - T0_MS + 1]
    edge = [pk for pk in edge if pk not in deleted and not ts_null[pk]]
    got = masks["flat", "ts between"][torch.from_numpy(
        flat.corpus.slots_for_pks(edge)).to(flat.device)].tolist()
    want = [TS_RANGE[0] <= T0_MS + pk <= TS_RANGE[1] for pk in edge]
    if got != want:
        raise AssertionError(f"ts range edges {edge}: mask {got}, want {want}")

    rng = np.random.default_rng(SEED + 9)
    fq = {b: rng.standard_normal((b, DIMS), dtype=np.float32)
          for b in sorted({b for b, _ in HYBRID_FLAT_CALLS} | set(HYBRID_GROUP_B))}
    c, c32 = flat.corpus.vectors, f32_idx.corpus.vectors
    # the f32 index holds the first SIDE_ROWS pks only: the ts range misses it
    f32_conds = [name for name in conds
                 if int((masks["f32", name] & f32_idx.corpus.valid).sum()) >= 1000]
    for table in (T.LAUNCHES, IP.LAUNCHES):
        for key in table:
            table[key] = 0
    res = {}
    for name in conds:
        for b, mode in HYBRID_FLAT_CALLS:
            res["flat", name, b, mode] = flat.search_arrays(
                fq[b], K, slot_mask=masks["flat", name], mode=mode)
        bias, alpha, _ = flat._bias_alpha(masks["flat", name])
        for b in HYBRID_GROUP_B:
            qt, _, _ = flat._prep_queries(fq[b])
            res["lane_topk_group", name, b] = T._fused_group_emit(
                qt, c, bias, k=K, alpha=alpha, blk_n=BLK_N)
            res["lane_topk_group_pipe", name, b] = T.pipe_topk(qt, c, bias, k=K, alpha=alpha)
        if name in f32_conds:
            for b, mode in HYBRID_F32_CALLS:
                res["f32", name, b, mode] = f32_idx.search_arrays(
                    fq[b], K, slot_mask=masks["f32", name], mode=mode)
            bias, alpha, _ = f32_idx._bias_alpha(masks["f32", name])
            qt, _, _ = f32_idx._prep_queries(fq[HYBRID_F32_GROUP_B])
            res["lane_topk_group_f32", name] = T._fused_group_emit(
                qt, c32, bias, k=K, alpha=alpha, blk_n=BLK_N)
            res["lane_topk_group_pipe_f32", name] = T.pipe_topk(qt, c32, bias, k=K, alpha=alpha)
        for key in HYBRID_IVF:
            for b, mode in HYBRID_IVF_CALLS:
                res[key, name, b, mode] = idxs[key].search_arrays(
                    ivf_queries[b], K, slot_mask=masks[key, name], mode=mode)
    torch.cuda.synchronize()
    launches = {**T.LAUNCHES, **IP.LAUNCHES}
    print(f"phase8 launches on the hybrid path: {launches}", flush=True)
    for key in (*HYBRID_KERNELS, "select_topk"):
        if launches[key] <= 0:
            raise AssertionError(f"kernel {key} was not launched on the hybrid path")

    def check_hits(label, cond, pks, dead):
        for pk in pks.ravel():
            if pk is None:
                raise AssertionError(f"{label}: fewer than {K} hits")
            if pk in dead:
                raise AssertionError(f"{label}: deleted pk {pk} came back")
            rec = {"price": float(price[pk]), "ts": None if ts_null[pk] else T0_MS + pk}
            if not cond.matches(rec):
                raise AssertionError(f"{label}: pk {pk} {rec} fails {cond!r}")

    for name, cond in conds.items():
        agree, total = {}, {}
        for b, mode in HYBRID_FLAT_CALLS:
            dist, _, pks = res["flat", name, b, mode]
            check_hits(f"flat {name} B={b} {mode}", cond, pks, deleted)
            _, _, epks = flat.search_arrays(fq[b], K, slot_mask=masks["flat", name],
                                            mode="exact")
            agree["flat"] = agree.get("flat", 0) + sum(
                len(set(x) & set(y)) for x, y in zip(pks.tolist(), epks.tolist()))
            total["flat"] = total.get("flat", 0) + b * K
        bias, alpha, _ = flat._bias_alpha(masks["flat", name])
        for b in HYBRID_GROUP_B:
            qt, _, _ = flat._prep_queries(fq[b])
            _, ei = T.flat_topk_xla(qt, c, bias, alpha, K)
            ei = ei.cpu().tolist()
            for kname in ("lane_topk_group", "lane_topk_group_pipe"):
                _, ki = res[kname, name, b]
                pks = flat.corpus.pks_for_slots(ki.cpu().numpy())
                check_hits(f"{kname} {name} B={b}", cond, pks, deleted)
                agree[kname] = agree.get(kname, 0) + sum(
                    len(set(x) & set(y)) for x, y in zip(ki.cpu().tolist(), ei))
                total[kname] = total.get(kname, 0) + b * K
        for b, mode in HYBRID_F32_CALLS if name in f32_conds else []:
            _, _, pks = res["f32", name, b, mode]
            check_hits(f"f32 {name} B={b} {mode}", cond, pks, deleted)
            _, _, epks = f32_idx.search_arrays(fq[b], K, slot_mask=masks["f32", name],
                                               mode="exact")
            agree["f32"] = agree.get("f32", 0) + sum(
                len(set(x) & set(y)) for x, y in zip(pks.tolist(), epks.tolist()))
            total["f32"] = total.get("f32", 0) + b * K
        if name in f32_conds:
            bias, alpha, _ = f32_idx._bias_alpha(masks["f32", name])
            qt, _, _ = f32_idx._prep_queries(fq[HYBRID_F32_GROUP_B])
            _, ei = T.flat_topk_xla(qt, c32, bias, alpha, K)
            ei = ei.cpu().tolist()
            for kname in ("lane_topk_group_f32", "lane_topk_group_pipe_f32"):
                _, ki = res[kname, name]
                check_hits(f"{kname} {name}", cond,
                           f32_idx.corpus.pks_for_slots(ki.cpu().numpy()), deleted)
                agree[kname] = sum(len(set(x) & set(y)) for x, y in zip(ki.cpu().tolist(), ei))
                total[kname] = HYBRID_F32_GROUP_B * K
        for key in HYBRID_IVF:
            for b, mode in HYBRID_IVF_CALLS:
                _, _, pks = res[key, name, b, mode]
                check_hits(f"{key} {name} B={b}", cond, pks, ivf_deleted)
                _, _, epks = idxs[key].search_arrays(ivf_queries[b], K,
                                                     slot_mask=masks[key, name], mode="exact")
                agree[key] = agree.get(key, 0) + sum(
                    len(set(x) & set(y)) for x, y in zip(pks.tolist(), epks.tolist()))
                total[key] = total.get(key, 0) + b * K
        row = "; ".join(f"{key} {agree[key] / total[key]} over {total[key] // K}"
                        for key in agree)
        print(f"phase8 {name}: every hit satisfies it, no deleted pk; top-{K} agreement "
              f"(recall for IVF) with exact under the mask: {row}", flush=True)
        for key in ("flat", "lane_topk_group", "lane_topk_group_pipe", "f32",
                    "lane_topk_group_f32", "lane_topk_group_pipe_f32"):
            if key in agree and agree[key] / total[key] < AGREEMENT_MIN:
                raise AssertionError(f"{name} {key}: top-{K} agreement "
                                     f"{agree[key] / total[key]} < {AGREEMENT_MIN}")
    return launches


# Phase 9: the engine, through the public facade (tostore_tpu_torch.ToStoreTPU).
ENGINE_ROWS = 1_000_000      # the flat table: the main path's full width and depth
ENGINE_CHUNK = 20_000        # rows per batch_insert
ENGINE_IVF_ROWS = 250_000    # the IVF and IVF-PQ tables (clustered rows)
ENGINE_IVF_CLUSTERS = 512    # C scaled with the depth (1,024 at 1M rows); nprobe stays 16
ENGINE_DUR_ROWS = 250_000    # the file database of the durability leg (see phase_engine)
ENGINE_TAIL_ROWS = 2_000     # written after the checkpoint: they live only in the WAL
ENGINE_QUERIES = 32          # single-query searches per leg
ENGINE_THREADS = 8
ENGINE_EXACT_QUERIES = 100   # single-query searches held against mode="exact"
ENGINE_OPEN_KW = {}          # the default device; a CPU rehearsal sets {"device": "cpu"}


def _engine_schema(P, name, index_type="flat", **index):
    return P.TableSchema(
        name=name,
        fields=(
            P.FieldSchema("price", P.DataType.double),
            P.FieldSchema("ts", P.DataType.integer),
            P.FieldSchema("emb", P.DataType.vector, vector_config=P.VectorFieldConfig(
                dimensions=DIMS, precision="bfloat16")),
        ),
        indexes=(P.IndexSchema(fields=("emb",), type="vector",
                               vector_config=P.VectorIndexConfig(
                                   index_type=index_type, metric="l2", **index)),),
    )


def _engine_ingest(db, table, rows, price, ts_null, first_pk=1):
    """batch_insert in chunks of ENGINE_CHUNK records (pk = first_pk + row);
    `rows` yields float32 arrays. Returns (rows, seconds of the batch_insert
    calls alone: the record dicts are built outside the clock)."""
    pk, spent = first_pk, 0.0
    for x in rows:
        for a in range(0, len(x), ENGINE_CHUNK):
            recs = [{"id": pk + i, "price": float(price[pk + i - 1]),
                     "ts": None if ts_null[pk + i - 1] else T0_MS + pk + i, "emb": v}
                    for i, v in enumerate(x[a : a + ENGINE_CHUNK])]
            t0 = time.perf_counter()
            res = db.batch_insert(table, recs)
            spent += time.perf_counter() - t0
            if not res.is_success:
                raise AssertionError(f"batch_insert into {table}: {res}")
            pk += len(recs)
    return pk - first_pk, spent


def _normal_chunks(seed, n, chunk=125_000):
    rng = np.random.default_rng(seed)
    for off in range(0, n, chunk):
        yield rng.standard_normal((min(chunk, n - off), DIMS), dtype=np.float32)


def _zero_counters(T, IP):
    for table in (T.LAUNCHES, IP.LAUNCHES):
        for key in table:
            table[key] = 0


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _pks(hits):
    return [h.primary_key for h in hits]


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def _hard_drop(db):
    """A crash as the engine sees it: the WAL and the background jobs are
    cut, nothing is checkpointed, the handle is dropped without close()."""
    db.engine._wal.close()
    db.engine._crontab.stop()


def phase_engine(T, IP, smi, k1_kernel_ms):
    """Phase 9: a database opened through the facade on the default device
    inserts, searches (flat, filtered, IVF, IVF-PQ), deletes, checkpoints,
    is dropped without close() and reopens. Launch counters are zeroed
    before each leg and read after it. Returns the engine's launches of
    K1-K4."""
    import shutil
    import tempfile
    import threading

    import tostore_tpu_torch as P
    from tostore_tpu_torch import native

    tag = f"[{smi}]"
    rng = np.random.default_rng(SEED + 9)
    price = rng.random(ENGINE_ROWS + ENGINE_TAIL_ROWS + 1)
    ts_null = (np.arange(ENGINE_ROWS + ENGINE_TAIL_ROWS + 1) % TS_NULL_EVERY) == 0
    launches = {}

    # --- 9a: the flat table at full width, in a memory database
    db = P.ToStoreTPU.memory(schemas=[
        _engine_schema(P, "docs"),
        _engine_schema(P, "ivf", "ivf", num_clusters=ENGINE_IVF_CLUSTERS, nprobe=16),
        _engine_schema(P, "pq", "ivf", num_clusters=ENGINE_IVF_CLUSTERS, nprobe=16,
                       pq_subspaces=192),
    ], **ENGINE_OPEN_KW)
    n, spent = _engine_ingest(db, "docs", _normal_chunks(SEED + 10, ENGINE_ROWS), price, ts_null)
    print(f"phase9 ingest (memory database, flat bf16 l2, {n} x {DIMS}, batch_insert of "
          f"{ENGINE_CHUNK}): {n / spent:.0f} rows/s ({spent:.2f} s) {tag}", flush=True)
    queries = np.random.default_rng(SEED + 11).standard_normal(
        (max(ENGINE_QUERIES, ENGINE_EXACT_QUERIES, 256), DIMS), dtype=np.float32)
    t0 = time.perf_counter()
    db.vector_search("docs", "emb", queries[0], top_k=K)
    print(f"phase9 first search (flushes the staged vectors to the card): "
          f"{time.perf_counter() - t0:.2f} s {tag}", flush=True)
    idx = db.engine._table("docs").vector_index_for("emb")
    if idx.corpus.vectors.device.type != torch.device(ENGINE_OPEN_KW.get("device", "cuda")).type:
        raise AssertionError(f"the engine's corpus lies on {idx.corpus.vectors.device}")

    _zero_counters(T, IP)
    serial, ms = [], []
    for q in queries[:ENGINE_QUERIES]:
        t0 = time.perf_counter()
        serial.append(db.vector_search("docs", "emb", q, top_k=K))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches["lane_topk_acc"] = T.LAUNCHES["lane_topk_acc"]
    launches["select_topk"] = T.LAUNCHES["select_topk"]  # K1's two selections a search
    # the serial loop's first search captures the key's CUDA graph: K1 eagerly, then replayed
    captures = T.LAUNCHES["flat_graph_capture"]
    if launches["select_topk"] <= 0:
        raise AssertionError("phase9: select_topk was not launched by vector_search")
    direct = []  # the table's index alone: what the engine's layers add is the difference
    for q in queries[:ENGINE_QUERIES]:
        t0 = time.perf_counter()
        idx.search(q, top_k=K)
        direct.append((time.perf_counter() - t0) * 1e3)
    print(f"phase9 vector_search B=1: host clock median {np.median(ms):.4f} ms (min "
          f"{min(ms):.4f}; the index's own search() {np.median(direct):.4f}) beside K1's "
          f"kernel {k1_kernel_ms:.4f} ms (phase 3); K1 launches "
          f"{launches['lane_topk_acc']} in {ENGINE_QUERIES} searches {tag}", flush=True)
    if launches["lane_topk_acc"] != ENGINE_QUERIES + captures or captures > 1:
        raise AssertionError(f"K1 launched {launches['lane_topk_acc']} times in "
                             f"{ENGINE_QUERIES} vector_search calls ({captures} captures)")
    if any(len(h) != K or not all(np.isfinite(r.distance) for r in h) for h in serial):
        raise AssertionError("vector_search: bad result shape or values")

    _zero_counters(T, IP)
    got = [None] * ENGINE_THREADS
    errors = []

    def worker(i):
        try:
            got[i] = [db.vector_search("docs", "emb", q, top_k=K)
                      for q in queries[:ENGINE_QUERIES]]
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(ENGINE_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for i in range(ENGINE_THREADS):
        if [_pks(h) for h in got[i]] != [_pks(h) for h in serial]:
            raise AssertionError(f"thread {i}: results differ from the serial searches")
    n_thr = ENGINE_THREADS * ENGINE_QUERIES
    print(f"phase9 vector_search from {ENGINE_THREADS} threads: {n_thr / wall:.0f} searches/s "
          f"({n_thr} in {wall:.3f} s; one thread: {1e3 / np.median(ms):.0f}/s), results equal; "
          f"K1 launches {T.LAUNCHES['lane_topk_acc']} {tag}", flush=True)
    if T.LAUNCHES["lane_topk_acc"] != n_thr + T.LAUNCHES["flat_graph_capture"]:
        raise AssertionError(f"K1 launched {T.LAUNCHES['lane_topk_acc']} times in {n_thr} "
                             "searches from threads")

    _zero_counters(T, IP)
    dist, slots, pks = idx.search_arrays(queries[:256], K)
    launches["lane_topk_emit"] = T.LAUNCHES["lane_topk_emit"]
    if launches["lane_topk_emit"] <= 0 or dist.shape != (256, K) or (slots < 0).any():
        raise AssertionError(f"B=256 search_arrays on the table's index: K2 launches "
                             f"{launches['lane_topk_emit']}, shape {dist.shape}")
    if [int(p) for p in pks[0]] != _pks(serial[0]):
        raise AssertionError("B=256 search_arrays row 0 differs from vector_search")

    agree = 0
    for q in queries[:ENGINE_EXACT_QUERIES]:
        agree += len(set(_pks(db.vector_search("docs", "emb", q, top_k=K)))
                     & set(_pks(db.vector_search("docs", "emb", q, top_k=K, mode="exact"))))
    rate = agree / (K * ENGINE_EXACT_QUERIES)
    print(f"phase9 vector_search top-{K} agreement with mode='exact': {rate} over "
          f"{ENGINE_EXACT_QUERIES} queries; K2 launches on the table's index at B=256: "
          f"{launches['lane_topk_emit']}", flush=True)
    if rate < AGREEMENT_MIN:
        raise AssertionError(f"engine top-{K} agreement {rate} < {AGREEMENT_MIN}")

    cond = P.QueryCondition().where("price", "<", 0.25).where("ts", "between", TS_RANGE)
    lo, hi = TS_RANGE
    checked, ms = 0, []
    for q in queries[:8]:
        t0 = time.perf_counter()
        hits = db.vector_search("docs", "emb", q, top_k=K, condition=cond)
        ms.append((time.perf_counter() - t0) * 1e3)
        for h in hits:
            pk = h.primary_key
            if not (price[pk - 1] < 0.25 and not ts_null[pk - 1] and lo <= T0_MS + pk <= hi):
                raise AssertionError(f"filtered search returned pk {pk} against its predicate")
            checked += 1
    if checked == 0:
        raise AssertionError("filtered search returned nothing")
    fc = idx.corpus.filter_columns
    if not {"price", "ts"} <= set(fc.names()):
        raise AssertionError(f"the filter columns are not on the device: {fc.names()}")
    victim = serial[0][0].primary_key
    if not db.delete_by_pk("docs", victim).is_success:
        raise AssertionError("delete_by_pk failed")
    if victim in _pks(db.vector_search("docs", "emb", queries[0], top_k=K)):
        raise AssertionError(f"deleted pk {victim} came back")
    print(f"phase9 filtered search (device mask, price < 0.25 and ts between): host clock "
          f"median {np.median(ms):.4f} ms; {checked} hits all satisfy the predicate; deleted "
          f"pk {victim} never came back {tag}", flush=True)
    db.drop_table("docs")
    del idx, serial, got
    torch.cuda.empty_cache()

    # --- 9b: IVF and IVF-PQ tables, trained off-lock by maintenance
    chunks, crng = _clustered_rows(SEED + 12, ENGINE_IVF_ROWS)
    ivf_q = chunks[0][crng.integers(0, len(chunks[0]), ENGINE_QUERIES)] \
        + crng.standard_normal((ENGINE_QUERIES, DIMS), dtype=np.float32) * 0.1
    for name, kernel, floor in (("ivf", "ivf_bucket_probe", RECALL_MIN["raw"]),
                                ("pq", "ivf_adc", RECALL_MIN["pq192"])):
        n, spent = _engine_ingest(db, name, chunks, price, ts_null)
        db.vector_search(name, "emb", ivf_q[0], top_k=K)  # flushes; the index is untrained
        vi = db.engine._table(name).vector_index_for("emb")
        _sync()
        t0 = time.perf_counter()
        jobs = db.engine.run_vector_maintenance()
        _sync()
        train_s = time.perf_counter() - t0
        if not vi.trained or (name == "pq" and vi.pq is None):
            raise AssertionError(f"{name}: maintenance did not train the index")
        _zero_counters(T, IP)
        hit, ms = 0, []
        for q in ivf_q:
            t0 = time.perf_counter()
            got_pks = _pks(db.vector_search(name, "emb", q, top_k=K, mode="probe"))
            ms.append((time.perf_counter() - t0) * 1e3)
            hit += len(set(got_pks)
                       & set(_pks(db.vector_search(name, "emb", q, top_k=K, mode="exact"))))
        launches[kernel] = IP.LAUNCHES[kernel]
        recall = hit / (K * ENGINE_QUERIES)
        auto = "the flat scan" if vi._flat_beats_probe(1, vi.nprobe) else "the probe"
        print(f"phase9 {name} table: {n} x {DIMS} bf16 clustered rows, C={ENGINE_IVF_CLUSTERS}, "
              f"nprobe 16 (depth cut from 1M); ingest {n / spent:.0f} rows/s; maintenance "
              f"trained it off-lock in {train_s:.2f} s ({jobs} job); vector_search(mode='probe') "
              f"{np.median(ms):.4f} ms host clock, {kernel} launches {launches[kernel]}, "
              f"recall@{K} vs exact {recall} (`auto` takes {auto} at this depth) {tag}",
              flush=True)
        if launches[kernel] < ENGINE_QUERIES:
            raise AssertionError(f"{name}: {kernel} launched {launches[kernel]} times in "
                                 f"{ENGINE_QUERIES} probe searches")
        if recall < floor:
            raise AssertionError(f"{name}: recall@{K} {recall} < {floor}")
        db.drop_table(name)
        del vi
        torch.cuda.empty_cache()
    db.close()

    # --- 9c: durability on a file database. A table snapshot is one frame
    # whose length is a u32 (engine/storage.py write_atomic_framed): a row
    # costs 768 x 4 bytes in the column store and 768 x 2 in the corpus, so
    # 1,000,000 rows (4.7 GB) do not fit one frame and this leg runs at
    # ENGINE_DUR_ROWS: 500,000 rows fit, and the depth was halved again
    # when phase 10 (whose durability leg checkpoints two tables of this
    # depth, the same 2.3 GB) came to share the script's time.
    path = tempfile.mkdtemp(prefix="tostore_smoke_")
    try:
        db = P.ToStoreTPU.open(path, schemas=[_engine_schema(P, "docs")], **ENGINE_OPEN_KW)
        n, spent = _engine_ingest(db, "docs", _normal_chunks(SEED + 10, ENGINE_DUR_ROWS),
                                  price, ts_null)
        print(f"phase9 ingest (file database, WAL on, {n} x {DIMS}): {n / spent:.0f} rows/s "
              f"({spent:.2f} s) {tag}", flush=True)
        q = queries[1]
        before = _pks(db.vector_search("docs", "emb", q, top_k=K))
        t0 = time.perf_counter()
        db.flush()
        ckpt_s = time.perf_counter() - t0
        ckpt_bytes = _dir_bytes(path)
        tail = np.random.default_rng(SEED + 13).standard_normal(
            (ENGINE_TAIL_ROWS, DIMS), dtype=np.float32)
        _engine_ingest(db, "docs", [tail], price, ts_null, first_pk=ENGINE_ROWS + 1)
        db.delete_by_pk("docs", before[1])
        tail_q = tail[77] + np.float32(0.01)
        want_tail = _pks(db.vector_search("docs", "emb", tail_q, top_k=3))
        want = _pks(db.vector_search("docs", "emb", q, top_k=K))
        if want_tail[0] != ENGINE_ROWS + 78 or before[1] in want or want[0] != before[0]:
            raise AssertionError(f"before the drop: {want_tail}, {want} after {before}")
        _hard_drop(db)
        del db
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        db = P.ToStoreTPU.open(path, **ENGINE_OPEN_KW)
        open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_q = _pks(db.vector_search("docs", "emb", q, top_k=K))
        first_s = time.perf_counter() - t0
        got_tail = _pks(db.vector_search("docs", "emb", tail_q, top_k=3))
        recovered = db.engine._counters["recovered_wal_entries"]
        rows = db.count("docs")
        print(f"phase9 durability ({ENGINE_DUR_ROWS} rows; 1M rows overflow the u32 snapshot "
              f"frame, 500k fit): checkpoint {ckpt_s:.2f} s, {ckpt_bytes} bytes on disk; dropped "
              f"without close(); reopen {open_s:.2f} s, first search after reopen "
              f"{first_s:.2f} s, {recovered} WAL entries replayed, {rows} rows; the same "
              f"searches give the same pks {tag}", flush=True)
        if got_q != want or got_tail != want_tail:
            raise AssertionError(f"after reopen: {got_q} vs {want}; {got_tail} vs {want_tail}")
        if rows != ENGINE_DUR_ROWS + ENGINE_TAIL_ROWS - 1 or recovered <= 0:
            raise AssertionError(f"after reopen: {rows} rows, {recovered} WAL entries replayed")
        vi = db.engine._table("docs").vector_index_for("emb")
        if vi.corpus.vectors.dtype != torch.bfloat16:
            raise AssertionError("the reopened corpus is not bf16")
        db.close()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    print(f"phase9 native helper: {native.which()} "
          "(codec and key-encoding loops: the C++ helper, or its Python form)", flush=True)
    print(f"phase9 engine launches: {launches}", flush=True)
    return launches


# --------------------------------------------------------------------------
# Phase 10: the sharded path (parallel/) at full width, 4 cells on one card
# --------------------------------------------------------------------------

SHARD_CELL = "cuda:0"        # every cell of phase 10's meshes; a CPU rehearsal sets "cpu"
SHARD_FLAT_B = (1, 8, 256)
SHARD_IVF_B = (8, 64)
SHARD_REPS = 7               # host-clock repeats per timed call
SHARD_ENGINE_ROWS = ENGINE_ROWS          # the engine's flat table: phase 9a's depth
SHARD_ENGINE_IVF_ROWS = ENGINE_IVF_ROWS  # the engine's IVF-PQ table: phase 9b's depth
SHARD_SEED_ROWS = 20_000     # rows the IVF-PQ table trains on inline, before the 4x growth
SHARD_DUR_ROWS = 250_000     # the file database: phase 9c's depth, two tables
SHARD_ENGINE_QUERIES = 32


def _host_ms(fn, reps=None):
    """Median host-clock ms of fn(), the device drained before and after."""
    fn()
    _sync()
    times = []
    for _ in range(reps or SHARD_REPS):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _meshes():
    from tostore_tpu_torch.parallel import make_mesh

    return {"1x4": make_mesh(4, dp=1, devices=[SHARD_CELL] * 4),
            "2x2": make_mesh(4, dp=2, devices=[SHARD_CELL] * 4)}


def _want_launches(counter, want, what):
    got = {k: counter[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want} (cells x calls)")
    return got


def _stripe_flat_vs_plain(idx, queries, T, IP, errs, label):
    """K1 / K2 against their plain versions on every cell's own tensors: the
    cell's stripe, the bias search_arrays builds for it, and its dp slice of
    the padded queries, through `flat_search` as `sharded_flat_topk` calls
    it (a stripe is no multiple of 4,096 rows, so K2 takes 2,048-row blocks
    here, and the grid plan is another than at 1M rows). Scores within the
    corpus type's tolerance, as phases 1 and 3; the kernel must launch once
    per cell. Updates errs, returns {kernel: max |score diff|}."""
    from tostore_tpu_torch.ops import distance as D

    mesh, alpha, out = idx.mesh, D.metric_alpha(idx.metric), {}
    l2 = idx.metric == "l2"
    for b, q in queries.items():
        qx, _, _ = idx._prep_queries(q)
        bl = qx.shape[0] // mesh.shape["dp"]
        _zero_counters(T, IP)
        name = None
        for dpi, s, dev in mesh.owned:
            qb = qx[dpi * bl:(dpi + 1) * bl].to(dev)
            c = idx.vectors.part(dpi, s)
            bias = D.make_bias(idx.metric, idx.sq_norms.part(dpi, s) if l2 else None,
                               idx.valid.part(dpi, s))
            scale = idx.scales.part(dpi, s) if idx.scales is not None else None
            ks, ki = T.flat_search(qb, c, bias, k=K, alpha=alpha, row_scale=scale)
            blk_n, _, _, emit = T._acc_plan(qb, c, K, None)
            plain = T._fused_block_emit_plain if emit else T._fused_flat_topk_plain
            ps, pi = plain(qb, c, bias, k=K, alpha=alpha, blk_n=blk_n, row_scale=scale)
            _sync()
            name = ("lane_topk_emit" if emit else "lane_topk_acc") + (
                "_f32" if c.dtype == torch.float32 else "")
            err = _check_topk(ks, ki, ps, pi, TOL[c.dtype])
            out[name] = max(out.get(name, 0.0), err)
            errs[name] = max(errs[name], err)
        _want_launches(T.LAUNCHES, {name: len(mesh.owned)}, f"{label} B={b} kernel vs plain")
    rows = next(iter(idx.vectors.parts.values())).shape[0]
    print(f"{label} kernels vs plain on each of {len(mesh.owned)} cells' own stripe ({rows} "
          f"rows), bias and queries, B = {list(queries)}: max_abs_err {out}", flush=True)
    return out


def _cell_view(idx, dpi, s, dev):
    """One cell of a ShardedIVFIndex under the attribute names of the
    single-device index, as `_probe_args` reads them: the tensors that cell's
    probe body hands K3 / K4."""
    from types import SimpleNamespace

    def part(striped):
        return None if striped is None else striped.part(dpi, s)

    return SimpleNamespace(
        corpus=SimpleNamespace(d_pad=idx.d_pad), device=dev, centroids=idx.centroids.on(dev),
        _slice_cluster_dev=idx._slice_cluster_dev.on(dev), slice_bias=idx.slice_bias.on(dev),
        nprobe=min(idx.nprobe, idx.centroids_exp.shape[0]),
        centroids_exp=idx.centroids_exp.on(dev), bucket_bias=part(idx.bucket_bias),
        bucket_vectors=part(idx.bucket_vectors), bucket_scales=part(idx.bucket_scales),
        bucket_codes=part(idx.bucket_codes),
        pq=None if idx.pq is None else SimpleNamespace(codebooks=idx._codebooks().on(dev)))


def _stripe_ivf_vs_plain(idx, queries, T, IP, errs, label):
    """K3 (raw) or K4 (PQ) against its plain version on every cell's own
    contiguous stripe, cached bias, and the probes of its dp slice of the
    queries, at phase 6b's tolerances (every score of every probed bucket
    is compared, so a dropped tail cannot pass); the grouping pre-pass
    against its plain version on the same probes. The kernel must launch
    once per cell. Updates errs, returns (kernel, max |score diff|)."""
    mesh = idx.mesh
    if idx._bias_stale:
        raise AssertionError(f"{label}: the cached bucket bias is stale")
    worst, name = 0.0, None
    for b, q in queries.items():
        q = np.atleast_2d(q)
        bl = -(-q.shape[0] // mesh.shape["dp"])
        _zero_counters(T, IP)
        for dpi, s, dev in mesh.owned:
            qs = q[dpi * bl:(dpi + 1) * bl]
            if not len(qs):  # a batch padded up to dp: that cell scans a zero query
                qs = np.zeros((1, q.shape[1]), np.float32)
            view = _cell_view(idx, dpi, s, dev)
            a = _probe_args(view, qs, IP)
            got, want, lim = a["kernel"](), a["plain"](), a["lim"]()
            _sync()
            name = a["name"]
            err = _check_scores(f"{label} {name} cell ({dpi}, {s}) B={b}", got, want, lim)
            worst = max(worst, err)
            errs[name] = max(errs[name], err)
            pre = _check_grouping(IP, a["probe"], view.bucket_bias.shape[0])
            errs["ivf_group_pairs"] = max(errs["ivf_group_pairs"], pre)
        _want_launches(IP.LAUNCHES, {name: len(mesh.owned)}, f"{label} B={b} kernel vs plain")
    contig = idx.bucket_codes if idx.pq is not None else idx.bucket_vectors
    shape = tuple(next(iter(contig.parts.values())).shape)
    print(f"{label} {name} vs plain on each of {len(mesh.owned)} cells' own stripe {shape}, "
          f"bias and probes, B = {list(queries)}: max_abs_err {worst}", flush=True)
    return name, worst


def phase_sharded_flat(flat, deleted, T, IP, errs, tag):
    """Phase 10a: ShardedFlatIndex over 4 stripes of phase 2's rows, (1, 4)
    and (2, 2), against phase 2's single-device index on the same queries."""
    from tostore_tpu_torch.parallel import ShardedFlatIndex

    meshes = _meshes()
    idxs = {name: ShardedFlatIndex(DIMS, m, "l2", "bfloat16") for name, m in meshes.items()}
    rng = np.random.default_rng(SEED + 1)  # phase 2's rows again
    t0 = time.perf_counter()
    chunk = 125_000  # as build_indexes draws them
    for off in range(0, N_ROWS, chunk):
        x = rng.standard_normal((chunk, DIMS), dtype=np.float32)
        for idx in idxs.values():
            idx.upsert(list(range(off, off + chunk)), x)
    for idx in idxs.values():
        idx.delete(sorted(deleted))
    _sync()
    one = idxs["1x4"]
    print(f"phase10a built 2 sharded flat indexes of {N_ROWS} x {DIMS} bf16: (1, 4) with 4 "
          f"stripes of {one._rows_per_shard()} rows, (2, 2) with 2 stripes of "
          f"{idxs['2x2']._rows_per_shard()} in two copies, capacity {one.capacity}, in "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
    if len(one) != len(flat) or one.capacity % (4 * 2048):
        raise AssertionError(f"sharded index holds {len(one)} rows, capacity {one.capacity}")

    qrng = np.random.default_rng(SEED + 20)
    queries = {b: qrng.standard_normal((b, DIMS), dtype=np.float32) for b in SHARD_FLAT_B}
    single = {b: flat.search_arrays(q, K) for b, q in queries.items()}
    launches = {}
    for name, idx in idxs.items():
        _zero_counters(T, IP)
        got = {b: idx.search_arrays(q, K) for b, q in queries.items()}
        _sync()
        calls = [(torch.bfloat16, b // idx.mesh.shape["dp"] or 1, "auto") for b in SHARD_FLAT_B]
        want = {k: 4 * v for k, v in _flat_launches(T, calls).items()}
        launches[name] = _want_launches(T.LAUNCHES, want, f"phase10a {name}")
        launches[name]["select_topk"] = T.LAUNCHES["select_topk"]
        if launches[name]["select_topk"] <= 0:
            raise AssertionError(f"phase10a {name}: select_topk was not launched")
        agree = total = same_rows = 0
        dist_err = 0.0
        for b, (dist, pks) in got.items():
            sdist, _, spks = single[b]
            if dist.shape != (b, K) or not np.isfinite(dist).all():
                raise AssertionError(f"phase10a {name} B={b}: bad result shape or values")
            if any(p in deleted for p in pks.ravel()):
                raise AssertionError(f"phase10a {name} B={b}: a deleted pk came back")
            for row in range(b):
                agree += len(set(pks[row].tolist()) & set(spks[row].tolist()))
                same_rows += pks[row].tolist() == spks[row].tolist()
                total += K
                dist_err = max(dist_err, _check_shared_dists(
                    "l2", queries[b][row], pks[row], dist[row], spks[row], sdist[row]))
        print(f"phase10a {name}: top-{K} against the single-device index {agree / total} over "
              f"{total // K} queries ({same_rows} rows in the same order), max |score diff| of "
              f"shared pks {dist_err}; launches {launches[name]}", flush=True)
        if agree / total < AGREEMENT_MIN:
            raise AssertionError(f"phase10a {name}: agreement {agree / total}")
        _stripe_flat_vs_plain(idx, queries, T, IP, errs, f"phase10a {name}")
    times = {}
    for b, q in queries.items():
        times[b, "single"] = _host_ms(lambda: flat.search_arrays(q, K))
        for name, idx in idxs.items():
            times[b, name] = _host_ms(lambda: idx.search_arrays(q, K))
        fn = lambda: one.search_arrays(q, K)  # noqa: E731
        times[b, "kernels"] = _kernel_device_ms(fn) if SHARD_CELL != "cpu" else float("nan")
        print(f"phase10a search_arrays B={b} host clock ms, 4 cells on one card: single-device "
              f"{times[b, 'single']:.4f}, (1, 4) {times[b, '1x4']:.4f}, (2, 2) "
              f"{times[b, '2x2']:.4f}; the 4 stripe scans' kernels together "
              f"{times[b, 'kernels']:.4f} ms of device ({times[b, 'kernels'] / 4:.4f} a stripe "
              f"of {one._rows_per_shard()} rows) {tag}", flush=True)
    del idxs["2x2"]
    return one, queries, launches, times


def _load_sharded_ivf(mesh, chunks, n, deleted, fresh, **kw):
    """A ShardedIVFIndex loaded untrained, trained once (timed), then 1%
    deleted and N_FRESH rows appended to the trained layout."""
    from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    idx = ShardedIVFIndex(DIMS, mesh, "l2", "bfloat16", num_clusters=IVF_CLUSTERS, nprobe=16, **kw)
    floor, idx.min_train_size = idx.min_train_size, 1 << 62  # one build after the load
    for i, x in enumerate(chunks[: n // IVF_CHUNK]):
        idx.upsert(range(i * IVF_CHUNK, (i + 1) * IVF_CHUNK), x)
    idx.min_train_size = floor
    _sync()
    t0 = time.perf_counter()
    idx.train(force=True)
    _sync()
    build_s = time.perf_counter() - t0
    idx.delete(sorted(p for p in deleted if p < n))
    idx.upsert(range(IVF_N, IVF_N + N_FRESH), fresh)
    _sync()
    return idx, build_s


def phase_sharded_ivf(T, IP, errs, tag):
    """Phase 10b: ShardedIVFIndex raw on phase 6's clustered rows over (1,
    4), residual PQ (M = 192, packed) on their first PQ_N over (2, 2)."""
    meshes = _meshes()
    chunks, rng = _clustered_rows(SEED + 6, IVF_N)
    deleted = set(rng.choice(IVF_N, IVF_N // 100, replace=False).tolist())
    fresh = (chunks[0][rng.integers(0, IVF_CHUNK, N_FRESH)]
             + rng.standard_normal((N_FRESH, DIMS), dtype=np.float32) * 0.5)
    queries = {b: chunks[0][rng.integers(0, IVF_CHUNK, b)]
               + rng.standard_normal((b, DIMS), dtype=np.float32) * 0.1 for b in SHARD_IVF_B}
    launches, times, build = {}, {}, {}
    for name, shape, n, kw, kernel in (("raw", "1x4", IVF_N, {}, "ivf_bucket_probe"),
                                       ("pq192", "2x2", PQ_N, PQ_CONFIGS["pq192"], "ivf_adc")):
        idx, build[name] = _load_sharded_ivf(meshes[shape], chunks, n, deleted, fresh, **kw)
        contig = idx.bucket_codes if kw else idx.bucket_vectors
        if contig is None:
            raise AssertionError(f"phase10b {name}: no contiguous copy, the gather route is active")
        print(f"phase10b built {name} over {shape}: {n} x {DIMS} bf16, C={IVF_CLUSTERS}, "
              f"{idx.nsh} stripes, layout {tuple(idx.buckets.shape)}, contiguous "
              f"{tuple(contig.shape)}; train + buckets {build[name]:.4f} s {tag}", flush=True)
        _zero_counters(T, IP)
        got = {b: idx.search_arrays(q, K) for b, q in queries.items()}
        hits = idx.search(fresh[3] + 0.01, top_k=K)
        _sync()
        launches[name] = _want_launches(IP.LAUNCHES, {kernel: 4 * (len(queries) + 1)},
                                        f"phase10b {name}")
        if len(hits) != K or hits[0].primary_key != IVF_N + 3:
            raise AssertionError(f"phase10b {name}: single-query search returned {hits[:2]}")
        hit = total = 0
        for b, (dist, pks) in got.items():
            if dist.shape != (b, K) or not np.isfinite(dist).all():
                raise AssertionError(f"phase10b {name} B={b}: bad result shape or values")
            if any(p in deleted for p in pks.ravel()):
                raise AssertionError(f"phase10b {name} B={b}: a deleted pk came back")
            _, epks = idx.search_arrays(queries[b], K, mode="exact")
            for row in range(b):
                hit += len(set(pks[row].tolist()) & set(epks[row].tolist()))
                total += K
        recall = hit / total
        _stripe_ivf_vs_plain(idx, queries, T, IP, errs, f"phase10b {name} over {shape}")
        # a delete stales the cached bucket bias; the next search refreshes it
        q8 = queries[SHARD_IVF_B[0]]
        victims = sorted(set(got[SHARD_IVF_B[0]][1][:4, 0].tolist()))
        idx.delete(victims)
        if not idx._bias_stale:
            raise AssertionError(f"phase10b {name}: a delete did not stale the bucket bias")
        _, dpks = idx.search_arrays(q8, K)
        if idx._bias_stale or set(victims) & set(dpks.ravel().tolist()):
            raise AssertionError(f"phase10b {name}: stale bias {idx._bias_stale}, or a row "
                                 "deleted after the build came back")
        # a slot mask: the best hit of each query masked out never comes back
        best = dpks[:, 0].tolist()
        mask = torch.ones(idx.capacity, dtype=torch.bool, device=idx.device)
        mask[torch.from_numpy(idx.slots_for_pks(best)).to(idx.device)] = False
        _, mpks = idx.search_arrays(q8, K, slot_mask=mask)
        if set(best) & set(mpks.ravel().tolist()) or (mpks == None).any():  # noqa: E711
            raise AssertionError(f"phase10b {name}: a masked slot came back")
        for b, q in queries.items():
            times[name, b] = _host_ms(lambda: idx.search_arrays(q, K))
        print(f"phase10b {name} over {shape}: recall@{K} vs mode='exact' {recall} over "
              f"{total // K} queries; {kernel} launches {launches[name]}; no deleted or masked "
              f"pk back; search_arrays host clock ms, 4 cells on one card: "
              + ", ".join(f"B={b} {times[name, b]:.4f}" for b in queries) + f" {tag}", flush=True)
        if recall < RECALL_MIN[name]:
            raise AssertionError(f"phase10b {name}: recall@{K} {recall} < {RECALL_MIN[name]}")
        del idx, contig
        if SHARD_CELL != "cpu":
            torch.cuda.empty_cache()
    return launches, times, build


def phase_sharded_engine(T, IP, errs, tag):
    """Phase 10c: the engine over a mesh: ToStoreTPU.memory(device=one
    card, mesh_shape=(4,)) with a flat and an IVF-PQ table, then a file
    database that checkpoints and reopens under () and (2, 2)."""
    import shutil
    import tempfile

    import tostore_tpu_torch as P
    from tostore_tpu_torch.utils.rwlock import rw

    rng = np.random.default_rng(SEED + 9)
    price = rng.random(ENGINE_ROWS + 1)
    ts_null = (np.arange(ENGINE_ROWS + 1) % TS_NULL_EVERY) == 0
    schemas = [_engine_schema(P, "docs"),
               _engine_schema(P, "pq", "ivf", num_clusters=ENGINE_IVF_CLUSTERS, nprobe=16,
                              pq_subspaces=192)]
    launches = {}
    db = P.ToStoreTPU.memory(schemas=schemas, device=SHARD_CELL, mesh_shape=(4,))
    n, spent = _engine_ingest(db, "docs", _normal_chunks(SEED + 10, SHARD_ENGINE_ROWS),
                              price, ts_null)
    queries = np.random.default_rng(SEED + 11).standard_normal(
        (SHARD_ENGINE_QUERIES, DIMS), dtype=np.float32)
    t0 = time.perf_counter()
    db.vector_search("docs", "emb", queries[0], top_k=K)
    first_s = time.perf_counter() - t0
    vi = db.engine._table("docs").vector_index_for("emb")
    if vi.index_type != "sharded_flat" or vi.nsh != 4 or vi.device != torch.device(SHARD_CELL):
        raise AssertionError(f"the engine built {vi.index_type} on {vi.device}")
    _zero_counters(T, IP)
    serial, ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        serial.append(_pks(db.vector_search("docs", "emb", q, top_k=K)))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches["lane_topk_acc"] = T.LAUNCHES["lane_topk_acc"]
    launches["select_topk"] = T.LAUNCHES["select_topk"]
    _want_launches(T.LAUNCHES, {"lane_topk_acc": 4 * len(queries)}, "phase10c flat table")
    agree = sum(len(set(got) & set(_pks(db.vector_search("docs", "emb", q, top_k=K,
                                                         mode="exact"))))
                for q, got in zip(queries, serial)) / (K * len(queries))
    cond = P.QueryCondition().where("price", "<", 0.25).where("ts", "between", TS_RANGE)
    lo, hi = TS_RANGE
    checked = 0
    for q in queries[:8]:
        for h in db.vector_search("docs", "emb", q, top_k=K, condition=cond):
            pk = h.primary_key
            if not (price[pk - 1] < 0.25 and not ts_null[pk - 1] and lo <= T0_MS + pk <= hi):
                raise AssertionError(f"phase10c filtered search returned pk {pk}")
            checked += 1
    print(f"phase10c engine, mesh_shape=(4,) on {SHARD_CELL}: flat table {n} x {DIMS} "
          f"({vi.index_type}, {vi.nsh} stripes), ingest {n / spent:.0f} rows/s, first search "
          f"{first_s:.2f} s; vector_search B=1 host clock median {np.median(ms):.4f} ms, 4 "
          f"cells on one card; K1 launches {launches['lane_topk_acc']} in {len(queries)} "
          f"searches; agreement with mode='exact' {agree}; {checked} filtered hits all satisfy "
          f"the predicate {tag}", flush=True)
    if agree < AGREEMENT_MIN or checked == 0:
        raise AssertionError(f"phase10c: agreement {agree}, {checked} filtered hits")
    _stripe_flat_vs_plain(vi, {1: queries[:1]}, T, IP, errs, "phase10c flat table")
    db.drop_table("docs")
    del vi
    if SHARD_CELL != "cpu":
        torch.cuda.empty_cache()

    # the IVF-PQ table: trains inline at its first flush (the sharded index's
    # rule, as in the reference), grows 4x, and maintenance installs the retrain
    chunks, crng = _clustered_rows(SEED + 12, SHARD_ENGINE_IVF_ROWS)
    ivf_q = chunks[0][crng.integers(0, len(chunks[0]), SHARD_ENGINE_QUERIES)] \
        + crng.standard_normal((SHARD_ENGINE_QUERIES, DIMS), dtype=np.float32) * 0.1
    seed_rows = min(SHARD_SEED_ROWS, len(chunks[0]))
    _engine_ingest(db, "pq", [chunks[0][:seed_rows]], price, ts_null)
    db.vector_search("pq", "emb", ivf_q[0], top_k=K)
    vi = db.engine._table("pq").vector_index_for("emb")
    if vi.index_type != "sharded_ivf" or not vi.trained or vi.needs_retrain():
        raise AssertionError(f"phase10c pq: {vi.index_type}, trained {vi.trained}")
    rest = [chunks[0][seed_rows:]] + chunks[1:]
    n, spent = _engine_ingest(db, "pq", rest, price, ts_null, first_pk=seed_rows + 1)
    db.vector_search("pq", "emb", ivf_q[0], top_k=K)  # flushes the staged rows
    if not vi.needs_retrain():
        raise AssertionError("phase10c pq: 4x growth did not ask for a retrain")
    _sync()
    t0 = time.perf_counter()
    jobs = db.engine.run_vector_maintenance()
    _sync()
    train_s = time.perf_counter() - t0
    retrains = db.engine._counters.get("background_retrains", 0)
    if retrains < 1 or vi.needs_retrain() or vi.pq is None or vi.bucket_codes is None:
        # (the crontab's own maintenance tick may have taken the job first)
        raise AssertionError(f"phase10c pq: maintenance ran {jobs} jobs, {retrains} retrains")
    _zero_counters(T, IP)
    hit, ms = 0, []
    for q in ivf_q:
        t0 = time.perf_counter()
        got = _pks(db.vector_search("pq", "emb", q, top_k=K))
        ms.append((time.perf_counter() - t0) * 1e3)
        launches["ivf_adc"] = IP.LAUNCHES["ivf_adc"]
        hit += len(set(got) & set(_pks(db.vector_search("pq", "emb", q, top_k=K, mode="exact"))))
    _want_launches({"ivf_adc": launches["ivf_adc"]}, {"ivf_adc": 4 * len(ivf_q)},
                   "phase10c pq table")
    recall = hit / (K * len(ivf_q))
    print(f"phase10c pq table: {seed_rows + n} x {DIMS} clustered rows ({vi.index_type}, "
          f"C={ENGINE_IVF_CLUSTERS}, M=192 packed), trained inline on its first {seed_rows}; "
          f"maintenance installed the 4x-growth retrain off-lock in {train_s:.2f} s; "
          f"vector_search {np.median(ms):.4f} ms host clock, 4 cells on one card; K4 launches "
          f"{launches['ivf_adc']}; recall@{K} vs exact {recall} {tag}", flush=True)
    if recall < RECALL_MIN["pq192"]:
        raise AssertionError(f"phase10c pq: recall@{K} {recall}")
    _stripe_ivf_vs_plain(vi, {1: ivf_q[:1]}, T, IP, errs, "phase10c pq table")
    db.close()
    del vi, db
    if SHARD_CELL != "cpu":
        torch.cuda.empty_cache()

    # durability: a file database under (4,), checkpointed, reopened under ()
    # and (2, 2): the stripes are rebuilt for the mesh the opener has
    path = tempfile.mkdtemp(prefix="tostore_smoke_mesh_")
    try:
        db = P.ToStoreTPU.open(path, schemas=schemas, device=SHARD_CELL, mesh_shape=(4,))
        db.engine._table("pq").vector_index_for("emb").min_train_size = 1 << 62
        _engine_ingest(db, "docs", _normal_chunks(SEED + 10, SHARD_DUR_ROWS), price, ts_null)
        _engine_ingest(db, "pq", [c[: SHARD_DUR_ROWS // len(chunks)] for c in chunks],
                       price, ts_null)
        vi = db.engine._table("pq").vector_index_for("emb")
        db.vector_search("pq", "emb", ivf_q[0], top_k=K)  # flush, still untrained
        vi.min_train_size = 4096
        with rw(vi).write():
            vi.train()  # one build over all rows
        want = {("docs", j): _pks(db.vector_search("docs", "emb", queries[j], top_k=K))
                for j in range(4)}
        want.update({("pq", j): _pks(db.vector_search("pq", "emb", ivf_q[j], top_k=K,
                                                      mode="exact")) for j in range(4)})
        probe = [_pks(db.vector_search("pq", "emb", ivf_q[j], top_k=K)) for j in range(4)]
        t0 = time.perf_counter()
        db.flush()
        ckpt_s = time.perf_counter() - t0
        ckpt_bytes = _dir_bytes(path)
        db.close()
        del vi, db
        report, restored = [], None
        for shape, kinds in (((), ("flat", "ivf")), ((2, 2), ("sharded_flat", "sharded_ivf"))):
            if SHARD_CELL != "cpu":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            db = P.ToStoreTPU.open(path, device=SHARD_CELL, mesh_shape=shape)
            got = {("docs", j): _pks(db.vector_search("docs", "emb", queries[j], top_k=K))
                   for j in range(4)}
            got.update({("pq", j): _pks(db.vector_search("pq", "emb", ivf_q[j], top_k=K,
                                                         mode="exact")) for j in range(4)})
            open_s = time.perf_counter() - t0
            found = tuple(db.engine._table(t).vector_index_for("emb").index_type
                          for t in ("docs", "pq"))
            again = [_pks(db.vector_search("pq", "emb", ivf_q[j], top_k=K)) for j in range(4)]
            overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(again, probe)])
            trained = db.engine._table("pq").vector_index_for("emb").trained
            db.close()
            del db
            # a sharded snapshot holds the stored rows and no norms, so a restore
            # takes the l2 norms from the bf16 rows: against the LIVE index the
            # distances move by that rounding and two neighbours a rounding apart
            # may swap (held to: the same nearest row, 0.9 of the rest). Two
            # indexes restored from the same snapshot have the same norms: every
            # mesh shape must return the same pks as the first reopen did
            top1 = all(got[k][0] == want[k][0] for k in want)
            same = {t: float(np.mean([len(set(got[k]) & set(want[k])) / K
                                      for k in want if k[0] == t])) for t in ("docs", "pq")}
            if found != kinds or not top1 or min(same.values()) < 0.9 or not trained \
                    or overlap < RECALL_MIN["pq192"]:
                raise AssertionError(f"phase10c reopen under {shape}: {found}, same nearest row "
                                     f"{top1}, overlap {same}, trained {trained}, default "
                                     f"route overlap {overlap}")
            if restored is None:
                restored, equal = got, "the reference of the reopens"
            else:
                differ = [k for k in got if sorted(got[k]) != sorted(restored[k])]
                if differ:
                    raise AssertionError(
                        f"phase10c reopen under {shape}: other pks than the reopen under () "
                        f"for {differ}: {[(got[k], restored[k]) for k in differ]}")
                ordered = sum(got[k] == restored[k] for k in got)
                equal = (f"the same pks as the reopen under () in all {len(got)} searches "
                         f"({ordered} in the same order)")
            report.append(f"mesh_shape={shape}: {found[0]} / {found[1]}, open + 8 searches "
                          f"{open_s:.2f} s, {equal}; against the live index the same nearest "
                          f"rows, top-{K} overlap flat {same['docs']} / IVF-PQ mode='exact' "
                          f"{same['pq']}, default route {overlap}")
        print(f"phase10c durability under mesh_shape=(4,) ({SHARD_DUR_ROWS} rows a table, a "
              f"flat and an IVF-PQ one; phase 9c's depth): checkpoint {ckpt_s:.2f} s, "
              f"{ckpt_bytes} bytes; reopened under " + "; ".join(report) + f" {tag}", flush=True)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return launches


def phase_sharded_nccl(idx, queries, T, IP, tag):
    """Phase 10d: the process-group path. NCCL at world size 1 on the card,
    a mesh built after init_distributed (its collectives now run), and
    10a's (1, 4) stripes searched through it: equal results."""
    import socket

    from tostore_tpu_torch.parallel import make_mesh
    from tostore_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

    b = SHARD_FLAT_B[1]
    before = idx.search_arrays(queries[b], K)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    addr = f"localhost:{sock.getsockname()[1]}"
    sock.close()
    t0 = time.perf_counter()
    init_distributed(addr, num_processes=1, process_id=0,
                     local_cpu_devices=4 if SHARD_CELL == "cpu" else None, timeout_s=60)
    try:
        import torch.distributed as dist

        mesh = make_mesh(4, dp=1, devices=[SHARD_CELL] * 4)
        if not mesh.distributed or dist.get_world_size() != 1:
            raise AssertionError("the mesh did not join the process group")
        old = idx.mesh
        for part in (idx, idx.vectors, idx.valid, idx.sq_norms):
            part.mesh = mesh  # the same stripes, addressed through the group's mesh
        try:
            _zero_counters(T, IP)
            after = idx.search_arrays(queries[b], K)
            probe = idx.vectors.gather(np.array([0, idx.capacity - 1]))  # the all-reduce path
            _sync()
            launches = _want_launches(T.LAUNCHES, {"lane_topk_acc": 4}, "phase10d")
            ms = _host_ms(lambda: idx.search_arrays(queries[b], K))
        finally:
            for part in (idx, idx.vectors, idx.valid, idx.sq_norms):
                part.mesh = old
        backend = dist.get_backend()
    finally:
        shutdown_distributed()
    if not (np.array_equal(before[0], after[0]) and (before[1] == after[1]).all()):
        raise AssertionError("phase10d: the process-group path returned other results")
    print(f"phase10d process group: {backend}, world size 1, init + first search "
          f"{time.perf_counter() - t0:.2f} s; search_arrays B={b} through the group's mesh "
          f"equals 10a's (distances bit for bit), {launches}, gathered rows "
          f"{tuple(probe.shape)}; host clock {ms:.4f} ms; group destroyed {tag}", flush=True)
    return ms


def phase_sharded_dryrun(T, IP, tag):
    """Phase 10e: `dryrun_multichip(4)` of __graft_entry_torch__.py with no
    device named: 4 cells on the first card, its fused flat step through
    K1 (f32 rows) and its IVF-PQ step through K4, once per cell."""
    import __graft_entry_torch__ as g

    _zero_counters(T, IP)
    t0 = time.perf_counter()
    g.dryrun_multichip(4)
    _sync()
    got = _want_launches({**T.LAUNCHES, **IP.LAUNCHES},
                         {"lane_topk_acc_f32": 4, "ivf_adc": 4}, "phase10e")
    print(f"phase10e dryrun_multichip(4) on its default device: passed in "
          f"{time.perf_counter() - t0:.2f} s, launches {got} {tag}", flush=True)



# --------------------------------------------------------------------------
# Phase 11: the measuring scripts (bench_torch.py, bench_all_torch.py,
# _verify_drive_torch.py), each in a process of its own
# --------------------------------------------------------------------------

SCRIPT_TIMEOUT_S = 600
HEADLINE_METRIC = "flat_knn_qps_b256_1003520x768_bf16_top10"
# bench_all_torch.py configs run here, the kernels each must launch, and
# the quality keys with their floors (BENCH_REPORT.json's meanings)
BENCH_CONFIGS = {
    "1": ({"lane_topk_acc_f32"},
          {"recall_at_10_pallas_vs_exact": AGREEMENT_MIN,
           "recall_at_10_lane_vs_exact": AGREEMENT_MIN}),
    "2": ({"lane_topk_acc", "lane_topk_emit"},
          {"fast_b128_recall_at_10": AGREEMENT_MIN, "fast_b256_recall_at_10": AGREEMENT_MIN}),
    "4": ({"lane_topk_acc"}, {"parity_recall_vs_postfilter": AGREEMENT_MIN}),
    "5": ({"lane_topk_acc_f32", "ivf_adc"}, {}),  # in the dry run's own process
    "7": ({"lane_topk_emit"}, {"top10_agreement_vs_bf16": 0.95}),
}
BENCH_TRUE = {"4": "all_hits_satisfy_predicate", "5": "dryrun_ok"}


def _run_script(*args):
    """stdout of one script run from this checkout; a failure raises with
    its output."""
    from pathlib import Path

    r = subprocess.run([sys.executable, *args], cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=SCRIPT_TIMEOUT_S)
    if r.returncode != 0:
        raise AssertionError(f"phase11 {' '.join(args)}: exit {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return r.stdout


def _script_line(stdout, prefix="{"):
    """The last line of a script's output that starts with `prefix`, parsed
    (a `launches {...}` line, or the result's JSON line)."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith(prefix)]
    if not lines:
        raise AssertionError(f"phase11: no line starting {prefix!r} in\n{stdout[-2000:]}")
    return json.loads(lines[-1][lines[-1].index("{"):])


def phase_bench_scripts(tag):
    """Phase 11: bench_torch.py (its line parsed, value > 0, K2 launched),
    _verify_drive_torch.py ("VERIFY DRIVE OK") and bench_all_torch.py 1,
    2, 4, 5, 7 (no error, the quality floors, the kernels each config's
    path must launch). Returns the kernels' launches summed over the
    children."""
    torch.cuda.empty_cache()
    total = {}

    def add(counts, name, want):
        missing = [k for k in want if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"phase11 {name}: kernels {missing} not launched: {counts}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    out = _run_script("bench_torch.py")
    line, counts = _script_line(out), _script_line(out, "launches ")
    if line["metric"] != HEADLINE_METRIC or not line["value"] > 0:
        raise AssertionError(f"phase11 bench_torch.py: {line}")
    add(counts, "bench_torch.py", {"lane_topk_emit"})
    print(f"phase11 bench_torch.py ({time.perf_counter() - t0:.1f} s): {json.dumps(line)}; "
          f"launches {counts}", flush=True)

    t0 = time.perf_counter()
    out = _run_script("_verify_drive_torch.py")
    if not out.strip().endswith("VERIFY DRIVE OK"):
        raise AssertionError(f"phase11 _verify_drive_torch.py:\n{out[-2000:]}")
    print(f"phase11 _verify_drive_torch.py ({time.perf_counter() - t0:.1f} s): "
          + " | ".join(out.strip().splitlines()), flush=True)

    for name, (want, floors) in BENCH_CONFIGS.items():
        t0 = time.perf_counter()
        out = _run_script("bench_all_torch.py", name)
        res = _script_line(out)
        # config 5's kernels run in the dry run's own process, which reports them
        counts = res.get("dryrun_launches") or _script_line(out, "launches ")
        low = {k: res[k] for k, floor in floors.items() if not res[k] >= floor}
        if "error" in res or low or (name in BENCH_TRUE and res[BENCH_TRUE[name]] is not True):
            raise AssertionError(f"phase11 config {name} failed or is under its floors "
                                 f"{floors}: {res}")
        add(counts, f"config {name}", want)
        print(f"phase11 bench_all_torch.py {name} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(res)}; launches {counts} {tag}", flush=True)
    return total


# --------------------------------------------------------------------------
# Phase 12: the JAX package's engine suites with their corpora on the card
# (12a), and the engine's entry points no earlier phase drives, at full
# width (12b)
# --------------------------------------------------------------------------

# The suites that build vector tables (tests/torch_suites.py VECTOR_SUITES):
# the other 15 run on the card exactly what they run on the CPU in tier-1.
SUITES_ON_CARD = (
    "test_engine", "test_review_regressions", "test_aux", "test_txn_buffered",
    "test_surface_r4", "test_durability_incremental", "test_differential",
    "test_concurrency", "test_storage_seam",
)
SUITE_TIMEOUT_S = 600
# "cuda:0", not "cuda": some cases build meshes of 8 cells (mesh_shape=(2, 4)),
# which the reference's suites place on 8 virtual devices of one host. The
# device rule (models/config.py) puts cell i on cuda:i for "cuda", and every
# cell on the one card for "cuda:0"; a single-device table is on cuda:0 either way.
SUITE_DEVICE = "cuda:0"
SUITE_KERNELS = ("lane_topk_acc", "lane_topk_emit", "ivf_bucket_probe", "ivf_adc",
                 "lane_topk_acc_f32", "lane_topk_emit_f32")


def phase_suites(tag):
    """Phase 12a: the nine vector suites' shims under pytest in a child
    process, with the suite device set to the card (SUITE_DEVICE;
    tests/torch_suites.py);
    passed, failed, skipped and seconds per suite from its junit XML, and
    the kernel launches each suite made from the loader's launch file. A
    failed or erroring case fails the phase. Returns the launches summed."""
    import os
    import re
    import shutil
    import tempfile
    import xml.etree.ElementTree as ET
    from pathlib import Path

    root = Path(__file__).resolve().parent
    work = tempfile.mkdtemp(prefix="tostore_suites_")
    try:
        xml, counts = os.path.join(work, "suites.xml"), os.path.join(work, "launches.jsonl")
        env = dict(os.environ, TOSTORE_TORCH_SUITE_DEVICE=SUITE_DEVICE,
                   TOSTORE_TORCH_SUITE_LAUNCHES=counts)
        shims = [f"tests/test_torch_suite_{s[len('test_'):]}.py" for s in SUITES_ON_CARD]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p",
                            "no:cacheprovider", "-q", f"--junitxml={xml}", *shims],
                           cwd=root, env=env, capture_output=True, text=True,
                           timeout=SUITE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        per = {s: {"passed": 0, "failed": 0, "skipped": 0} for s in SUITES_ON_CARD}
        for case in ET.parse(xml).iter("testcase"):
            suite = "test_" + re.search(r"test_torch_suite_(\w+?)(\.|$)",
                                        case.get("classname")).group(1)
            kids = {c.tag for c in case}
            key = ("failed" if kids & {"failure", "error"}
                   else "skipped" if "skipped" in kids else "passed")
            per[suite][key] += 1
        rows = {}
        if os.path.exists(counts):
            for line in open(counts):
                row = json.loads(line)
                rows[row["suite"]] = row
        total = dict.fromkeys(SUITE_KERNELS, 0)
        for suite, n in per.items():
            row = rows.get(suite, {"seconds": float("nan"), "launches": {}})
            launched = {k: row["launches"].get(k, 0) for k in SUITE_KERNELS}
            for k, v in launched.items():
                total[k] += v
            print(f"phase12a {suite}: {n['passed']} passed, {n['failed']} failed, "
                  f"{n['skipped']} skipped, {row['seconds']:.2f} s on {SUITE_DEVICE}; launches "
                  f"{ {k: v for k, v in launched.items() if v} } {tag}", flush=True)
        n_pass = sum(n["passed"] for n in per.values())
        n_bad = sum(n["failed"] for n in per.values())
        print(f"phase12a the nine vector suites on the card: {n_pass} passed, {n_bad} failed "
              f"in {wall:.1f} s (child process, pytest rc {r.returncode}); launches {total} "
              f"{tag}", flush=True)
        if r.returncode != 0 or n_bad or n_pass == 0:
            raise AssertionError(f"phase12a: pytest rc {r.returncode}\n{r.stdout[-6000:]}\n"
                                 f"{r.stderr[-3000:]}")
        return total
    finally:
        shutil.rmtree(work, ignore_errors=True)


ENTRY_ROWS = ENGINE_DUR_ROWS  # 250,000: a 1M x 768 snapshot overflows the u32 frame
ENTRY_TXN_ROWS = 1_000        # rows inserted, and rows updated, by each transaction
ENTRY_BATCH = 1_000           # rows per batch_insert of the writer that is killed
ENTRY_ACKS = 5                # acknowledged batches before the SIGKILL
ENTRY_NOISE = 0.01            # std of the noise on a row's own vector as a query
ENTRY_QUERIES = 256           # queries of the agreement checks
ENTRY_KILL_TIMEOUT_S = 300


def _bf16_round(x):
    """float32 values rounded to bfloat16 (nearest even), as float32: the
    values a bf16 corpus holds."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)).view(np.float32)


def _writer_rows(i):
    return np.random.default_rng(SEED + 1200 + i).standard_normal((ENTRY_BATCH, DIMS),
                                                                  dtype=np.float32)


def kill9_writer(path, first_pk, device):
    """The child of phase 12b (iii): opens the database, then batch_inserts
    ENTRY_BATCH-row vector batches until it is killed, printing each
    acknowledged batch's pks."""
    import tostore_tpu_torch as P

    db = P.ToStoreTPU.open(path, device=device)
    print("READY", db.count("docs"), flush=True)
    pk, i = first_pk, 0
    while True:
        recs = [{"id": pk + j, "price": 0.5, "ts": T0_MS + pk + j, "emb2": v}
                for j, v in enumerate(_writer_rows(i))]
        res = db.batch_insert("docs", recs)
        if not res.is_success:
            print("FAILED", res, flush=True)
            return 1
        print("ACK", json.dumps([int(k) for k in res.success_keys]), flush=True)
        pk, i = pk + ENTRY_BATCH, i + 1


def _own_misses(db, field, pks, vecs, seed, forbidden=frozenset()):
    """pks that are not in the top-10 of their own vector plus N(0,
    ENTRY_NOISE) noise; raises if a search returns a forbidden pk."""
    noise = np.random.default_rng(seed).normal(0, ENTRY_NOISE, vecs.shape).astype(np.float32)
    misses = []
    for pk, q in zip(pks, vecs + noise):
        got = _pks(db.vector_search("docs", field, q, top_k=K))
        if forbidden & set(got):
            raise AssertionError(f"phase12b: a rolled-back pk came back: {forbidden & set(got)}")
        if pk not in got:
            misses.append(pk)
    return misses


def _exact_agreement(db, field, queries):
    agree = 0
    for q in queries:
        agree += len(set(_pks(db.vector_search("docs", field, q, top_k=K)))
                     & set(_pks(db.vector_search("docs", field, q, top_k=K, mode="exact"))))
    return agree / (K * len(queries))


class _Rollback(Exception):
    pass


def phase_entry_points(T, IP, tag):
    """Phase 12b on one file database (WAL on, the default config on the
    card) with a flat bf16 l2 table of ENTRY_ROWS x 768: (i) transactions
    that write vectors, rolled back and then committed; (ii) a migration
    that renames the vector field, so the index is rebuilt from the column
    store; (iii) a writer process killed with SIGKILL mid-batch, every
    acknowledged row read back after the reopen. Returns K1's launches."""
    import os
    import shutil
    import signal
    import tempfile
    import threading
    from pathlib import Path

    import tostore_tpu_torch as P

    rng = np.random.default_rng(SEED + 120)
    n_all = ENTRY_ROWS + ENTRY_TXN_ROWS + 1
    price = rng.random(n_all)
    ts_null = (np.arange(n_all) % TS_NULL_EVERY) == 0
    base = np.concatenate(list(_normal_chunks(SEED + 121, ENTRY_ROWS)))
    queries = rng.standard_normal((ENTRY_QUERIES, DIMS), dtype=np.float32)
    path = tempfile.mkdtemp(prefix="tostore_entry_")
    t_phase = time.perf_counter()
    _zero_counters(T, IP)
    try:
        db = P.ToStoreTPU.open(path, schemas=[_engine_schema(P, "docs")], **ENGINE_OPEN_KW)
        n, spent = _engine_ingest(db, "docs", [base], price, ts_null)
        db.vector_search("docs", "emb", queries[0], top_k=K)  # the staged rows to the card

        # (i) transactions that write vectors
        new_pks = list(range(ENTRY_ROWS + 1, ENTRY_ROWS + ENTRY_TXN_ROWS + 1))
        new_vecs = rng.standard_normal((ENTRY_TXN_ROWS, DIMS), dtype=np.float32)
        upd_pks = sorted(int(p) + 1 for p in rng.choice(ENTRY_ROWS, ENTRY_TXN_ROWS,
                                                         replace=False))
        upd_vecs = rng.standard_normal((ENTRY_TXN_ROWS, DIMS), dtype=np.float32)

        def writes():
            res = db.batch_insert("docs", [
                {"id": pk, "price": 0.5, "ts": T0_MS + pk, "emb": v}
                for pk, v in zip(new_pks, new_vecs)])
            if not res.is_success:
                raise AssertionError(f"phase12b batch_insert in a transaction: {res}")
            for pk, v in zip(upd_pks, upd_vecs):
                if not db.update_by_pk("docs", pk, {"emb": v}).is_success:
                    raise AssertionError(f"phase12b update_by_pk({pk}) in a transaction")

        t0 = time.perf_counter()
        try:
            with db.transaction():
                writes()
                raise _Rollback
        except _Rollback:
            pass
        rollback_s = time.perf_counter() - t0
        gone = set(new_pks)
        if db.count("docs") != ENTRY_ROWS or any(db.get_by_pk("docs", pk) for pk in new_pks[:50]):
            raise AssertionError(f"phase12b after the rollback: {db.count('docs')} rows")
        miss_new = _own_misses(db, "emb", new_pks, new_vecs, SEED + 122, forbidden=gone)
        miss_old = _own_misses(db, "emb", upd_pks, base[np.asarray(upd_pks) - 1], SEED + 123,
                               forbidden=gone)
        if miss_old:
            raise AssertionError(f"phase12b after the rollback: {len(miss_old)} updated rows "
                                 f"not found by their old vectors: {miss_old[:5]}")
        t0 = time.perf_counter()
        with db.transaction():
            writes()
        commit_s = time.perf_counter() - t0
        miss = (_own_misses(db, "emb", new_pks, new_vecs, SEED + 124)
                + _own_misses(db, "emb", upd_pks, upd_vecs, SEED + 125))
        agree = _exact_agreement(db, "emb", queries)
        print(f"phase12b (i) transactions on {ENTRY_ROWS} x {DIMS} bf16 (file database, WAL "
              f"on): {ENTRY_TXN_ROWS} inserts + {ENTRY_TXN_ROWS} vector updates rolled back in "
              f"{rollback_s:.2f} s (no rolled-back pk returned in {2 * ENTRY_TXN_ROWS} "
              f"searches, every updated row found by its old vector), committed in "
              f"{commit_s:.2f} s; {len(miss)} of {2 * ENTRY_TXN_ROWS} written rows outside "
              f"the top-{K} of their own vector + N(0, {ENTRY_NOISE}); top-{K} agreement with "
              f"mode='exact' {agree} over {ENTRY_QUERIES} queries {tag}", flush=True)
        if miss or agree < AGREEMENT_MIN or db.count("docs") != ENTRY_ROWS + ENTRY_TXN_ROWS:
            raise AssertionError(f"phase12b after the commit: misses {miss[:5]}, agreement "
                                 f"{agree}, {db.count('docs')} rows")

        # (ii) a migration that rebuilds the vector index from the column store
        before = db.count("docs")
        t0 = time.perf_counter()
        res = db.update_schema("docs").rename_field("emb", "emb2").execute()
        migrate_s = time.perf_counter() - t0
        if res.is_error:
            raise AssertionError(f"phase12b migration: {res}")
        t0 = time.perf_counter()
        db.vector_search("docs", "emb2", queries[0], top_k=K)
        first_s = time.perf_counter() - t0
        table = db.engine._table("docs")
        vi = table.vector_index_for("emb2")
        store = table.store
        pks = np.asarray(store.pks(), np.int64)
        rows = np.asarray([store.rowid(int(pk)) for pk in pks])
        # the index's own function of the stored values: bf16 rows and
        # queries in the product, the squared norms of the f32 rows
        col = np.stack(store.columns["emb2"].data[rows]).astype(np.float32)
        sq = np.einsum("ij,ij->i", col, col)
        score = sq[None, :] - 2 * (_bf16_round(queries) @ _bf16_round(col).T)
        want = pks[np.argsort(score, axis=1, kind="stable")[:, :K]]
        agree = sum(len(set(_pks(db.vector_search("docs", "emb2", q, top_k=K))) & set(w.tolist()))
                    for q, w in zip(queries, want)) / (K * ENTRY_QUERIES)
        print(f"phase12b (ii) migration rename_field('emb', 'emb2'): {migrate_s:.2f} s; the "
              f"first search, which re-ingests {len(vi.corpus)} vectors from the column store "
              f"onto {vi.corpus.vectors.device}: {first_s:.2f} s; count {db.count('docs')} "
              f"(before {before}); top-{K} agreement with a numpy exact oracle over the column "
              f"store's vectors (bf16 products, f32 norms) {agree} over {ENTRY_QUERIES} queries {tag}",
              flush=True)
        if (db.count("docs") != before or len(vi.corpus) != before or agree < AGREEMENT_MIN
                or "emb" in table.vector_indexes):
            raise AssertionError(f"phase12b after the migration: {db.count('docs')} rows, "
                                 f"corpus {len(vi.corpus)}, agreement {agree}")
        db.close()
        del db, table, vi, store, col

        # (iii) SIGKILL of a writer process; every acknowledged row survives
        first_pk = ENTRY_ROWS + ENTRY_TXN_ROWS + 1
        cmd = [sys.executable, str(Path(__file__).resolve()), "--kill9-writer", path,
               str(first_pk), ENGINE_OPEN_KW.get("device", "cuda")]
        with tempfile.TemporaryFile("w+") as err, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=err, text=True,
                cwd=Path(__file__).resolve().parent) as proc:
            watchdog = threading.Timer(ENTRY_KILL_TIMEOUT_S, proc.kill)
            watchdog.start()
            try:
                lines = [proc.stdout.readline()]
                while len(lines) <= ENTRY_ACKS and lines[-1].startswith(("READY", "ACK")):
                    lines.append(proc.stdout.readline())
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait()
                lines += proc.stdout.read().splitlines(keepends=True)
            finally:
                watchdog.cancel()
                proc.kill()  # a no-op once it is dead; stops it if a read raised
            err.seek(0)
            if (not lines[0].startswith("READY") or int(lines[0].split()[1]) != before
                    or not all(ln.startswith("ACK") for ln in lines[1 : ENTRY_ACKS + 1])):
                raise AssertionError(f"phase12b writer: {lines[: ENTRY_ACKS + 1]}\n"
                                     f"{err.read()[-3000:]}")
        acked = [pk for ln in lines if ln.startswith("ACK") and ln.endswith("\n")
                 for pk in json.loads(ln[4:])]
        acked_vecs = np.concatenate([_writer_rows(i) for i in range(len(acked) // ENTRY_BATCH)])
        if acked != list(range(first_pk, first_pk + len(acked))):
            raise AssertionError("phase12b writer: acknowledged pks out of order")
        t0 = time.perf_counter()
        db = P.ToStoreTPU.open(path, **ENGINE_OPEN_KW)
        reopen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        db.vector_search("docs", "emb2", acked_vecs[0], top_k=K)
        first_ms = (time.perf_counter() - t0) * 1e3
        lost = [pk for pk, v in zip(acked, acked_vecs)
                if (r := db.get_by_pk("docs", pk)) is None
                or not np.array_equal(np.asarray(r["emb2"], np.float32), v)]
        ids = [r["id"] for r in db.query("docs").select("id").limit(10**9).no_cache()
               .fetch().records]
        chk = db.check_integrity()
        miss = _own_misses(db, "emb2", acked, acked_vecs, SEED + 126)
        n_rows = db.count("docs")
        print(f"phase12b (iii) SIGKILL after {len(acked) // ENTRY_BATCH} acknowledged batches "
              f"of {ENTRY_BATCH} (writer on {ENGINE_OPEN_KW.get('device', 'cuda')}): reopen "
              f"{reopen_s:.2f} s, first search {first_ms:.1f} ms; {n_rows} rows ({before} + "
              f"{n_rows - before} written, {len(acked)} acknowledged), {len(lost)} acknowledged "
              f"rows lost or changed, {len(ids) - len(set(ids))} duplicate pks, integrity "
              f"errors {chk.get('errors')}, {len(miss)} acknowledged rows outside the top-{K} "
              f"of their own vector + noise {tag}", flush=True)
        if (lost or len(ids) != len(set(ids)) or len(ids) != n_rows or chk.get("errors")
                or miss or n_rows < before + len(acked)):
            raise AssertionError(f"phase12b after the kill: lost {lost[:5]}, misses {miss[:5]}, "
                                 f"{chk}")
        db.close()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    k1, sel = T.LAUNCHES["lane_topk_acc"], T.LAUNCHES["select_topk"]
    print(f"phase12b launches: K1 {k1} (every search above: the table is past MIN_FUSED_N "
          f"= {T.MIN_FUSED_N}), select_topk {sel}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s {tag}", flush=True)
    if k1 <= 0 or sel <= 0:
        raise AssertionError(f"phase12b: K1 launched {k1} times, select_topk {sel}")
    return {"lane_topk_acc": k1, "select_topk": sel}


# --------------------------------------------------------------------------
# Phase 13: ties at full width. Exactly equal scores (copied rows) on every
# route, each kernel's result equal to its plain version's in hits and
# order. Runs after phase 8, on phase 6's IVF indexes; 13e after phase 10d.
# --------------------------------------------------------------------------

TIE_SRC = 5 * 128 + 37       # the copied row's slot: block 0, lane 37
TIE_SIDE_ROWS = SIDE_ROWS    # the int8 and f32 indexes of the phase
TIE_B = (1, 8, 32, 256)
TIE_COPIES = 24              # copies appended to each IVF index
TIE_NOISE = 0.01             # query = the copied row + N(0, TIE_NOISE^2) a dimension


def _tie_slots(capacity):
    """The slots that take copies of TIE_SRC's row: other lanes of its
    block; its own lane in other 2,048-row blocks, two copies a block, so
    that more than T = 16 equal candidates reach its K1 lists, on both
    sides of K1's split boundaries (4 blocks a split at 1,048,576 slots on
    132 SMs) and in both halves of K2's 4,096-row blocks; three lanes of
    two far blocks. Those below `capacity`."""
    lane = TIE_SRC % 128
    slots = [TIE_SRC + j for j in (1, 2, 3, 90)]
    slots += [blk * 2048 + r * 128 + lane for blk in (1, 3, 4, 7, 8, 9, 64, 100, 255, 256, 511)
              for r in (0, 7)]
    slots += [blk * 2048 + other for blk in (4, 300) for other in (0, 64, 127)]
    return [s for s in slots if s < capacity]


def _stored_row(idx, slot):
    """The row as the corpus holds it, in f32 (bf16 and int8 * scale are
    exact there): upserting it again stores the same bits and norm."""
    c = idx.corpus
    x = c.vectors[slot].float()
    if c.scales is not None:
        x = x * c.scales[slot]
    return x[:DIMS].cpu().numpy()


def _copy_row(idx, src_slot, slots):
    """Upsert the stored row of src_slot under its own pk and the pks of
    the live `slots` (each keeps its slot). -> (slots with the row, row)."""
    c = idx.corpus
    live = c.valid[torch.tensor(slots, device=c.device)].cpu().numpy()
    slots = [src_slot] + [s for s, ok in zip(slots, live) if ok]
    row = _stored_row(idx, src_slot)
    idx.upsert([c._slot_pks[s] for s in slots], np.repeat(row[None], len(slots), 0))
    return slots, row


def _tie_queries(row, b, seed):
    rng = np.random.default_rng(seed)
    return (row[None] + rng.standard_normal((b, DIMS), dtype=np.float32)
            * np.float32(TIE_NOISE)).astype(np.float32)


def _tie_equal(label, got, want, tol):
    """Kernel route (got) against its plain version (want), both (scores,
    rows) [B, k]: the same hits in the same order, no tolerance on order;
    scores within tol of max(1, |score|). -> max |score diff|."""
    ks, ki = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t) for t in got)
    ps, pi = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t) for t in want)
    ks, ps = ks.astype(np.float64), ps.astype(np.float64)
    err = np.abs(ks - ps)
    if (err > tol * np.maximum(1.0, np.abs(ps))).any():
        raise AssertionError(f"{label}: scores differ beyond {tol}: {err.max()}")
    hit = ps > NEG_INF / 2
    if not np.array_equal(ks > NEG_INF / 2, hit):
        raise AssertionError(f"{label}: the misses differ")
    bad = [b for b in range(ps.shape[0]) if ki[b][hit[b]].tolist() != pi[b][hit[b]].tolist()]
    if bad:
        b = bad[0]
        raise AssertionError(f"{label}: {len(bad)} rows differ in hits or order; row {b}: "
                             f"{ki[b].tolist()} against plain {pi[b].tolist()}")
    return float(err.max()) if err.size else 0.0


def _bits_equal(scores, rows, tied):
    """Whether every candidate of `tied` rows carries one bit pattern per
    leading row: scores / rows [B, ...] (a kernel's raw candidates, by
    query, or by probed bucket)."""
    s = scores.reshape(scores.shape[0], -1).float()
    r = rows.reshape(rows.shape[0], -1).long()
    mask = torch.isin(r, torch.tensor(sorted(tied), device=r.device)) & (s > NEG_INF / 2)
    if not bool(mask.any()):
        return None
    hi = torch.where(mask, s, torch.full_like(s, -float("inf"))).max(1).values
    lo = torch.where(mask, s, torch.full_like(s, float("inf"))).min(1).values
    some = mask.any(1)
    return bool(torch.equal(hi[some].view(torch.int32), lo[some].view(torch.int32)))


def _tie_flat_index(dev):
    """The phase's 1,048,576-slot bf16 l2 index (phase 2's capacity): rows
    from a seeded torch generator, 1,000,000 of them, then TIE_SRC's row
    copied to `_tie_slots`."""
    from tostore_tpu_torch import FlatVectorIndex

    g = torch.Generator().manual_seed(SEED + 13)
    idx = FlatVectorIndex(DIMS, "l2", "bfloat16", device=dev)
    chunk = min(125_000, N_ROWS)
    for off in range(0, N_ROWS, chunk):
        idx.upsert(range(off, off + chunk), torch.randn((chunk, DIMS), generator=g).numpy())
    return idx


def _tie_side_indexes(dev):
    """An int8 and an f32 l2 index of TIE_SIDE_ROWS seeded rows."""
    from tostore_tpu_torch import FlatVectorIndex

    g = torch.Generator().manual_seed(SEED + 14)
    x = torch.randn((TIE_SIDE_ROWS, DIMS), generator=g).numpy()
    side = {}
    for p in ("int8", "float32"):
        side[p] = FlatVectorIndex(DIMS, "l2", p, device=dev)
        side[p].upsert(range(TIE_SIDE_ROWS), x)
    return side


def _plain_route(idx, q, b, T):
    """The plain version of the fused route the kernel takes at B, on the
    index's own tensors (K1 to 32 queries, K2 above at 4,096-row blocks)."""
    qt, _, _ = idx._prep_queries(q)
    return _pairs(idx, qt, b, T)[1][1]()


@contextlib.contextmanager
def _plain_selection(T):
    """Within: every route's selection (`top_k_first`, by name in each
    module that calls it) is the plain version, `_top_k_first_plain`, in
    place of select_topk, so that a route's plain version is plain down to
    its top-k."""
    from tostore_tpu_torch.parallel import sharded
    from tostore_tpu_torch.vector import ivf, pq

    mods = (T, ivf, pq, sharded)
    kept = [m.top_k_first for m in mods]
    for m in mods:
        m.top_k_first = T._top_k_first_plain
    try:
        yield
    finally:
        for m, fn in zip(mods, kept):
            m.top_k_first = fn


SELECT_FEW = (2.0, 1.0, 0.5, 0.0, -0.0, -1.0, float("inf"), -float("inf"), float("nan"),
              -float("nan"))


def _select_input(dev, shape, kind, seed, k):
    """Scores for a selection's edge cases, made on the card: "random"
    normal; "few" ten values (+-0.0, +-inf, +-NaN among them), so most of a
    row ties; "copies" normal with each row's k-th best copied to 3k random
    places; "misses" NEG_INF but k // 2 + 1 live scores a row; "equal" one
    score everywhere."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "few":
        vals = torch.tensor(SELECT_FEW, device=dev)
        return vals[torch.randint(0, len(SELECT_FEW), shape, generator=g, device=dev)]
    if kind == "equal":
        return torch.full(shape, 0.75, device=dev)
    x = torch.randn(shape, generator=g, device=dev)
    flat = x.view(-1, shape[-1])
    rows = torch.arange(flat.shape[0], device=dev)[:, None]
    if kind == "copies":  # torch.topk builds the input; the port never calls it
        kth = torch.topk(flat, k, dim=1).values[:, -1:]
        flat[rows, torch.randint(0, shape[-1], (flat.shape[0], 3 * k), generator=g,
                                 device=dev)] = kth
    elif kind == "misses":
        live = torch.randint(0, shape[-1], (flat.shape[0], k // 2 + 1), generator=g, device=dev)
        keep = flat[rows, live]
        flat.fill_(NEG_INF)
        flat[rows, live] = keep
    return x


# One input a route of the selection (shape at full width, k, kind), beside
# the real candidates of phase_select: the IVF probe selection (1,232
# slices, nprobe 16; a fat cluster's slices tie), the raw final top-k and
# the re-rank pool at k = 10 and 100 over 16 x 1,984 candidates, k-means
# assignment (65,536 rows, C = 1,024, 3 choices), the sharded merge (4
# shards x k), the PQ scan (500,000 codes), rows whose scores all tie,
# +-0.0 / +-inf / NaN, misses, k = N (a lane list shorter than T) and a k
# above SELECT_CAP.
SELECT_SYNTH = [((64, 1232), 16, "few"), ((64, 31744), 10, "copies"),
                ((64, 31744), 512, "copies"), ((8, 31744), 5100, "random"),
                ((65536, 1024), 3, "random"), ((256, 40), 10, "copies"),
                ((8, 500000), 10, "misses"), ((256, 65536), 10, "equal"),
                ((256, 65536), 10, "few"), ((256, 65536), 10, "misses"),
                ((4096, 16), 16, "few"), ((2, 20000), 9000, "copies")]


def phase_select(dev, flat, queries, T, errs, tag):
    """Phase 13d: select_topk against its plain version `_select_exact`, bit
    for bit (values and positions), on the routes' real inputs from the
    copied rows (K2's [256, 65,536] candidates, K1's per-lane lists and
    their [B, 2,048] final at B = 32, an exact-scan chunk, K5's [256,
    4,096]) and on SELECT_SYNTH; then the selection's time over K2's
    candidates (CUDA events, median, in turns) on the copies and on random
    scores, beside torch.topk (the library call), `_select_exact` and the
    bytes bound. Returns the times."""
    c = flat.corpus.vectors
    bias, alpha, _ = flat._bias_alpha(None)
    qt = flat._prep_queries(queries[256])[0]
    cs, ci = T._lane_topk_emit_cuda(T._pad_queries(qt, 256, c.dtype), c, bias, None, alpha, 4096)
    q32 = flat._prep_queries(queries[32])[0]
    _, blk_b, t_cands, _ = T._acc_plan(q32, c, K, None)
    out_s, out_i = T._lane_topk_acc_cuda(T._pad_queries(q32, blk_b, c.dtype), c, bias, None,
                                         alpha, 2048, t_cands)
    lanes = torch.where(out_s > NEG_INF, out_s, NEG_INF).transpose(1, 2) + 0.0
    final = T._lane_top_t(out_s.transpose(1, 2), out_i.transpose(1, 2), t_cands)[0]
    q8 = flat._prep_queries(queries[8])[0]
    chunk = T._scores(q8.to(T.score_dtype(c.dtype)), c[:T.EXACT_CHUNK], bias[:T.EXACT_CHUNK],
                      None, alpha)
    g_blk, gsz = T._group_plan(qt, c, BLK_N, None)
    group = T._lane_topk_group_cuda(T._pad_queries(qt, g_blk, c.dtype), c, bias, None, alpha,
                                    BLK_N, gsz)[0]
    cases = [("K2 candidates (copies)", cs, K), ("K1 lane lists B=32", lanes, t_cands),
             ("K1 final B=32", final, K), ("exact chunk B=8", chunk, K),
             ("K5 candidates B=256", group, K)]
    cases += [(f"{kind} {list(shape)}", _select_input(dev, shape, kind, SEED + 70 + i, k), k)
              for i, (shape, k, kind) in enumerate(SELECT_SYNTH)]
    err = 0.0
    for label, x, k in cases:
        v, p = T.top_k_first(x, k)
        ev, ep = T._select_exact(x, min(k, x.shape[-1]))
        torch.cuda.synchronize()
        if not torch.equal(p, ep) or not torch.equal(v.view(torch.int32), ev.view(torch.int32)):
            bad = (p != ep).any(-1).nonzero().flatten()[:3].tolist()
            raise AssertionError(f"phase13d select_topk differs from _select_exact on {label} "
                                 f"k={k}: rows {bad}")
        live = torch.isfinite(ev)
        err = max(err, float((v[live] - ev[live]).abs().max()) if bool(live.any()) else 0.0)
    errs["select_topk"] = err
    print(f"phase13d select_topk bit for bit equal to _select_exact on {len(cases)} inputs: "
          + "; ".join(f"{label} k={k}" for label, _, k in cases) + f" {tag}", flush=True)

    cr = torch.randn(cs.shape, generator=torch.Generator(device=dev).manual_seed(SEED + 50),
                     device=dev)
    times = {}
    for label, x in (("copies", cs), ("random", cr)):
        fns = [("select_topk", lambda: T.top_k_first(x, K)),
               ("torch.topk", lambda: torch.topk(x, K, dim=1)),
               ("plain", lambda: T._select_exact(x, K))]
        for name, fn in fns + fns[::-1]:
            times.setdefault((label, name), []).append(_median_ms(fn))
        times[label, "kernel"] = [_kernel_device_ms(fns[0][1], names=("select_topk",))]
        times[label, "merge"] = [_median_ms(lambda: T._topk_pad(x, ci, K))]
    times = {key: min(v) for key, v in times.items()}
    bound = _bound(_nbytes(cs) + cs.shape[0] * K * (4 + 8), 0)
    times["bound"] = bound
    for label in ("copies", "random"):
        print(f"phase13d the final top-{K} over K2's candidates {tuple(cs.shape)}, {label}: "
              f"select_topk {times[label, 'select_topk']:.4f} ms (kernel alone "
              f"{times[label, 'kernel']:.4f} device), torch.topk {times[label, 'torch.topk']:.4f}, "
              f"_select_exact {times[label, 'plain']:.4f}, _topk_pad (selection + gather) "
              f"{times[label, 'merge']:.4f}; bound {bound[0]:.4f} ms ({bound[1]}) {tag}",
              flush=True)
    return times


def phase_ties(dev, ivf_idxs, T, IP, errs, tag):
    """Phase 13a-d: the flat bf16, int8 and f32 routes (K1, K2 through auto
    and fused, K5, K6) and the IVF raw and PQ probes (K3, K4) on copied
    rows, against their plain versions, exactly; launches with the counters
    zeroed; select_topk against its plain version and its time (13d)."""
    from tostore_tpu_torch.vector import ivf as ivf_mod

    t_phase = time.perf_counter()
    flat = _tie_flat_index(dev)
    side = _tie_side_indexes(dev)
    copies = {"bf16": _copy_row(flat, TIE_SRC, _tie_slots(flat.corpus.capacity))}
    for p, idx in side.items():
        copies[p] = _copy_row(idx, TIE_SRC, _tie_slots(TIE_SIDE_ROWS))
    ivf_copies = {}
    for name in ("raw", "pq192"):
        idx = ivf_idxs[name]
        src = idx.corpus._pk_slot[IVF_N]  # the first appended row of phase 6
        row = _stored_row(idx, src)
        pks = [IVF_N] + [3 * IVF_N + j for j in range(TIE_COPIES)]
        ivf_copies[name] = (idx.upsert(pks, np.repeat(row[None], len(pks), 0)), row)
    _sync()
    print(f"phase13 built: bf16 l2 {N_ROWS} rows (capacity {flat.corpus.capacity}), int8 and "
          f"f32 {TIE_SIDE_ROWS}; copies of one row: bf16 {len(copies['bf16'][0])}, int8 "
          f"{len(copies['int8'][0])}, f32 {len(copies['float32'][0])}, IVF raw / pq192 "
          f"{TIE_COPIES + 1} each; {time.perf_counter() - t_phase:.1f} s {tag}", flush=True)

    flats = {"bf16": flat, **side}
    queries = {name: {b: _tie_queries(copies[name][1], b, SEED + 30 + b) for b in TIE_B}
               for name in flats}
    ivf_q = {name: _tie_queries(row, 8, SEED + 40) for name, (_, row) in ivf_copies.items()}

    # --- 13a: duplicate rows score bit-identically? (the kernels' raw candidates)
    bits = {}
    c = flat.corpus.vectors
    bias, alpha, _ = flat._bias_alpha(None)
    tied = set(copies["bf16"][0])
    for b in (8, 256):
        qt, _, _ = flat._prep_queries(queries["bf16"][b])
        blk_n, blk_b, t_cands, emit = T._acc_plan(qt, c, K, None)
        qp = T._pad_queries(qt, blk_b if not emit else min(T.MAX_BLK_B, -(-b // 8) * 8), c.dtype)
        if emit:
            bits["K2 (lane_topk_emit)"] = _bits_equal(
                *T._lane_topk_emit_cuda(qp, c, bias, None, alpha, blk_n), tied)
            bits["plain, torch.mm"] = _bits_equal(
                *T._block_cands_plain(qp, c, bias, None, alpha, blk_n), tied)
            qg = T._pad_queries(qt, T._group_plan(qt, c, BLK_N, None)[0], c.dtype)
            bits["K5 (lane_topk_group)"] = _bits_equal(*T._lane_topk_group_cuda(
                qg, c, bias, None, alpha, BLK_N, T._group_plan(qt, c, BLK_N, None)[1]), tied)
        else:
            bits["K1 (lane_topk_acc)"] = _bits_equal(
                *T._lane_topk_acc_cuda(qp, c, bias, None, alpha, blk_n, t_cands), tied)
    for p in ("int8", "float32"):
        idx = side[p]
        qt, _, _ = idx._prep_queries(queries[p][8])
        sbias, salpha, sscale = idx._bias_alpha(None)
        blk_n, blk_b, t_cands, _ = T._acc_plan(qt, idx.corpus.vectors, K, None)
        qp = T._pad_queries(qt, blk_b, idx.corpus.vectors.dtype)
        bits[f"K1 {p}"] = _bits_equal(*T._lane_topk_acc_cuda(
            qp, idx.corpus.vectors, sbias, sscale, salpha, blk_n, t_cands), set(copies[p][0]))
    for name, idx in ivf_idxs.items():
        if name not in ivf_copies:
            continue
        a = _probe_args(idx, ivf_q[name], IP)
        slots = idx.buckets_slots[a["probe"]]
        cap = slots.shape[-1]
        # per probed bucket: copies placed in other clusters' slices carry
        # other PQ codes (residuals of another centroid)
        bits[("K3 (ivf_bucket_probe)" if name == "raw" else "K4 (ivf_adc)")] = _bits_equal(
            a["kernel"]().reshape(-1, cap), slots.reshape(-1, cap),
            set(ivf_copies[name][0].tolist()))
    _zero_counters(T, IP)
    exact_bits = all(v is not False for v in bits.values())
    print("phase13a duplicated rows score bit-identically (each route's raw candidates): "
          + ", ".join(f"{k} {'yes' if v else ('no' if v is False else 'not seen')}"
                      for k, v in bits.items()), flush=True)
    if not exact_bits:
        print("phase13a duplicated rows do NOT all score bit-identically on this card: the "
              "routes marked no break their ties by those score differences, and their "
              "kernel-vs-plain comparison below still asks for equal hits in equal order",
              flush=True)

    # --- 13b: the routes, with every counter zeroed just before
    got = {}
    _zero_counters(T, IP)
    for name, idx in flats.items():
        for b in TIE_B:
            if name != "bf16" and b not in (8, 256):
                continue
            got[name, b, "auto"] = idx.search_arrays(queries[name][b], K, mode="auto")
            if b == 256:
                got[name, b, "fused"] = idx.search_arrays(queries[name][b], K, mode="fused")
        if name in ("bf16", "float32"):
            qt, _, _ = idx._prep_queries(queries[name][256])
            ibias, ialpha, _ = idx._bias_alpha(None)
            cv = idx.corpus.vectors
            got[name, "K5"] = T._fused_group_emit(qt, cv, ibias, k=K, alpha=ialpha, blk_n=BLK_N)
            got[name, "K6"] = T.pipe_topk(qt, cv, ibias, k=K, alpha=ialpha)
    for name in ivf_copies:
        got["ivf", name] = ivf_idxs[name].search_arrays(ivf_q[name], K, mode="probe")
    _sync()
    launches = {**T.LAUNCHES, **{k: v for k, v in IP.LAUNCHES.items()}}
    print(f"phase13b launches on the ties path: {launches} {tag}", flush=True)
    for key, n in launches.items():
        if n <= 0 and key not in GRAPH_COUNTERS + FLAT_GRAPH_COUNTERS:
            raise AssertionError(f"phase13b: kernel {key} was not launched on the ties path")

    # --- 13c: each route against its plain version, hits and order
    checked = 0
    for name, idx in flats.items():
        dtype = idx.corpus.vectors.dtype
        kname = "_f32" if dtype == torch.float32 else ""
        for (gname, b, mode) in [k for k in got if k[0] == name and len(k) == 3]:
            qt, _, _ = idx._prep_queries(queries[name][b])
            (kernel, kernel_fn), (_, plain_fn) = _pairs(idx, qt, b, T)[:2]
            kernel += kname
            ks, ki = kernel_fn()
            with _plain_selection(T):
                want = plain_fn()
            err = _tie_equal(f"phase13c {name} B={b} {kernel}", (ks, ki), want, TOL[dtype])
            errs[kernel] = max(errs[kernel], err)
            # the index's answer is the kernel's: its slots (misses -1), in order
            _, slots, _ = got[gname, b, mode]
            want = torch.where(ks > NEG_INF / 2, ki, torch.full_like(ki, -1)).cpu().numpy()
            if not np.array_equal(slots, want):
                raise AssertionError(f"phase13c {name} {mode} B={b}: search_arrays' slots "
                                     f"{slots[0].tolist()} are not the kernel's {want[0].tolist()}")
            checked += 1
            print(f"phase13c {name} {mode} B={b} ({kernel}): hits and order equal to plain; "
                  f"first row {slots[0].tolist()}", flush=True)
        if (name, "K5") in got:
            qt, _, _ = idx._prep_queries(queries[name][256])
            ibias, ialpha, _ = idx._bias_alpha(None)
            cv = idx.corpus.vectors
            for key, plain in (("K5", lambda: T._fused_group_emit_plain(
                                    qt, cv, ibias, k=K, alpha=ialpha, blk_n=BLK_N)),
                               ("K6", lambda: T._pipe_topk_plain(qt, cv, ibias, k=K,
                                                                 alpha=ialpha))):
                kernel = {"K5": "lane_topk_group", "K6": "lane_topk_group_pipe"}[key] + kname
                with _plain_selection(T):
                    want = plain()
                err = _tie_equal(f"phase13c {name} {key}", got[name, key], want, TOL[dtype])
                errs[kernel] = max(errs[kernel], err)
                checked += 1
    plain_fns = {"raw": ("bucket_probe_scores", IP._bucket_probe_scores_plain),
                 "pq192": ("adc_bucket_scores", IP._adc_bucket_scores_plain)}
    for name in ivf_copies:
        attr, plain = plain_fns[name]
        kernel_fn = getattr(ivf_mod, attr)
        setattr(ivf_mod, attr, plain)
        try:
            with _plain_selection(T):
                want = ivf_idxs[name].search_arrays(ivf_q[name], K, mode="probe")
        finally:
            setattr(ivf_mod, attr, kernel_fn)
        _sync()
        dist, slots, _ = got["ivf", name]
        kernel = "ivf_bucket_probe" if name == "raw" else "ivf_adc"
        if not np.array_equal(slots, want[1]):
            raise AssertionError(f"phase13c IVF {name}: slots {slots[0].tolist()} against plain "
                                 f"{want[1][0].tolist()}")
        # l2 distances through their squares, which carry the scores' error
        lim = TOL[torch.bfloat16] * np.maximum(1.0, np.sum(ivf_q[name] ** 2, axis=1))[:, None]
        if (np.abs(dist.astype(np.float64) ** 2 - want[0].astype(np.float64) ** 2) > lim).any():
            raise AssertionError(f"phase13c IVF {name}: distances differ from plain")
        hit = set(slots[0].tolist())
        if not hit <= set(ivf_copies[name][0].tolist()):
            raise AssertionError(f"phase13c IVF {name}: a hit that is no copy: {slots[0]}")
        checked += 1
        print(f"phase13c IVF {name} probe B=8 ({kernel}): hits and order equal to plain; "
              f"first row {slots[0].tolist()}", flush=True)

    # --- 13d: select_topk against _select_exact, bit for bit, and its time
    times = phase_select(dev, flat, queries["bf16"], T, errs, tag)
    print(f"phase13 {checked} routes equal to their plain versions in hits and order; "
          f"{time.perf_counter() - t_phase:.1f} s {tag}", flush=True)
    del flat, side
    torch.cuda.empty_cache()
    return launches, times


def phase_ties_sharded(sharded, deleted, T, tag):
    """Phase 13e: one (1, 4) sharded call over phase 10a's striped rows,
    with one row copied into every stripe, against the same call through
    K1's plain version."""
    rows = sharded._rows_per_shard()
    src = sharded._pk_slot[TIE_SRC]
    slots = [s * rows + off for s in range(4) for off in (TIE_SRC + 128, TIE_SRC + 3 * 2048,
                                                          TIE_SRC + 2 * 128 + 1)]
    pks = [TIE_SRC] + [sharded._slot_pks[s] for s in slots
                       if sharded._slot_pks[s] is not None and sharded._slot_pks[s] not in deleted]
    row = sharded.vectors.gather(np.array([src]))[0, :DIMS].float().cpu().numpy()
    sharded.upsert(pks, np.repeat(row[None], len(pks), 0))
    q = _tie_queries(row, 8, SEED + 60)
    T.LAUNCHES["lane_topk_acc"] = 0
    dist, got = sharded.search_arrays(q, K)
    _sync()
    launched = T.LAUNCHES["lane_topk_acc"]  # once a cell
    if launched != 4:
        raise AssertionError(f"phase13e: K1 launched {launched} times")
    kernel = T.fused_flat_topk
    T.fused_flat_topk = T._fused_flat_topk_plain
    try:
        with _plain_selection(T):
            pdist, want = sharded.search_arrays(q, K)
    finally:
        T.fused_flat_topk = kernel
    if got.tolist() != want.tolist():
        raise AssertionError(f"phase13e: sharded (1, 4) hits differ from plain: {got[0]} "
                             f"against {want[0]}")
    if not set(got[0].tolist()) <= set(pks):
        raise AssertionError(f"phase13e: a hit that is no copy: {got[0]}")
    print(f"phase13e sharded (1, 4) B=8 over {rows}-row stripes, {len(pks)} copies of one row "
          f"in all 4: K1 {launched} launches (once a cell), hits "
          f"and order equal to plain; first row "
          f"{got[0].tolist()} {tag}", flush=True)


def _print_ptxas(log):
    """One line per compiled kernel from nvcc -Xptxas -v: its (mangled,
    shortened) name, registers and spill bytes. Returns {name: spill
    bytes}."""
    import re

    name, spills = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            stem = re.search(r"(lane_scan\w*?_kernel|lane_topk\w*?_kernel|ivf_\w+?_kernel|"
                             r"select_topk_kernel)(\w*)",
                             m.group(1))
            name = (stem.group(1) + stem.group(2).split("EEEv")[0] if stem
                    else m.group(1))[:72]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills[name] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"  ptxas: {name}: {m.group(1)} registers, {spills.get(name, 0)} bytes "
                  f"spilled", flush=True)
    return spills


def main() -> int:
    if sys.argv[1:2] == ["--kill9-writer"]:  # phase 12b's child process
        return kill9_writer(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from tostore_tpu_torch.ops import _kernels
    from tostore_tpu_torch.ops import ivfprobe as IP
    from tostore_tpu_torch.ops import topk as T

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 corpora need true f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _kernels.library()
    print(f"kernel build {time.perf_counter() - t0:.2f} s (nvcc {_kernels.build_seconds:.2f} s)",
          flush=True)
    spills = _print_ptxas(_kernels.build_log)
    if any(spills[name] for name in spills if "lane_scan" in name or "ivf_" in name):
        raise AssertionError("a TMA / wgmma lane-scan or IVF kernel spills registers")

    errs = phase_kernels(dev, T)
    idxs, side, deleted = build_indexes(dev)
    launches, queries = phase_main_path(idxs, side, deleted, T)
    times, bounds = phase_main_kernels(idxs, side, queries, T, errs)
    phase_auto_route([idxs["l2"], side["int8"], side["float32"]], queries, T)
    if "--profile" in sys.argv[1:]:
        phase_profile(idxs["l2"], queries, T)
    flat, f32_idx = idxs.pop("l2"), side.pop("float32")  # phases 7 and 8 run on them
    del idxs, side
    torch.cuda.empty_cache()

    errs.update(phase_ivf_kernels(dev, IP))
    torch.cuda.empty_cache()
    ivf_idxs, ivf_deleted, ivf_queries, build_s = build_ivf_indexes(dev)
    ivf_launches = phase_ivf_main_path(ivf_idxs, ivf_deleted, ivf_queries, T, IP)
    phase_ivf_graph(ivf_idxs["raw"], ivf_queries, IP, T)
    ivf_times, ivf_bounds = phase_ivf_kernels_main(ivf_idxs, ivf_queries, errs, IP)
    phase_ivf_crossover(ivf_idxs, ivf_queries)
    if "--profile" in sys.argv[1:]:
        phase_ivf_profile(ivf_idxs, ivf_queries)
    group_errs, group_times, group_bounds = phase_group_kernels(dev, flat, f32_idx, T)
    errs.update(group_errs)
    hybrid_launches = phase_hybrid(flat, f32_idx, deleted, ivf_idxs, ivf_deleted, ivf_queries,
                                   T, IP)
    tag = f"[{smi}]"
    tie_launches, sel_times = phase_ties(dev, ivf_idxs, T, IP, errs, tag)
    del f32_idx, ivf_idxs  # the l2 index stays: phase 10a is held against it
    torch.cuda.empty_cache()
    engine_launches = phase_engine(T, IP, smi, times[1, "kernel"])

    sharded, shard_queries, flat_launches, _ = phase_sharded_flat(flat, deleted, T, IP, errs,
                                                                  tag)
    del flat
    phase_sharded_nccl(sharded, shard_queries, T, IP, tag)
    phase_ties_sharded(sharded, deleted, T, tag)
    del sharded
    torch.cuda.empty_cache()
    shard_ivf_launches, _, shard_build_s = phase_sharded_ivf(T, IP, errs, tag)
    shard_engine_launches = phase_sharded_engine(T, IP, errs, tag)
    phase_sharded_dryrun(T, IP, tag)
    bench_launches = phase_bench_scripts(tag)
    suite_launches = phase_suites(tag)
    entry_launches = phase_entry_points(T, IP, tag)
    # launches of K1-K4 from the sharded path, each leg read after its own
    # zeroing: 10a's two meshes, 10b's two indexes, 10c's engine searches
    sharded_launches = {
        "lane_topk_acc": sum(v["lane_topk_acc"] for v in flat_launches.values())
        + shard_engine_launches["lane_topk_acc"],
        "lane_topk_emit": sum(v["lane_topk_emit"] for v in flat_launches.values()),
        "ivf_bucket_probe": shard_ivf_launches["raw"]["ivf_bucket_probe"],
        "ivf_adc": shard_ivf_launches["pq192"]["ivf_adc"] + shard_engine_launches["ivf_adc"],
        "select_topk": sum(v["select_topk"] for v in flat_launches.values())
        + shard_engine_launches["select_topk"],
    }
    print(f"phase10 launches from the sharded path: {sharded_launches}", flush=True)

    f32_src = "tostore_tpu_torch/csrc/lane_topk.cu"
    scan_src = "tostore_tpu_torch/csrc/lane_scan.cuh"
    group_src = "tostore_tpu_torch/csrc/lane_scan_group.cu"
    ivf_src = "tostore_tpu_torch/csrc/ivf_probe.cu"

    def entry(name, source, replaces, launched, ms, plain_ms, bound, product_ms=None,
              kernel_ms=None):
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launched, "max_abs_err": errs[name], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": None}  # no single PyTorch call computes these functions
        if name in engine_launches:  # phase 9: through ToStoreTPU.vector_search (K2: the
            row["engine_launches"] = engine_launches[name]  # engine table's index object)
        if name in sharded_launches:  # phase 10: the per-stripe scans of parallel/
            row["sharded_launches"] = sharded_launches[name]
        if bench_launches.get(name):  # phase 11: the scripts' own processes, summed
            row["bench_launches"] = bench_launches[name]
        if name in suite_launches:  # phase 12a: the nine vector suites' child process
            row["suite_launches"] = suite_launches[name]
        if name in entry_launches:  # phase 12b: transactions, migration, SIGKILL recovery
            row["entry_launches"] = entry_launches[name]
        if name in tie_launches:  # phase 13b: the routes on copied rows
            row["tie_launches"] = tie_launches[name]
        if product_ms is not None:  # the score product alone (cuBLAS), not the same function
            row["product_ms"] = product_ms
        if kernel_ms is not None:  # the kernel alone, device time (ms: the wrapper's call)
            row["kernel_ms"] = kernel_ms
        return row

    report = {"kernels": [
        entry("lane_topk_acc", scan_src, "tostore_tpu/ops/topk.py:268", launches["lane_topk_acc"],
              times[1, "lane_topk_acc"], times[1, "plain"], bounds[1], times[1, "product"],
              times[1, "kernel"]),
        entry("lane_topk_emit", scan_src, "tostore_tpu/ops/topk.py:331",
              launches["lane_topk_emit"], times[256, "lane_topk_emit"], times[256, "plain"],
              bounds[256], times[256, "product"], times[256, "kernel"]),
        entry("ivf_bucket_probe", ivf_src, "tostore_tpu/ops/ivfprobe.py:130",
              ivf_launches["ivf_bucket_probe"], ivf_times["raw", 8, "kernel"],
              ivf_times["raw", 8, "plain"], ivf_bounds["raw", 8], ivf_times["raw", 8, "product"],
              ivf_times["raw", 8, "kernel_alone"]),
        entry("ivf_adc", ivf_src, "tostore_tpu/ops/ivfprobe.py:44", ivf_launches["ivf_adc"],
              ivf_times["pq192", 8, "kernel"], ivf_times["pq192", 8, "plain"],
              ivf_bounds["pq192", 8], kernel_ms=ivf_times["pq192", 8, "kernel_alone"]),
        entry("lane_topk_group", group_src, "tostore_tpu/ops/topk.py:361",
              hybrid_launches["lane_topk_group"], group_times[256, "lane_topk_group"],
              group_times[256, "lane_topk_group plain"], group_bounds[256],
              group_times[256, "product"], group_times[256, "lane_topk_group alone"]),
        entry("lane_topk_group_pipe", group_src, "experiments/_exp_pipe.py:75",
              hybrid_launches["lane_topk_group_pipe"], group_times[256, "lane_topk_group_pipe"],
              group_times[256, "lane_topk_group_pipe plain"], group_bounds[256],
              group_times[256, "product"], group_times[256, "lane_topk_group_pipe alone"]),
        # the f32 FMA kernels, on the f32 index (SIDE_ROWS rows)
        entry("lane_topk_acc_f32", f32_src, "tostore_tpu/ops/topk.py:268",
              launches["lane_topk_acc_f32"], times["float32", 8, "lane_topk_acc"],
              times["float32", 8, "plain"], bounds["float32", 8],
              times["float32", 8, "product"]),
        entry("lane_topk_emit_f32", f32_src, "tostore_tpu/ops/topk.py:331",
              launches["lane_topk_emit_f32"], times["float32", 256, "lane_topk_emit"],
              times["float32", 256, "plain"], bounds["float32", 256],
              times["float32", 256, "product"]),
        entry("lane_topk_group_f32", f32_src, "tostore_tpu/ops/topk.py:361",
              hybrid_launches["lane_topk_group_f32"],
              group_times["float32", 256, "lane_topk_group"],
              group_times["float32", 256, "lane_topk_group plain"], group_bounds["float32", 256]),
        entry("lane_topk_group_pipe_f32", f32_src, "experiments/_exp_pipe.py:75",
              hybrid_launches["lane_topk_group_pipe_f32"],
              group_times["float32", 256, "lane_topk_group_pipe"],
              group_times["float32", 256, "lane_topk_group_pipe plain"],
              group_bounds["float32", 256]),
        # K3 / K4's grouping pre-pass, alone, on the raw index's B = 64 probes
        # (no TPU kernel: the device form of the port's own stable sort by bucket)
        entry("ivf_group_pairs", ivf_src,
              "none (tostore_tpu_torch/ops/ivfprobe.py _group_pairs_plain)",
              ivf_launches["ivf_group_pairs"], ivf_times["raw", 64, "group_pairs"],
              ivf_times["raw", 64, "group_pairs plain"], ivf_bounds["raw", 64, "group_pairs"],
              kernel_ms=ivf_times["raw", 64, "prepass"]),
        # the final selection of every route (no TPU kernel: jax.lax.top_k),
        # over K2's [256, 65,536] candidates at 1M rows: the copied rows of
        # phase 13 (ms) and random scores; launches by phase, each counted
        # between its own zeroing and its read
        {"name": "select_topk", "route": "cuda",
         "source": "tostore_tpu_torch/csrc/select_topk.cu",
         "replaces": "none: jax.lax.top_k, tostore_tpu/ops/topk.py:659 and the other sites",
         "launches": launches["select_topk"], "max_abs_err": errs["select_topk"],
         "ms": sel_times["copies", "select_topk"], "plain_ms": sel_times["copies", "plain"],
         "bound_ms": sel_times["bound"][0], "bound_by": sel_times["bound"][1],
         "library_ms": sel_times["copies", "torch.topk"],
         "kernel_ms": sel_times["copies", "kernel"],
         "random_ms": sel_times["random", "select_topk"],
         "random_plain_ms": sel_times["random", "plain"],
         "random_library_ms": sel_times["random", "torch.topk"],
         "random_kernel_ms": sel_times["random", "kernel"],
         "launches_by_phase": {
             "2": launches["select_topk"], "6": ivf_launches["select_topk"],
             "8": hybrid_launches["select_topk"], "9": engine_launches["select_topk"],
             "10": sharded_launches["select_topk"], "12b": entry_launches["select_topk"],
             "13b": tie_launches["select_topk"]}},
    ]}
    print("build s (train + buckets): " + json.dumps(build_s) + "; sharded over 4 cells of "
          "one card: " + json.dumps(shard_build_s), flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
