"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--profile]

Needs one CUDA device, nvcc (the kernels in tostore_tpu_torch/csrc/ are
built at first use) and this repository's tostore_tpu_torch package; it
imports nothing of JAX or tostore_tpu. Phases:

  1. K1 (lane_topk_acc) and K2 (lane_topk_emit) against their plain PyTorch
     versions on the same CUDA tensors: f32, bf16 and int8+scale; dot, l2
     and cosine; N = 131072, D = 768. Scores within 1e-5 (f32) or 1e-4
     (bf16, int8) of max(1, |score|), indices equal as sets outside
     near-ties at the k-th score.
  2. The main path at size: FlatVectorIndex(768, l2 / dot, "bfloat16") on
     the card, 1,000,000 seeded vectors upserted in chunks, 1% deleted;
     search_arrays at k = 10 for B = 1, 8, 32 (auto -> K1), B = 256 (auto ->
     lane scan) and B = 256 mode="fused" (K2), plus single-query search().
     The kernels' launch counters are zeroed just before and read just
     after; each must be > 0. Top-10 agreement with mode="exact" >= 0.999,
     the distances of the pks both return within the bf16 tolerance of the
     exact ones, and no deleted pk may come back.
  3. K1 and K2 against their plain versions on the main path's own inputs
     (both indexes' corpus, bias and scales at capacity 1,048,576, where a
     CTA folds several blocks), with the bf16 tolerance; then median ms per
     scan of the l2 index, kernel beside plain version, for each B.
  4. With --profile: the corpus's read floors on this card (a device copy
     and an int16 max over it) and, from torch.profiler, each kernel's
     device time beside the device time of its whole call.

Prints the card's name and power limit, the torch and CUDA versions, the
build time, a JSON line of the kernels, and last `{"ok": true, ...}`. Any
failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


def phase_kernels(dev, T):
    """Phase 1: each kernel against its plain version at N = 131072."""
    rng = np.random.default_rng(SEED)
    errs = {"lane_topk_acc": 0.0, "lane_topk_emit": 0.0}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for metric in ("dot", "l2", "cosine"):
            c, bias, scale, alpha = _corpus(rng, CHECK_N, dtype, metric, dev)
            for b in (1, 8, 32, 40, 256):
                q = rng.standard_normal((b, DIMS), dtype=np.float32)
                if metric == "cosine":
                    q = q / np.linalg.norm(q, axis=1, keepdims=True)
                q = torch.from_numpy(q).to(dev)
                if b <= 32:
                    name = "lane_topk_acc"
                    ks, ki = T.fused_flat_topk(q, c, bias, k=K, alpha=alpha, row_scale=scale)
                    ps, pi = T._fused_flat_topk_plain(q, c, bias, k=K, alpha=alpha,
                                                      row_scale=scale)
                else:
                    name = "lane_topk_emit"
                    ks, ki = T._fused_block_emit(q, c, bias, k=K, alpha=alpha, blk_n=4096,
                                                 row_scale=scale)
                    ps, pi = T._fused_block_emit_plain(q, c, bias, k=K, alpha=alpha,
                                                       blk_n=4096, row_scale=scale)
                torch.cuda.synchronize()
                err = _check_topk(ks, ki, ps, pi, TOL[dtype])
                errs[name] = max(errs[name], err)
                print(f"phase1 {name} {str(dtype)[6:]} {metric} B={b}: max_abs_err {err}",
                      flush=True)
    return errs


def build_indexes(dev):
    from tostore_tpu_torch import FlatVectorIndex

    rng = np.random.default_rng(SEED + 1)
    idxs = {m: FlatVectorIndex(DIMS, m, "bfloat16", device=dev) for m in ("l2", "dot")}
    t0 = time.perf_counter()
    chunk = 125_000
    for off in range(0, N_ROWS, chunk):
        x = rng.standard_normal((chunk, DIMS), dtype=np.float32)
        pks = list(range(off, off + chunk))
        for idx in idxs.values():
            idx.upsert(pks, x)
    deleted = set(rng.choice(N_ROWS, N_ROWS // 100, replace=False).tolist())
    for idx in idxs.values():
        idx.delete(sorted(deleted))
    torch.cuda.synchronize()
    print(f"built 2 indexes of {N_ROWS} x {DIMS} bf16 (capacity "
          f"{idxs['l2'].corpus.capacity}) in {time.perf_counter() - t0:.1f} s", flush=True)
    return idxs, deleted


MAIN_CALLS = [(1, "auto"), (8, "auto"), (32, "auto"), (256, "auto"), (256, "fused")]
TIMED_B = (1, 8, 32, 256)


def phase_main_path(idxs, deleted, T):
    """Phase 2: the main path through the public index API."""
    rng = np.random.default_rng(SEED + 2)
    queries = {b: rng.standard_normal((b, DIMS), dtype=np.float32) for b, _ in MAIN_CALLS}
    single = rng.standard_normal(DIMS, dtype=np.float32)
    for key in T.LAUNCHES:
        T.LAUNCHES[key] = 0
    results = {}
    for metric, idx in idxs.items():
        for b, mode in MAIN_CALLS:
            results[metric, b, mode] = idx.search_arrays(queries[b], K, mode=mode)
        results[metric, "single"] = idx.search(single, top_k=K)
    torch.cuda.synchronize()
    launches = dict(T.LAUNCHES)
    print(f"phase2 launches on the main path: {launches}", flush=True)
    for key, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {key} was not launched on the main path")

    agree = total = 0
    dist_err = 0.0
    for metric, idx in idxs.items():
        for b, mode in MAIN_CALLS:
            dist, slots, pks = results[metric, b, mode]
            if dist.shape != (b, K) or not np.isfinite(dist).all() or (slots < 0).any():
                raise AssertionError(f"{metric} B={b} {mode}: bad result shape or values")
            if any(p in deleted for p in pks.ravel()):
                raise AssertionError(f"{metric} B={b} {mode}: a deleted pk came back")
            edist, _, epks = idx.search_arrays(queries[b], K, mode="exact")
            for row in range(b):
                agree += len(set(pks[row].tolist()) & set(epks[row].tolist()))
                total += K
                err = _check_shared_dists(metric, queries[b][row], pks[row], dist[row],
                                          epks[row], edist[row])
                dist_err = max(dist_err, err)
        hits = results[metric, "single"]
        edist, _, epks = idx.search_arrays(single, K, mode="exact")
        if len(hits) != K or any(h.primary_key in deleted for h in hits):
            raise AssertionError(f"{metric}: single-query search returned {len(hits)} hits")
        agree += len({h.primary_key for h in hits} & set(epks[0].tolist()))
        total += K
        err = _check_shared_dists(metric, single, np.array([h.primary_key for h in hits]),
                                  np.array([h.distance for h in hits]), epks[0], edist[0])
        dist_err = max(dist_err, err)
    rate = agree / total
    print(f"phase2 top-{K} agreement with mode='exact': {rate} over {total // K} queries; "
          f"max |score diff| of shared pks {dist_err}", flush=True)
    if rate < AGREEMENT_MIN:
        raise AssertionError(f"top-{K} agreement {rate} < {AGREEMENT_MIN}")
    return launches, queries


def _check_shared_dists(metric, q, pks, dist, epks, edist):
    """Distances of the pks that a search and the exact path both return,
    compared as scores (l2 before the sqrt) within the bf16 tolerance of
    max(1, |score|). Returns the largest |score difference|."""
    tol = TOL[torch.bfloat16]
    qsq = float(np.dot(q.astype(np.float64), q.astype(np.float64)))

    def score(d):
        d = float(d)
        return qsq - d * d if metric == "l2" else -d

    want = {p: score(d) for p, d in zip(epks.tolist(), edist.tolist())}
    worst = 0.0
    for p, d in zip(pks.tolist(), dist.tolist()):
        if p not in want:
            continue
        err = abs(score(d) - want[p])
        if err > tol * max(1.0, abs(want[p])):
            raise AssertionError(f"{metric}: pk {p} score {score(d)} vs exact {want[p]}")
        worst = max(worst, err)
    return worst


def _median_ms(fn, reps=15):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _pairs(idx, qt, b, T):
    """(name, fn) of the fused kernel at B and its plain version, on the
    index's own corpus, bias and scales; the lane scan joins at B > 32."""
    c = idx.corpus.vectors
    bias, alpha, scale = idx._bias_alpha(None)
    if b <= 32:
        return (("lane_topk_acc", lambda: T.fused_flat_topk(
                    qt, c, bias, k=K, alpha=alpha, row_scale=scale)),
                ("plain", lambda: T._fused_flat_topk_plain(
                    qt, c, bias, k=K, alpha=alpha, row_scale=scale)))
    return (("lane_topk_emit", lambda: T._fused_block_emit(
                qt, c, bias, k=K, alpha=alpha, blk_n=4096, row_scale=scale)),
            ("plain", lambda: T._fused_block_emit_plain(
                qt, c, bias, k=K, alpha=alpha, blk_n=4096, row_scale=scale)),
            ("lane_scan", lambda: T.flat_topk_lane(
                qt, c, bias, k=K, alpha=alpha, row_scale=scale)))


def phase_main_kernels(idxs, queries, T, errs):
    """Phase 3: each kernel against its plain version on the main path's
    inputs, then device time per scan of the l2 index, kernel vs plain."""
    for metric, idx in idxs.items():
        for b in TIMED_B:
            qt, _, _ = idx._prep_queries(queries[b])
            (name, kernel), (_, plain) = _pairs(idx, qt, b, T)[:2]
            ks, ki = kernel()
            ps, pi = plain()
            torch.cuda.synchronize()
            err = _check_topk(ks, ki, ps, pi, TOL[torch.bfloat16])
            errs[name] = max(errs[name], err)
            print(f"phase3 {name} {metric} main-path inputs B={b}: max_abs_err {err}",
                  flush=True)
    idx = idxs["l2"]
    times = {}
    for b in TIMED_B:
        qt, _, _ = idx._prep_queries(queries[b])
        pair = _pairs(idx, qt, b, T)
        # kernel, plain, plain, kernel: each version measured twice in turns
        order = list(pair) + list(reversed(pair))
        for name, fn in order:
            times.setdefault((b, name), []).append(_median_ms(fn))
        t0 = time.perf_counter()
        for _ in range(5):
            idx.search_arrays(queries[b], K)
        host = (time.perf_counter() - t0) / 5 * 1e3
        row = "  ".join(f"{name} {min(times[b, name]):.4f} ms" for name, _ in pair)
        print(f"phase3 B={b}: {row}  |  search_arrays(auto) {host:.3f} ms host clock",
              flush=True)
    return {key: min(v) for key, v in times.items()}


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
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            total += ev.self_device_time_total
            if "lane_topk" in ev.key:
                kern += ev.self_device_time_total
        print(f"profile B={b}: {name} kernel {kern / 5e3:.4f} ms of {total / 5e3:.4f} ms "
              f"device per call", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from tostore_tpu_torch.ops import _kernels
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
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.split(":", 1)[-1].strip(), flush=True)

    errs = phase_kernels(dev, T)
    idxs, deleted = build_indexes(dev)
    launches, queries = phase_main_path(idxs, deleted, T)
    times = phase_main_kernels(idxs, queries, T, errs)
    if "--profile" in sys.argv[1:]:
        phase_profile(idxs["l2"], queries, T)

    src = "tostore_tpu_torch/csrc/lane_topk.cu"
    report = {"kernels": [
        {"name": "lane_topk_acc", "route": "cuda", "source": src,
         "replaces": "tostore_tpu/ops/topk.py:268", "launches": launches["lane_topk_acc"],
         "max_abs_err": errs["lane_topk_acc"], "ms": times[1, "lane_topk_acc"],
         "plain_ms": times[1, "plain"]},
        {"name": "lane_topk_emit", "route": "cuda", "source": src,
         "replaces": "tostore_tpu/ops/topk.py:331", "launches": launches["lane_topk_emit"],
         "max_abs_err": errs["lane_topk_emit"], "ms": times[256, "lane_topk_emit"],
         "plain_ms": times[256, "plain"]},
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
