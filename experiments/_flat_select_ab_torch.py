"""The flat path around its final selection (`ops.topk.top_k_first`) on
the card, for comparing checkouts of the port. Builds one 1M x 768 bf16
l2 index (1% deleted) from a seed, then prints one dict of:

- median CUDA-event ms of `fused_flat_topk` at B = 1, 8, 32 (K1) and 256
  (K2), the wrapper's selection and its host sync included;
- the headline's QPS as `bench_torch.timeit` defines it: the best of 3
  trials, each the mean of 30 back-to-back `flat_search` calls at B = 256;
- host-clock ms of `search_arrays` at B = 1, 8, 256: unmasked, with 5 rows
  passing a slot mask (fewer than k = 10: the rest are misses), and with
  25% passing;
- median ms of the final top-10 (`_topk_pad`) over K2's [256, 65,536]
  candidates, over random scores and over scores rounded to halves (ties
  at every cut), each beside torch.topk on the same input.

    python3 experiments/_flat_select_ab_torch.py [checkout root] [label]

The checkout root (default: this one) goes first on sys.path, so that one
command can time a parent and a change in turns, one process each, e.g.
`for t in parent change change parent; do python3
experiments/_flat_select_ab_torch.py <root of $t> $t; done`.
"""

import sys
import time
from pathlib import Path

import numpy as np

N, D, K = 1_000_000, 768, 10


def _median_ms(torch, fn, reps=15):
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


def _host_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main(root: str, label: str):
    sys.path.insert(0, root)
    import torch

    from tostore_tpu_torch import FlatVectorIndex
    from tostore_tpu_torch.ops import topk as T

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = "cuda"
    rng = np.random.default_rng(7)
    idx = FlatVectorIndex(D, "l2", "bfloat16", device=dev)
    for off in range(0, N, 125_000):
        idx.upsert(list(range(off, off + 125_000)),
                   rng.standard_normal((125_000, D), dtype=np.float32))
    idx.delete(sorted(rng.choice(N, N // 100, replace=False).tolist()))
    torch.cuda.synchronize()
    c = idx.corpus.vectors
    bias, alpha, scale = idx._bias_alpha(None)

    out = {}
    qs = {b: rng.standard_normal((b, D), dtype=np.float32) for b in (1, 8, 32, 256)}
    for b in (1, 8, 32, 256):
        qt, _, _ = idx._prep_queries(qs[b])
        out[f"call B={b}"] = min(_median_ms(torch, lambda: T.fused_flat_topk(
            qt, c, bias, k=K, alpha=alpha, row_scale=scale)) for _ in range(2))
    qt, _, _ = idx._prep_queries(qs[256])
    T.flat_search(qt, c, bias, k=K, alpha=alpha, row_scale=scale)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            T.flat_search(qt, c, bias, k=K, alpha=alpha, row_scale=scale)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 30)
    out["headline QPS (timeit, B=256)"] = 256 / best
    few = torch.zeros(idx.corpus.capacity, dtype=torch.bool, device=dev)
    few[[3, 20, 7, 200, 35]] = True
    quarter = torch.from_numpy(rng.random(idx.corpus.capacity) < 0.25).to(dev)
    for b in (1, 8, 256):
        out[f"search_arrays B={b}"] = _host_ms(torch, lambda: idx.search_arrays(qs[b], K))
        out[f"search_arrays 5 rows pass B={b}"] = _host_ms(
            torch, lambda: idx.search_arrays(qs[b], K, slot_mask=few))
        out[f"search_arrays 25% pass B={b}"] = _host_ms(
            torch, lambda: idx.search_arrays(qs[b], K, slot_mask=quarter))
    qp = T._pad_queries(qt, 256, c.dtype)
    cs, ci = T._lane_topk_emit_cuda(qp, c, bias, None, alpha, 4096)
    cr = torch.randn(cs.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    for name, x in (("K2 cands", cs), ("random", cr), ("rounded (ties)", (cs * 2).round() / 2)):
        out[f"merge {name}"] = _median_ms(torch, lambda: T._topk_pad(x, ci, K))
        out[f"torch.topk {name}"] = _median_ms(torch, lambda: torch.topk(x, K, dim=1))
    print(label, {key: round(v, 4) for key, v in out.items()}, flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(args[0] if args else str(Path(__file__).resolve().parent.parent),
         args[1] if len(args) > 1 else "this checkout")
