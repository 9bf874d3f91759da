"""Sweep the design constants of the IVF-PQ kernel K4 on one NVIDIA GPU,
and time what the grouping of (query, probe) pairs costs; with --group,
time what binds the grouped lane scan K5 instead.

    python3 ivf_sweep.py [--group]

Needs one CUDA device and nvcc, as chip_smoke.py does; imports nothing of
JAX or tostore_tpu. It builds chip_smoke.py's two IVF-PQ indexes (500,000
clustered rows at 768 dims, C = 1024, nprobe = 16; M = 192 / K = 16
packed and M = 96 / K = 256) and, at B = 8 and 64:

  - prints how the pairs fall into runs (distinct probed buckets, the
    longest run);
  - builds variants of tostore_tpu_torch/csrc/ivf_probe.cu that differ
    only in one constant of K4 (pairs per work item K4_SEG; the shared
    memory a CTA may take and still share its SM with another), checks
    each against the shipped kernel's scores, and prints each kernel's
    device time (torch.profiler, L2 flushed before each call);
  - prints the host time per call of a stable torch.sort of the probe
    ids, the grouping that the kernels' own pre-pass replaced.

With --group it builds variants of tostore_tpu_torch/csrc/lane_scan_group.cu
(the products without the selection; the query k-slice loaded only while
the ring first fills; a ring of 4 stages instead of 8) and prints K5's
device time on a seeded 1,048,576 x 768 bf16 corpus at gsz 32 for B = 256
(64-query tiles) and B = 128 (32-query tiles), every variant twice in
turns. The first two variants compute wrong candidates on purpose: they
show what the selection and the query traffic cost, and are checked for
nothing; the ring of 4 must give the shipped kernel's candidates.

Writes the variant sources and libraries under chiprun_out/ivf_sweep/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

OUT = Path("chiprun_out/ivf_sweep")
SRC = Path("tostore_tpu_torch/csrc/ivf_probe.cu")
SEG = "constexpr int K4_SEG = 2;"
TWO_PER_SM = "constexpr size_t K4_TWO_PER_SM = 113 * 1024;"
VARIANTS = {
    "shipped": [],
    "seg 4": [(SEG, "constexpr int K4_SEG = 4;")],
    "seg 8": [(SEG, "constexpr int K4_SEG = 8;")],
    "whole runs": [(SEG, "constexpr int K4_SEG = 1 << 30;")],
    "1 CTA per SM": [(TWO_PER_SM, "constexpr size_t K4_TWO_PER_SM = 232448;")],
}


GROUP_SRC = Path("tostore_tpu_torch/csrc/lane_scan_group.cu")
GROUP_VARIANTS = {
    "shipped": [],
    "no selection": [("      fold_tile<R, 0, R>(p, acc, c, alpha);\n"
                      "      if (c.ri == rows_per_lane - 1) fold_block(p, c, e);",
                      "      if (c.ri == rows_per_lane - 1) fold_block(p, c, e);")],
    "no query loads": [
        ("        mbar_expect_tx(&full[s], S::STAGE);",
         "        mbar_expect_tx(&full[s], it < STAGES ? S::STAGE : S::C_BYTES);"),
        ("        tma_load_2d(st + S::C_BYTES, &qmap, &full[s], ks * KT, qt * NQ);",
         "        if (it < STAGES) tma_load_2d(st + S::C_BYTES, &qmap, &full[s], ks * KT, "
         "qt * NQ);")],
    "ring of 4": [("using lane_scan::STAGES;", "constexpr int STAGES = 4;")],
}


def build_variants(src=SRC, variants=None, entry="ivf_adc"):
    """{name: ctypes entry point} of every variant of src, all nvcc
    processes at once."""
    from tostore_tpu_torch.ops import _kernels

    OUT.mkdir(parents=True, exist_ok=True)
    base = src.read_text()
    procs = {}
    for name, subs in (VARIANTS if variants is None else variants).items():
        text = base
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {src}")
            text = text.replace(old, new)
        stem = f"{src.stem}_{name.replace(' ', '_')}"
        cu = OUT / f"{stem}.cu"
        cu.write_text(text)
        procs[name] = (stem, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(src.parent), "-o",
             str(OUT / f"lib{stem}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(OUT / f"lib{stem}.so")), entry)
        fn.argtypes = _kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def group_sweep(dev):
    """K5's device time per variant of lane_scan_group.cu (module docstring)."""
    fns = build_variants(GROUP_SRC, GROUP_VARIANTS, "lane_topk_group")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    n, d, blk_n, gsz = 1 << 20, cs.DIMS, 2048, 32
    c = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.zeros(n, device=dev)
    width = n // (blk_n * gsz) * 256
    for b, tile_b in ((256, 64), (128, 32)):
        q = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        outs = {name: (torch.empty((b, width), device=dev),
                       torch.empty((b, width), dtype=torch.int32, device=dev)) for name in fns}
        ms = {}
        for name, fn in list(fns.items()) + list(fns.items())[::-1]:
            out_s, out_i = outs[name]

            def call(fn=fn, out_s=out_s, out_i=out_i):
                err = fn(q.data_ptr(), c.data_ptr(), 1, bias.data_ptr(), None, 1.0, b, b, d, n,
                         blk_n, n // blk_n, gsz, tile_b, out_s.data_ptr(), out_i.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: cudaError {err}")
            ms.setdefault(name, []).append(
                cs._kernel_device_ms(call, names=("lane_scan_group",)))
        for x, y in zip(outs["shipped"], outs["ring of 4"]):
            if not torch.equal(x, y):
                raise AssertionError("ring of 4: candidates differ from the shipped kernel's")
        print(f"K5 kernel ms, B={b}, {tile_b}-query tiles: " + "; ".join(
            f"{name} {v[0]:.4f} / {v[1]:.4f}" for name, v in ms.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ivf_sweep.py needs a CUDA device")
    from tostore_tpu_torch.ops import ivfprobe as IP
    from tostore_tpu_torch.vector.ivf import _pq_tables, _select_probes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if "--group" in sys.argv[1:]:
        group_sweep(dev)
        return 0
    fns = build_variants()
    cs.IVF_N = cs.PQ_N  # the PQ indexes need only their 500,000 rows
    idxs, _, queries, _ = cs.build_ivf_indexes(dev)
    flush = cs._l2_flush(dev)
    for name in cs.PQ_CONFIGS:
        idx = idxs[name]
        c, rows, cap = idx.bucket_codes.shape
        for b in (8, 64):
            qt = torch.from_numpy(np.pad(queries[b], ((0, 0), (0, idx.corpus.d_pad - cs.DIMS))))
            qt = qt.to(dev)
            probe = _select_probes(qt, idx.centroids, idx._slice_cluster_dev, idx.slice_bias,
                                   True, idx.nprobe)
            tabs, _ = _pq_tables(idx.pq.codebooks, qt[:, :cs.DIMS],
                                 idx.centroids_exp[:, :cs.DIMS], probe, "l2", True)
            ids, _ = IP._group_pairs_plain(probe, c)
            runs = torch.unique_consecutive(ids, return_counts=True)[1]
            print(f"{name} B={b}: {probe.numel()} pairs in {runs.numel()} runs, longest "
                  f"{int(runs.max())}", flush=True)
            want = IP.adc_bucket_scores(tabs, probe, idx.bucket_codes, idx.bucket_bias)
            tb = IP._bf16_tables(tabs)
            m, k, kp = tabs.shape[2], tabs.shape[3], tb.shape[3]
            packed = rows * 2 == m
            m_chunk = max(2 if packed else 1, IP.ADC_SMEM_BYTES // (2 * kp))
            m_chunk = min(m, m_chunk - (m_chunk % 2 if packed else 0))
            n = probe.numel()
            scratch = torch.empty((2, n), dtype=torch.int32, device=dev)
            out = torch.empty_like(want)
            row = []
            for vname, fn in fns.items():
                def call(fn=fn):
                    err = fn(tb.data_ptr(), tb.stride(0), tb.stride(1) if tb.shape[1] > 1 else 0,
                             probe.data_ptr(), int(probe.dtype == torch.int64), *probe.stride(),
                             *probe.shape, idx.bucket_codes.data_ptr(),
                             idx.bucket_bias.data_ptr(), c, m, k, kp, cap, int(packed), m_chunk,
                             scratch[0].data_ptr(), scratch[1].data_ptr(), out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"{vname}: cudaError {err}")
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{vname}: scores differ from the shipped kernel's")
                ms = cs._kernel_device_ms(call, names=("ivf_adc_kernel",), flush=flush)
                row.append(f"{vname} {ms:.4f}")
            print(f"  K4 kernel ms (L2 cold): " + "; ".join(row), flush=True)
            flat = probe.reshape(-1)
            torch.sort(flat, stable=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                torch.sort(flat, stable=True)
            host = (time.perf_counter() - t0) / 200 * 1e3
            torch.cuda.synchronize()
            print(f"  torch.sort(stable) of the {n} ids: {host:.4f} ms host per call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
