"""Sweep the design constants of the IVF-PQ kernel K4 on one NVIDIA GPU,
and time what the grouping of (query, probe) pairs costs.

    python3 ivf_sweep.py

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


def build_variants():
    """{name: ctypes ivf_adc} of every variant, all nvcc processes at once."""
    from tostore_tpu_torch.ops import _kernels

    OUT.mkdir(parents=True, exist_ok=True)
    base = SRC.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {SRC}")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        cu = OUT / f"{stem}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(SRC.parent), "-o",
             str(OUT / f"lib{stem}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"lib{name.replace(' ', '_')}.so")).ivf_adc
        fn.argtypes = _kernels._SIGNATURES["ivf_adc"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ivf_sweep.py needs a CUDA device")
    from tostore_tpu_torch.ops import ivfprobe as IP
    from tostore_tpu_torch.vector.ivf import _pq_tables, _select_probes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
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
