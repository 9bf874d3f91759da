"""Product quantization (counterpart of `tostore_tpu/vector/pq.py`).

Per-subspace k-means codebooks, encode / decode, and asymmetric distance
computation (ADC) tables. The JAX package vmaps its Lloyd loop over the M
subspaces; here the subspaces are the batch dimension of one `bmm`.

Parity choices kept from the reference (and the JAX package):
  - default K = 256 centroids (one byte per subspace code),
  - M auto rule clamp(D/8, 8, 128) (ngh_index_meta.dart:237),
  - training sample cap 2500 (vector_index_manager.dart:204),
  - 10 Lloyd iterations, seeded numpy RNG for the sample and the initial
    centroids, so both packages train from the same rows,
  - ADC metrics: l2 table; IP table negated; cosine = l2 on normalized
    inputs (vector_quantizer.dart:387-455).

Ties: `torch.argmin` returns the first index on ties, as `jnp.argmin`
does, so codes and assignments agree with the JAX package outside
near-ties of the float sums.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.runtime import f32_dot
from ..ops.topk import top_k_first

DEFAULT_K = 256
TRAIN_SAMPLE_CAP = 2500
DEFAULT_ITERS = 10
# Elements of the [M, rows, K] distance tile `pq_encode` scores at once.
_ENCODE_TILE = 1 << 26


def auto_subspaces(dims: int) -> int:
    """Reference rule clamp(D/8, 8, 128), also forced to divide D."""
    m = max(8, min(128, dims // 8))
    while m > 1 and dims % m != 0:
        m -= 1
    return max(1, m)


@dataclass
class PQCodebook:
    """codebooks: [M, K, dsub] f32 tensor; dims = M * dsub."""

    codebooks: torch.Tensor
    dims: int

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    def state_dict(self):
        return {"codebooks": self.codebooks.cpu().numpy(), "dims": self.dims}

    @staticmethod
    def from_state_dict(d, *, device):
        cb = torch.tensor(np.asarray(d["codebooks"], np.float32), device=device)
        return PQCodebook(cb, int(d["dims"]))


def _subspace_view(x: torch.Tensor, m: int) -> torch.Tensor:
    """[N, D] -> [M, N, dsub]."""
    n, d = x.shape
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def _sq_dists(x: torch.Tensor, c: torch.Tensor, compute_dtype) -> torch.Tensor:
    """[M, S, dsub] x [M, K, dsub] -> [M, S, K] f32 squared distances,
    |x|^2 - 2 x.c + |c|^2 as the JAX package writes them. bf16
    compute_dtype rounds both sides to bf16 for the product, with f32
    output (ops/runtime.f32_dot); otherwise the product is true f32."""
    if compute_dtype == torch.bfloat16:
        dot = torch.stack([f32_dot(xm.to(torch.bfloat16), cm.to(torch.bfloat16))
                           for xm, cm in zip(x, c)])
    else:
        dot = torch.bmm(x, c.transpose(1, 2))
    return (torch.sum(x * x, dim=2, keepdim=True) - 2.0 * dot
            + torch.sum(c * c, dim=2)[:, None, :])


def _kmeans_all_subspaces(xs: torch.Tensor, init_idx: torch.Tensor, *, k: int, iters: int,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Lloyd iterations batched over subspaces. xs: [M, S, dsub] f32;
    init_idx: [M, K] sample indices of the initial centroids. Returns
    [M, K, dsub] f32. `compute_dtype=torch.bfloat16` scores the
    assignment in bf16 (coarse IVF training tolerates it; PQ codebooks
    stay f32). An empty cluster keeps its centroid."""
    m, _, dsub = xs.shape
    cents = torch.gather(xs, 1, init_idx.long()[:, :, None].expand(m, k, dsub))
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(xs, cents, compute_dtype), dim=2)  # [M, S]
        counts = torch.zeros((m, k), dtype=torch.float32, device=xs.device)
        counts.scatter_add_(1, assign, torch.ones_like(assign, dtype=torch.float32))
        sums = torch.zeros((m, k, dsub), dtype=torch.float32, device=xs.device)
        sums.scatter_add_(1, assign[:, :, None].expand(-1, -1, dsub), xs)
        cents = torch.where(counts[:, :, None] > 0,
                            sums / torch.clamp(counts, min=1.0)[:, :, None], cents)
    return cents


def train_pq(vectors: np.ndarray, m: int | None = None, k: int = DEFAULT_K,
             iters: int = DEFAULT_ITERS, seed: int = 42,
             sample_cap: int = TRAIN_SAMPLE_CAP, *, device) -> PQCodebook:
    """Train per-subspace codebooks on (a sample of) the host vectors."""
    x = np.asarray(vectors, np.float32)
    n, d = x.shape
    if m is None:
        m = auto_subspaces(d)
    if d % m != 0:
        raise ValueError(f"dims {d} not divisible by M={m}")
    rng = np.random.default_rng(seed)
    if n > sample_cap:
        x = x[rng.choice(n, sample_cap, replace=False)]
        n = sample_cap
    k_eff = min(k, n)
    init = np.stack([rng.choice(n, k_eff, replace=False) for _ in range(m)])
    xs = _subspace_view(torch.from_numpy(np.ascontiguousarray(x)).to(device), m).contiguous()
    cents = _kmeans_all_subspaces(xs, torch.from_numpy(init).to(device), k=k_eff, iters=iters)
    if k_eff < k:  # degenerate tiny corpora: repeat centroids up to K
        reps = -(-k // k_eff)
        cents = cents.repeat(1, reps, 1)[:, :k, :]
    return PQCodebook(cents.contiguous(), d)


def pq_encode(codebooks: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N, M] uint8 codes (argmin centroid per subspace), scored
    in row chunks that bound the [M, rows, K] distance tile."""
    m, k, _ = codebooks.shape
    n = vectors.shape[0]
    out = torch.empty((n, m), dtype=torch.uint8, device=vectors.device)
    step = max(1, _ENCODE_TILE // (m * k))
    for off in range(0, n, step):
        xs = _subspace_view(vectors[off : off + step].float(), m)
        codes = torch.argmin(_sq_dists(xs, codebooks, torch.float32), dim=2)  # [M, rows]
        out[off : off + step] = codes.t().to(torch.uint8)
    return out


def pq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[N, M] codes -> [N, D] reconstructed f32 vectors."""
    m, _, dsub = codebooks.shape
    sub = torch.arange(m, device=codes.device)[None, :]
    return codebooks[sub, codes.long()].reshape(codes.shape[0], m * dsub)


def adc_tables(codebooks: torch.Tensor, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Per-query ADC distance tables [B, M, K] (reference
    buildDistanceTable{,IP,Cosine} vector_quantizer.dart:387-455). Lower is
    better for all metrics (IP negated; cosine assumes normalized inputs)."""
    m = codebooks.shape[0]
    qs = _subspace_view(q.float(), m)  # [M, B, dsub]
    ip = torch.bmm(qs, codebooks.transpose(1, 2))  # [M, B, K]
    if metric == "dot":
        t = -ip
    else:
        t = (torch.sum(qs * qs, dim=2, keepdim=True) - 2.0 * ip
             + torch.sum(codebooks * codebooks, dim=2)[:, None, :])
    return t.permute(1, 0, 2)


def adc_tables_probed(codebooks: torch.Tensor, q: torch.Tensor, cents: torch.Tensor,
                      probes: torch.Tensor, metric: str = "l2"):
    """Per-(query, probed-cluster) ADC tables for RESIDUAL codes (IVFADC,
    Jegou et al.): codes quantize x - centroid[cluster(x)], so the l2
    table of probe p is built from q - centroid[p]. For dot the residual
    table is centroid-independent (-q.r) and the constant q.c_p comes
    back as an additive per-probe offset.

    q [B, D] un-padded; cents [C, D] un-padded; probes [B, P] int.
    Returns (tabs [B, P, M, K] lower = closer, offs [B, P] added to the
    NEGATED-distance score)."""
    b, d = q.shape
    p = probes.shape[1]
    cp = cents[probes.long()]  # [B, P, D]
    if metric == "dot":
        tabs = adc_tables(codebooks, q, metric="dot")
        tabs = tabs[:, None].expand(b, p, *tabs.shape[1:])
        offs = torch.sum(q[:, None, :] * cp, dim=-1)
        return tabs, offs
    qr = (q[:, None, :] - cp).reshape(b * p, d)
    tabs = adc_tables(codebooks, qr, metric="l2").reshape(b, p, *codebooks.shape[:2])
    return tabs, torch.zeros((b, p), dtype=torch.float32, device=q.device)


def adc_scan(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC distances [B, N]: sum_m tables[b, m, codes[n, m]] (the
    reference's scalar hot loop adcDistance, vector_quantizer.dart:414, as
    one gather). The probe path runs K4 over bucket-contiguous codes
    instead (ops/ivfprobe.py adc_bucket_scores)."""
    m = tables.shape[1]
    sub = torch.arange(m, device=codes.device)[None, :]
    return tables[:, sub, codes.long()].sum(dim=2)


def adc_search(codebook: PQCodebook, codes: torch.Tensor, q: torch.Tensor, k: int,
               metric: str = "l2", bias: torch.Tensor | None = None):
    """Full ADC path: tables -> scan -> top-k. Returns (adc_dist [B, k],
    idx [B, k] int32). `bias` ([N] f32, NEG_INF for invalid) masks
    tombstones."""
    d = adc_scan(adc_tables(codebook.codebooks, q, metric=metric), codes)
    s = -d
    if bias is not None:
        s = s + bias[None, :]
    top_s, top_i = top_k_first(s, min(k, codes.shape[0]))
    return -top_s, top_i.to(torch.int32)
