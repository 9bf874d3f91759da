"""Sharded scans + the sharded flat index (counterpart of
`tostore_tpu/parallel/sharded.py`).

Per-shard partial top-k + merge: each cell scans only its corpus stripe
with the same fused scan as the single-device path (ops/topk.py, kernels
K1 / K2 on a CUDA cell), produces k local candidates, and the candidates
of all shards (k * n_shards values, tiny) are gathered and merged; the
final top-k is computed on every process. Queries split over the "dp"
axis. Index training is one data-parallel Lloyd step per iteration: local
sums, then one all-reduce.

Where the JAX package traces a `shard_map` body, the functions here run
the body once per owned cell (parallel/mesh.py); every cell's work is
launched before the first result is read, so CUDA cells overlap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import distance as D
from ..ops import topk as T
from ..ops.runtime import NEG_INF, ROW_BLOCK, round_up
from ..ops.topk import top_k_first
from ..utils.bf16 import BF16Array
from ..vector.corpus import _UPLOAD_BYTES, pks_at, quantize_int8
from ..vector.flat import hits_of
from .mesh import Mesh, Striped, replicated_from_host, shard_count

# rows of a stripe scored at once by the Lloyd step
KMEANS_CHUNK = 65536


def _as_tensor(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device)


def _pad_local(ts, gl, k: int):
    """Pad a cell's [Bl, kk] winners to k columns with NEG_INF / index 0,
    as the reference pads a stripe shorter than k."""
    kk = ts.shape[1]
    if kk < k:
        ts = torch.nn.functional.pad(ts, (0, k - kk), value=NEG_INF)
        gl = torch.nn.functional.pad(gl, (0, k - kk))
    return ts, gl


def _merge_local_topk(local: dict, k: int, mesh: Mesh):
    """{(dp index, shard): (scores [Bl, k], global idx [Bl, k])} of the
    owned cells -> (scores [B, k], idx [B, k]) on the mesh's device, the
    same on every process: the winners of all shards are gathered and each
    dp row's [Bl, nsh * k] candidates reduced to the global top-k, shard
    by shard in order, the first of equal scores winning as `lax.top_k`
    does."""
    nsh, dp = shard_count(mesh), mesh.shape["dp"]
    all_s = mesh.all_gather_cells({key: v[0] for key, v in local.items()})
    all_i = mesh.all_gather_cells({key: v[1] for key, v in local.items()})
    out_s, out_i = [], []
    for dpi in range(dp):
        s_flat = torch.cat([all_s[(dpi, s)] for s in range(nsh)], dim=1)
        i_flat = torch.cat([all_i[(dpi, s)] for s in range(nsh)], dim=1)
        ts, pos = top_k_first(s_flat, k)
        out_s.append(ts)
        out_i.append(torch.gather(i_flat, 1, pos))
    return torch.cat(out_s), torch.cat(out_i)


def sharded_flat_topk(q, corpus: Striped, bias: Striped, *, k: int, alpha: float = 1.0,
                      mesh: Mesh, mode: str = "auto", row_scale: Striped | None = None):
    """q: [B, D] (B a multiple of dp; the same on every process), split
    over dp; corpus: [N, D] striped over shard; bias: [N] striped;
    row_scale: optional [N] per-row dequant factors (per-vector int8),
    striped. Returns (scores [B, k], global idx [B, k]) on the mesh's
    device, the same on every process."""
    n_local = corpus.rows
    dp = mesh.shape["dp"]
    b = q.shape[0]
    if b % dp:
        raise ValueError(f"{b} queries do not split over dp={dp}")
    bl = b // dp
    local = {}
    for dpi, s, dev in mesh.owned:
        qb = _as_tensor(q[dpi * bl:(dpi + 1) * bl], dev)
        rs = row_scale.part(dpi, s) if row_scale is not None else None
        ts, ti = T.flat_search(qb, corpus.part(dpi, s), bias.part(dpi, s),
                               k=min(k, n_local), alpha=alpha, mode=mode, row_scale=rs)
        ts, ti = _pad_local(ts, ti, k)
        local[(dpi, s)] = (ts, ti + s * n_local)
    return _merge_local_topk(local, k, mesh)


def sharded_kmeans(x: Striped, centroids, valid: Striped, scales: Striped | None = None,
                   *, mesh: Mesh, iters: int = 1) -> torch.Tensor:
    """`iters` data-parallel Lloyd iterations: x [N, D] striped (any
    storage dtype; scored in f32); centroids [K, D] f32, the same on
    every process; valid [N] bool; scales: optional [N] per-row dequant
    factors (int8 corpora). Every row is summed once: of the dp copies of
    a stripe, copy j takes the j-th of dp row ranges. Returns the new
    centroids on the mesh's device (the same on every process). An empty
    cluster keeps its centroid."""
    dp = mesh.shape["dp"]
    c = _as_tensor(centroids, mesh.device).float()
    k = c.shape[0]
    rows = x.rows
    for _ in range(iters):
        partial = []
        for dpi, s, dev in mesh.owned:
            lo, hi = dpi * rows // dp, (dpi + 1) * rows // dp
            cd = c.to(dev)
            cn = torch.sum(cd * cd, dim=1)
            counts = torch.zeros(k, dtype=torch.float32, device=dev)
            sums = torch.zeros((k, cd.shape[1]), dtype=torch.float32, device=dev)
            xp, vp = x.part(dpi, s), valid.part(dpi, s)
            sp = scales.part(dpi, s) if scales is not None else None
            for a in range(lo, hi, KMEANS_CHUNK):
                e = min(hi, a + KMEANS_CHUNK)
                xl = xp[a:e].float()
                if sp is not None:  # dequantize int8 rows into true space
                    xl = xl * sp[a:e, None]
                d2 = (torch.sum(xl * xl, dim=1, keepdim=True) - 2.0 * torch.mm(xl, cd.t())
                      + cn[None, :])
                assign = torch.argmin(d2, dim=1)
                w = vp[a:e].float()
                counts.index_add_(0, assign, w)
                sums.index_add_(0, assign, xl * w[:, None])
            partial.append((counts, sums))
        # local sum over the owned cells, then one all-reduce (the psum)
        counts = torch.stack([p[0].to(mesh.device) for p in partial]).sum(dim=0)
        sums = torch.stack([p[1].to(mesh.device) for p in partial]).sum(dim=0)
        packed = mesh.all_reduce_sum(torch.cat([counts[:, None], sums], dim=1))
        counts, sums = packed[:, 0], packed[:, 1:]
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1.0)[:, None], c)
    return c


def sharded_kmeans_step(x, centroids, valid, scales=None, *, mesh):
    """One Lloyd iteration (callers that drive their own loop)."""
    return sharded_kmeans(x, centroids, valid, scales, mesh=mesh, iters=1)


def state_vectors_f32(d: dict) -> np.ndarray:
    """Storage-space f32 rows from a sharded index state dict: int8
    states carry raw codes + per-row scales (dequantized here; the upsert
    path re-quantizes to the identical codes/scales), bf16/f32 states
    upcast directly (a `BF16Array` and an `ml_dtypes` array both widen
    exactly)."""
    vecs = d["vectors"]
    if getattr(vecs, "dtype", None) == np.int8:
        return vecs.astype(np.float32) * np.asarray(d["scales"], np.float32)[:, None]
    return np.asarray(vecs, np.float32)


def _vectors_to_numpy(t: torch.Tensor):
    """Stored rows on the host: bf16 as the bits in a BF16Array."""
    if t.dtype != torch.bfloat16:
        return t.cpu().numpy()
    return BF16Array(t.view(torch.int16).cpu().numpy())


class ShardedFlatIndex:
    """Flat exact kNN over a mesh-striped corpus.

    The multi-device counterpart of vector.FlatVectorIndex: same metric
    and result semantics, corpus rows striped over the "shard" axis.
    Inserts water-fill the stripes so they stay balanced. Slot numbers are
    global: slot s lives on shard s // rows_per_shard, so the layout is
    [shard0 rows | shard1 rows | ...] and each shard fills its own region.

    The stripes are written in place (upsert, delete); growth and
    compaction allocate new tensors, so references captured before them
    stay whole."""

    index_type = "sharded_flat"

    def __init__(self, dims: int, mesh: Mesh, metric: str = "cosine", dtype: str = "float32"):
        from ..vector.filters import FilterColumns
        from ..vector.flat import _METRIC_ALIASES

        self.metric = _METRIC_ALIASES[metric]
        self.mesh = mesh
        self.dims = dims
        self.d_pad = round_up(max(dims, 128), 128)
        self.dtype = {
            "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
        }[dtype]
        self.nsh = shard_count(mesh)
        self.block = ROW_BLOCK * self.nsh  # capacity granularity
        self.capacity = 0
        self.vectors: Striped | None = None  # [cap, d_pad] striped over shard
        self.valid: Striped | None = None  # [cap] bool
        self.sq_norms: Striped | None = None  # [cap] f32
        self.scales: Striped | None = None  # [cap] f32 per-row dequant factors (int8 only)
        self._slot_pks = np.empty(0, dtype=object)
        self._pk_slot: dict = {}
        # per-shard next free position (water-fill keeps stripes even)
        self._shard_fill = np.zeros(self.nsh, np.int64)
        self.deleted_count = 0
        # the predicate columns live whole on the mesh's own device; a
        # search copies the stripes of the [capacity] mask out to the cells
        self.filter_columns = FilterColumns(mesh.device)

    def __len__(self):
        return len(self._pk_slot)

    @property
    def device(self) -> torch.device:
        """Where slot masks and filter columns live."""
        return self.mesh.device

    def _rows_per_shard(self):
        return self.capacity // self.nsh if self.capacity else 0

    def _ensure_capacity(self, per_shard_needed: int):
        rps = self._rows_per_shard()
        if per_shard_needed <= rps:
            return
        new_rps = max(ROW_BLOCK, round_up(per_shard_needed, ROW_BLOCK))
        new_cap = new_rps * self.nsh
        vec = Striped.full(self.mesh, new_rps, (self.d_pad,), 0, self.dtype)
        val = Striped.full(self.mesh, new_rps, (), False, torch.bool)
        nrm = Striped.full(self.mesh, new_rps, (), 0.0, torch.float32)
        scl = (Striped.full(self.mesh, new_rps, (), 1.0, torch.float32)
               if self.dtype == torch.int8 else None)
        if self.capacity:
            # re-stripe: every shard's used region moves to the head of its
            # new, longer stripe (cell-local copies)
            old_rps = rps
            pairs = [(vec, self.vectors), (val, self.valid), (nrm, self.sq_norms)]
            if scl is not None:
                pairs.append((scl, self.scales))
            for dpi, s, _ in self.mesh.owned:
                n_used = int(self._shard_fill[s])
                if n_used:
                    for new, old in pairs:
                        new.part(dpi, s)[:n_used] = old.part(dpi, s)[:n_used]
            pks = np.empty(new_cap, dtype=object)
            moves = [(s * old_rps, s * new_rps, int(self._shard_fill[s]))
                     for s in range(self.nsh)]
            for src, dst, n_used in moves:
                pks[dst:dst + n_used] = self._slot_pks[src:src + n_used]
            self._slot_pks = pks
            # the predicate columns are slot-aligned: they move with the rows
            # (the JAX package leaves them behind, ROADMAP.md queue 3)
            for name in self.filter_columns.names():
                self.filter_columns.ensure(name, self.capacity)
            self.filter_columns.move_ranges(moves, new_cap)
            self._pk_slot = {pk: j for j, pk in enumerate(pks) if pk is not None}
        else:
            self._slot_pks = np.empty(new_cap, dtype=object)
        self.vectors, self.valid, self.sq_norms = vec, val, nrm
        self.scales = scl
        self.capacity = new_cap

    @staticmethod
    def _balanced_take(fills: np.ndarray, k: int) -> np.ndarray:
        """How many new rows each shard receives so stripes water-fill to
        an even level (the vectorized equivalent of k argmin round-robin
        steps)."""
        take = np.zeros(len(fills), np.int64)
        if k <= 0:
            return take
        f = fills.astype(np.int64)
        lo, hi = int(f.min()), int(f.max()) + k
        while lo < hi:  # smallest level L with sum(max(0, L - f)) >= k
            mid = (lo + hi) // 2
            if int(np.maximum(mid - f, 0).sum()) >= k:
                hi = mid
            else:
                lo = mid + 1
        take = np.maximum(lo - f, 0)
        excess = int(take.sum()) - k
        if excess > 0:
            raised = np.flatnonzero(take > 0)
            take[raised[-excess:]] -= 1
        return take

    def _write_rows(self, slots: np.ndarray, x: np.ndarray):
        """vectors[slots] = x (host f32 rows or int8 codes), staged in
        chunks and cast to the stored type on the cell."""
        chunk = max(1, _UPLOAD_BYTES // max(1, x.shape[1] * x.dtype.itemsize))
        for off in range(0, len(slots), chunk):
            self.vectors.scatter(slots[off:off + chunk], x[off:off + chunk])

    def upsert(self, pks, raw: np.ndarray, _prepped: np.ndarray | None = None):
        if _prepped is not None:  # already normalized + padded storage rows
            x = np.asarray(_prepped, np.float32)
        else:
            x = np.asarray(raw, np.float32)
            if self.metric == "cosine":
                x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            if self.d_pad != x.shape[1]:
                x = np.pad(x, ((0, 0), (0, self.d_pad - x.shape[1])))
        pks = list(pks)
        # assign slots: existing pks keep theirs; new ones water-fill the
        # shard stripes (duplicates within the batch reuse the first
        # occurrence's slot)
        seen = set(self._pk_slot)
        new_count = 0
        for pk in pks:
            if pk not in seen:
                new_count += 1
                seen.add(pk)
        max_fill = int(self._shard_fill.max()) + (new_count // self.nsh + 1)
        self._ensure_capacity(max_fill)
        rps = self._rows_per_shard()
        take = self._balanced_take(self._shard_fill, new_count)
        new_slots = iter(
            np.concatenate([
                s * rps + self._shard_fill[s] + np.arange(take[s])
                for s in range(self.nsh)
            ]).tolist() if new_count else ()
        )
        self._shard_fill += take
        slots = np.empty(len(pks), np.int64)
        for j, pk in enumerate(pks):
            slot = self._pk_slot.get(pk)
            if slot is None:
                slot = next(new_slots)
                self._pk_slot[pk] = slot
                self._slot_pks[slot] = pk
            slots[j] = slot
        if self.dtype == torch.int8:
            enc, dq = quantize_int8(x)
            self._write_rows(slots, enc)
            self.scales.scatter(slots, dq)
            deq = enc.astype(np.float32) * dq[:, None]
            self.sq_norms.scatter(slots, np.sum(deq * deq, axis=1))
        else:
            self._write_rows(slots, x)
            self.sq_norms.scatter(slots, np.sum(x * x, axis=1))
        self.valid.scatter(slots, True)
        return slots

    def delete(self, pks) -> int:
        slots = [self._pk_slot.pop(pk, None) for pk in pks]
        slots = [s for s in slots if s is not None]
        for s in slots:
            self._slot_pks[s] = None
        if not slots:
            return 0
        self.valid.scatter(np.asarray(slots, np.int64), False)
        self.deleted_count += len(slots)
        return len(slots)

    # engine duck-type parity with FlatVectorIndex/IVFVectorIndex ---------

    @property
    def corpus(self):
        """The engine addresses `idx.corpus` for slot/pk/filter machinery;
        the sharded index owns its slots, so it is its own corpus."""
        return self

    @property
    def precision(self) -> str:
        if self.dtype == torch.int8:
            return "int8"
        return "bfloat16" if self.dtype == torch.bfloat16 else "float32"

    @property
    def deleted_ratio(self) -> float:
        used = len(self._pk_slot) + self.deleted_count
        return self.deleted_count / used if used else 0.0

    def slots_for_pks(self, pks) -> np.ndarray:
        return np.asarray([self._pk_slot.get(pk, -1) for pk in pks], np.int64)

    def _rows_f32(self, slots: np.ndarray) -> np.ndarray:
        """Storage-space f32 rows at the given slots, on the host (int8
        rows dequantized: rows handed to `upsert(_prepped=)` must be TRUE
        storage-space values, or re-quantization resets the scales)."""
        vecs = self.vectors.gather(slots).float().cpu().numpy()
        if self.dtype == torch.int8:
            vecs = vecs * self.scales.gather(slots).cpu().numpy()[:, None]
        return vecs

    def compact(self):
        """Re-stripe live rows evenly across shards (one gather pass)."""
        live_pks = list(self._pk_slot)
        if not live_pks:
            self.__init__(self.dims, self.mesh, self.metric, self.precision)
            return
        slots = self.slots_for_pks(live_pks)
        vecs = self._rows_f32(slots)
        fcols = self.filter_columns.gather_host(slots)
        metric, mesh, dims, prec = self.metric, self.mesh, self.dims, self.precision
        self.__init__(dims, mesh, metric, prec)
        # vectors are already normalized/padded in storage space: bypass
        # upsert's prep by writing through the raw path
        new_slots = self.upsert(live_pks, vecs[:, :dims], _prepped=vecs)
        self.filter_columns.scatter(fcols, new_slots, self.capacity)
        self.deleted_count = 0

    def maybe_compact(self, ratio_threshold: float = 0.10):
        if self.deleted_ratio >= ratio_threshold and self.deleted_count > 0:
            self.compact()
            return True
        return False

    def state_dict(self) -> dict:
        """The JAX package's snapshot format: live rows in STORAGE dtype
        (bf16 at 2 B/dim as a BF16Array, int8 at 1 B/dim with its per-row
        scales beside it), so that either package opens the other's."""
        live_pks = list(self._pk_slot)
        slots = self.slots_for_pks(live_pks)
        scales_out = None
        if live_pks:
            vecs = _vectors_to_numpy(self.vectors.gather(slots))
            if self.dtype == torch.int8:
                scales_out = self.scales.gather(slots).cpu().numpy()
        else:
            vecs = np.zeros((0, self.d_pad), np.float32)
        return {
            "type": "sharded_flat",
            "metric": self.metric,
            "dims": self.dims,
            "precision": self.precision,
            "vectors": vecs,
            "scales": scales_out,
            "pks": live_pks,
            "filter_columns": self.filter_columns.gather_host(slots)
            if live_pks
            else {},
        }

    @staticmethod
    def from_state_dict(d: dict, mesh) -> "ShardedFlatIndex":
        idx = ShardedFlatIndex(d["dims"], mesh, d["metric"], d["precision"])
        if d["pks"]:
            vecs = state_vectors_f32(d)
            slots = idx.upsert(d["pks"], vecs[:, : d["dims"]], _prepped=vecs)
            idx.filter_columns.scatter(d.get("filter_columns", {}), slots, idx.capacity)
        return idx

    def search(self, q, top_k: int = 10, threshold=None, slot_mask=None, **kw):
        """kw (e.g. nprobe) forwards to the subclass's search_arrays."""
        dist, pks = self.search_arrays(q, top_k, slot_mask=slot_mask, **kw)
        return hits_of(self.metric, dist[0], np.not_equal(pks[0], None), pks[0], threshold)

    # --- search helpers shared with the IVF subclass -------------------------

    def _prep_queries(self, q):
        """(qx [b_pad, d_pad] f32 rows padded to a multiple of dp, on the
        mesh's device; qsq [b] squared norms of the raw queries, on the
        host; b)."""
        qx = np.asarray(q, np.float32)
        if qx.ndim == 1:
            qx = qx[None]
        qsq = np.sum(qx * qx, axis=1)
        if self.metric == "cosine":
            qx = qx / np.maximum(np.linalg.norm(qx, axis=1, keepdims=True), 1e-12)
        if self.d_pad != qx.shape[1]:
            qx = np.pad(qx, ((0, 0), (0, self.d_pad - qx.shape[1])))
        dp = self.mesh.shape["dp"]
        b = qx.shape[0]
        b_pad = round_up(b, dp)
        if b_pad != b:
            qx = np.pad(qx, ((0, b_pad - b), (0, 0)))
        return replicated_from_host(qx, self.mesh), qsq, b

    def _masked_valid(self, slot_mask) -> Striped:
        """valid AND the [capacity] slot mask, stripe by stripe."""
        if slot_mask is None:
            return self.valid
        mask = slot_mask if isinstance(slot_mask, torch.Tensor) \
            else torch.from_numpy(np.asarray(slot_mask, np.bool_))
        rps = self._rows_per_shard()
        return Striped(self.mesh, {
            (dpi, s): self.valid.part(dpi, s) & mask[s * rps:(s + 1) * rps].to(dev)
            for dpi, s, dev in self.mesh.owned})

    def _results(self, scores, idx, qsq, b):
        """Device (scores, global slots) -> (distances [b, k], pks [b, k])
        on the host; a miss (score <= NEG_INF / 2) is inf / None."""
        scores = scores.cpu().numpy()[:b]
        idx_np = idx.cpu().numpy().astype(np.int64)[:b]
        dists = D.scores_to_distances_np(self.metric, scores, qsq)
        miss = scores <= NEG_INF / 2
        dists[miss] = np.inf
        pks = pks_at(self._slot_pks, self.capacity, idx_np)
        pks[miss] = None
        return dists, pks

    def search_arrays(self, q, k: int, slot_mask=None, mode: str = "auto"):
        """Batch search: (distances [B, k] f32, pks [B, k] object)."""
        if self.capacity == 0 or len(self) == 0:
            b = 1 if np.asarray(q).ndim == 1 else np.asarray(q).shape[0]
            return (
                np.full((b, k), np.inf, np.float32),
                np.full((b, k), None, dtype=object),
            )
        qx, qsq, b = self._prep_queries(q)
        valid = self._masked_valid(slot_mask)
        l2 = self.metric == "l2"
        bias = Striped(self.mesh, {
            key: D.make_bias(self.metric, self.sq_norms.parts[key] if l2 else None, v)
            for key, v in valid.parts.items()})
        scores, idx = sharded_flat_topk(
            qx, self.vectors, bias, k=k, alpha=D.metric_alpha(self.metric), mesh=self.mesh,
            mode=mode, row_scale=self.scales,
        )
        return self._results(scores, idx, qsq, b)
