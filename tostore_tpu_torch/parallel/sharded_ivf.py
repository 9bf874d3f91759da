"""ShardedIVFIndex: IVF over a mesh-striped corpus (counterpart of
`tostore_tpu/parallel/sharded_ivf.py`).

The multi-device ANN path: centroids are trained data-parallel (Lloyd
with an all-reduce, sharded.py) and replicated; every shard keeps its OWN
bucket table over its corpus stripe (bucket entries are shard-local row
positions, so probe gathers never leave the cell). A query goes to all
shards, each probes the same nprobe slices within its stripe, scans
locally, and the per-shard top-k candidates merge after one gather: the
communication shape of the sharded flat scan, with nprobe/C of the work.

Each shard also keeps the bucket-CONTIGUOUS stripe layouts of the
single-device index (vector blocks [C_exp, cap, Dp], nibble-packable ADC
codes [C_exp, M', cap]), so the bucket-scan kernels of ops/ivfprobe.py
(K3 `bucket_probe_scores`, K4 `adc_bucket_scores`) run unchanged on every
cell; the gather probes in plain PyTorch remain as the over-budget
fallback. Every cell runs the single-device index's probe
(vector/ivf.py `_ivf_probe`) over its stripe, so a cell computes what a
single-device index over its stripe would.

Layout tensors are `Striped` over the shard axis with C_exp rows a
stripe: row `shard * C_exp + slice` of the JAX package's global arrays is
row `slice` of that shard's part.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.runtime import NEG_INF, round_up
from ..vector.ivf import (
    IVFVectorIndex,
    ProbeIndex,
    _bucket_bias,
    _CountOnly,
    _ivf_assign_device,
    _ivf_place_sliced,
    _ivf_probe,
    _neg_sq_norms_rows,
    auto_num_clusters,
)
from ..vector.pq import PQCodebook, pq_encode, train_pq
from .mesh import Mesh, Replicated, Striped, read_to_host, shard_count
from .sharded import (
    ShardedFlatIndex,
    _as_tensor,
    _merge_local_topk,
    _pad_local,
    sharded_kmeans,
    state_vectors_f32,
)

# rows of a stripe encoded at once by _reencode_all (bounds the f32 copy)
ENCODE_CHUNK = 65536


def _sharded_ivf_assign(vectors: Striped, valid: Striped, centroids: Replicated,
                        scales: Striped | None, *, chunk: int, l2: bool, mesh: Mesh):
    """Per-shard nearest-centroid assignment. Returns (assign [capT] int64
    striped, counts [nsh, C] per-shard first-choice bincounts, on the
    mesh's device and the same on every process: the host sizes the slice
    layout from them)."""
    assign, counts = {}, {}
    for dpi, s, dev in mesh.owned:
        choices, cts = _ivf_assign_device(
            vectors.part(dpi, s), valid.part(dpi, s), centroids.on(dev),
            scales.part(dpi, s) if scales is not None else None, chunk=chunk, l2=l2)
        assign[(dpi, s)] = choices
        counts[(dpi, s)] = cts
    every = mesh.all_gather_cells(counts)
    return Striped(mesh, assign), torch.stack([every[(0, s)] for s in range(shard_count(mesh))])


def _sharded_ivf_place(assign: Striped, valid: Striped, base: Replicated, vectors: Striped,
                       sq_norms: Striped, scales: Striped | None, *, cap: int, c_exp: int,
                       with_vectors: bool, bias_l2: bool, mesh: Mesh):
    """Per-shard sliced placement (vector/ivf.py `_ivf_place_sliced`)
    together with the bucket-contiguous stripe build: the slice layout
    (base, c_exp, cap) is shared across shards, sized from the per-cluster
    MAX shard-local count, so every shard's rows fit in its own copy of
    the rectangles. Bucket entries are shard-local row positions.

    Returns (buckets [nsh*c_exp, cap] striped, slice_counts [nsh, c_exp]
    on the mesh's device, slot_slice [capT] striped (each row's LOCAL
    slice id), slot_pos [capT] striped, bucket_bias [nsh*c_exp, cap]
    (validity NEG_INF + folded l2 norms), the contiguous per-shard vector
    copy [nsh*c_exp, cap, Dp] or None, and with int8 rows the per-row
    dequant factors [nsh*c_exp, cap] or None)."""
    bk, ssl, spos, cts, bb, bv, bs = {}, {}, {}, {}, {}, {}, {}
    for dpi, s, dev in mesh.owned:
        key = (dpi, s)
        vl = vectors.part(dpi, s)
        buckets, slot_slice, slot_pos, scounts = _ivf_place_sliced(
            assign.part(dpi, s), valid.part(dpi, s), base.on(dev), cap=cap, c_exp=c_exp)
        safe = torch.clamp(buckets, min=0)
        bvec = vl[safe] if with_vectors else None
        # placement only admits valid rows; the l2 norms come from the
        # contiguous copy's own stored rows (consistent with the scores K3
        # computes from them), except for int8, whose dequantized norms are
        # the stored sq_norms
        if not bias_l2:
            base_b = torch.zeros(buckets.shape, dtype=torch.float32, device=dev)
        elif with_vectors and vl.dtype != torch.int8:
            base_b = _neg_sq_norms_rows(bvec)
        else:
            base_b = -sq_norms.part(dpi, s)[safe]
        bk[key], ssl[key], spos[key], cts[key] = buckets, slot_slice, slot_pos, scounts
        bb[key] = torch.where(buckets >= 0, base_b, torch.full_like(base_b, NEG_INF))
        if with_vectors:
            bv[key] = bvec
            if scales is not None:
                bs[key] = scales.part(dpi, s)[safe]
    every = mesh.all_gather_cells(cts)
    counts = torch.stack([every[(0, s)] for s in range(shard_count(mesh))])
    return (Striped(mesh, bk), counts, Striped(mesh, ssl), Striped(mesh, spos),
            Striped(mesh, bb), Striped(mesh, bv) if bv else None,
            Striped(mesh, bs) if bs else None)


def _sharded_bucket_bias(buckets: Striped, valid: Striped, sq_norms: Striped, *, l2: bool,
                         mesh: Mesh) -> Striped:
    """Rebuild the per-shard bucket bias from current validity (the
    post-delete refresh). [nsh*c_exp, cap] f32."""
    return Striped(mesh, {
        key: _bucket_bias(bk, valid.parts[key], sq_norms.parts[key], l2=l2)
        for key, bk in buckets.parts.items()})


def _sharded_bucket_codes(codes: Striped, buckets: Striped, *, mesh: Mesh) -> Striped:
    """Per-shard bucket-contiguous code stripes for the ADC kernel:
    codes [capT, M'] u8 striped -> [nsh*c_exp, M', cap] striped."""
    return Striped(mesh, {
        key: codes.parts[key][torch.clamp(bk, min=0)].permute(0, 2, 1).contiguous()
        for key, bk in buckets.parts.items()})


def _run_probe(q, k: int, rps: int, mesh: Mesh, body):
    """Run `body(dp index, shard, device, qb)` -> (scores [Bl, kk], local
    positions [Bl, kk]) on every owned cell with its dp slice of q, turn
    the positions into global slots, pad to k and merge."""
    dp = mesh.shape["dp"]
    bl = q.shape[0] // dp
    local = {}
    for dpi, s, dev in mesh.owned:
        qb = _as_tensor(q[dpi * bl:(dpi + 1) * bl], dev)
        ts, pos = body(dpi, s, dev, qb)
        ts, gl = _pad_local(ts, pos + s * rps, k)
        local[(dpi, s)] = (ts, gl)
    return _merge_local_topk(local, k, mesh)


class ShardedIVFIndex(ShardedFlatIndex):
    """IVF over the striped corpus of ShardedFlatIndex. Falls back to the
    flat sharded scan until trained (same tiny-corpus behavior as the
    single-device IVFVectorIndex). With `pq_subspaces`, each shard keeps
    residual-PQ codes of its stripe (IVFADC; same semantics as the
    single-device index)."""

    index_type = "sharded_ivf"
    BALANCE_FACTOR = 2.0
    # per-shard budget for the bucket-contiguous raw-vector stripe (each
    # cell holds only its own stripe, so the bound is per device)
    CONTIG_MAX_BYTES = 6 << 30

    def __init__(self, dims, mesh, metric="cosine", dtype="float32",
                 num_clusters: int = 0, nprobe: int = 8,
                 min_train_size: int = 4096, pq_subspaces: int = 0,
                 pq_centroids: int = 0, rerank_factor: int = 2,
                 pq_rerank: int = 0):
        super().__init__(dims, mesh, metric, dtype)
        self.num_clusters_cfg = num_clusters
        self.nprobe = nprobe
        self.min_train_size = min_train_size
        self.pq_subspaces = pq_subspaces
        self.pq_centroids = pq_centroids
        self.rerank_factor = rerank_factor
        self.pq_rerank = pq_rerank  # 0 = auto max(rerank_factor*k, 51k, 512)
        self.pq: PQCodebook | None = None  # on the mesh's device (small)
        self._pq_rep = None  # (codebook object, its Replicated codebooks)
        self.codes: Striped | None = None  # [capT, M] u8
        self.slot_slice: Striped | None = None  # [capT] local slice id
        self.slot_pos: Striped | None = None  # [capT] position in slice
        self.centroids: Replicated | None = None  # [C, Dp]
        # per-shard bucket-contiguous stripes (the layout K3 / K4 scan; the
        # single-device index's shapes with the leading axis
        # shard-expanded: vectors [nsh*C_exp, cap, Dp], bias/scales
        # [nsh*C_exp, cap], codes [nsh*C_exp, M', cap])
        self.bucket_vectors: Striped | None = None
        self.bucket_bias: Striped | None = None
        self.bucket_scales: Striped | None = None
        self.bucket_codes: Striped | None = None
        self._bias_stale = False  # deletes invalidate the cached bias
        self._mutations = 0  # staleness check for off-lock rebuilds
        # engine-owned indexes defer the 4x-growth retrain + tombstone
        # compaction to background maintenance (run_vector_maintenance
        # capture/build/install: multi-second mesh rebuilds must not stall
        # the write path)
        self.defer_retrain = False
        # sliced layout (shared across shards; see ivf._ivf_place_sliced):
        # cluster c owns slices base[c]..base[c]+nsl[c]-1, sized from the
        # per-cluster MAX shard-local count so every stripe fits
        self.centroids_exp: Replicated | None = None  # [C_exp, Dp]
        self.slice_bias: Replicated | None = None  # [C_exp]
        self._slice_cluster_dev: Replicated | None = None  # [C_exp] -> c (0 on padding)
        self._slice_cluster: np.ndarray | None = None  # host [C_exp] -> c
        self._slice_base: np.ndarray | None = None  # host [C]
        self._slice_count: np.ndarray | None = None  # host [C]
        self.buckets: Striped | None = None  # [nsh*C_exp, cap] local pos
        self._bucket_counts: np.ndarray | None = None  # host [nsh, C_exp]
        self._trained_size = 0

    @property
    def trained(self) -> bool:
        return self.centroids is not None

    def _codebooks(self) -> Replicated:
        """The PQ codebooks on every owned device, cached per codebook."""
        if self._pq_rep is None or self._pq_rep[0] is not self.pq:
            self._pq_rep = (self.pq, Replicated(self.mesh, self.pq.codebooks))
        return self._pq_rep[1]

    # --- training ----------------------------------------------------------

    def _live_slots(self) -> np.ndarray:
        """Live slot ids from the device validity mask (a bool readback
        beats an object-array scan, and lets shadow indexes train without a
        pk map: see the capture path)."""
        if self.capacity == 0:
            return np.zeros(0, np.int64)
        return np.flatnonzero(read_to_host(self.valid))

    def _rows_true_f32(self, slots: np.ndarray) -> torch.Tensor:
        """True-space f32 rows (int8 dequantized) at the given slots, on
        the mesh's device."""
        x = self.vectors.gather(slots).float()
        if self.scales is not None:
            x = x * self.scales.gather(slots)[:, None]
        return x

    def train(self, force: bool = False):
        n = len(self)
        if n < 1 or (self.trained and not force):
            return False
        num_c = self.num_clusters_cfg or auto_num_clusters(n)
        rng = np.random.default_rng(42)
        live = self._live_slots()
        slots = (
            live if len(live) <= 65536
            else rng.choice(live, 65536, replace=False)
        )
        x = self._rows_true_f32(slots)
        num_c = min(num_c, len(slots))
        init = rng.choice(len(slots), num_c, replace=False)
        cents = x[torch.from_numpy(init).to(x.device)]
        # data-parallel Lloyd over the FULL sharded corpus
        cents = sharded_kmeans(
            self.vectors, cents, self.valid, self.scales, mesh=self.mesh, iters=10,
        )
        self.centroids = Replicated(self.mesh, cents.contiguous())
        self._trained_size = n
        self.pq = None  # stale codebooks must not encode the new layout
        self._rebuild_buckets()
        if self.pq_subspaces:
            # residual sample vs each row's PLACEMENT slice centroid
            sl = self.slot_slice.gather(slots).cpu().numpy()
            cents_np = self.centroids_exp.numpy()[:, : self.dims]
            xs = x.cpu().numpy()[:, : self.dims] - cents_np[np.maximum(sl, 0)]
            self.pq = train_pq(xs, m=self.pq_subspaces, k=self._resolve_pq_k(),
                               device=self.mesh.device)
            self._reencode_all()
        return True

    def _reencode_all(self):
        """Residual-encode every stripe (cell-local: elementwise work and
        gathers from replicated values, no collectives), then refresh the
        contiguous code copy."""
        if self.capacity == 0:
            self.codes = None
            self.bucket_codes = None
            return
        books = self._codebooks()
        parts = {}
        for dpi, s, dev in self.mesh.owned:
            vp = self.vectors.part(dpi, s)
            sp = self.scales.part(dpi, s) if self.scales is not None else None
            sl = torch.clamp(self.slot_slice.part(dpi, s), min=0)
            cexp = self.centroids_exp.on(dev)
            out = torch.empty((vp.shape[0], self.pq.m), dtype=torch.uint8, device=dev)
            for a in range(0, vp.shape[0], ENCODE_CHUNK):
                v = vp[a:a + ENCODE_CHUNK].float()
                if sp is not None:
                    v = v * sp[a:a + ENCODE_CHUNK, None]
                v = v[:, : self.dims] - cexp[sl[a:a + ENCODE_CHUNK], : self.dims]
                out[a:a + ENCODE_CHUNK] = pq_encode(books.on(dev), v)
            parts[(dpi, s)] = out
        self.codes = Striped(self.mesh, parts)
        self._refresh_bucket_codes()

    def _resolve_pq_k(self) -> int:
        """Same auto rule as the single-device index (ivf.py): K=16
        nibble-packed when M%16==0, else K=256."""
        if self.pq_centroids:
            return self.pq_centroids
        return 16 if self.pq_subspaces % 16 == 0 else 256

    @property
    def _pack_nibbles(self) -> bool:
        """4-bit codebooks pack two subspace codes per byte in the
        contiguous layout (same rule as the single-device index)."""
        return (
            self.pq is not None
            and self.pq.k == 16
            and self.pq.m % 2 == 0
            and (self.pq.m * self.pq.k) % 256 == 0
        )

    def _refresh_bucket_codes(self):
        from ..ops.ivfprobe import adc_kernel_supported

        if self.codes is None or self.buckets is None:
            self.bucket_codes = None
            return
        if not adc_kernel_supported(self.pq.m, self.pq.k):
            self.bucket_codes = None  # gather ADC path instead
            return
        codes = (
            self.codes.map(IVFVectorIndex._pack_codes)
            if self._pack_nibbles else self.codes
        )
        self.bucket_codes = _sharded_bucket_codes(codes, self.buckets, mesh=self.mesh)

    def _maybe_retrain(self) -> bool:
        """Returns True when a (re)train ran: train() ends in
        _rebuild_buckets(), which already places every live slot, so the
        caller must NOT append the same batch again. The initial train is
        always inline (the index cannot probe without it); the 4x-growth
        retrain defers to background maintenance when the engine owns the
        index (defer_retrain)."""
        n = len(self)
        if not self.trained:
            if n >= self.min_train_size:
                return self.train()
        elif n >= 4 * max(self._trained_size, 1) and not self.defer_retrain:
            return self.train(force=True)
        return False

    def needs_retrain(self) -> bool:
        return self.trained and len(self) >= 4 * max(self._trained_size, 1)

    # --- background (off-lock) maintenance -------------------------------
    #
    # Same protocol as vector.ivf.IVFVectorIndex (capture under the engine
    # lock -> build with no lock -> install if `_mutations` unchanged). The
    # JAX package relies on its arrays being immutable; here the stripes
    # are written in place, so they are NOT cloned and a build may read
    # rows written after the capture. Such a shadow is never installed:
    # every write through this index bumps `_mutations` first and install
    # refuses a changed count. (Cloning would double the corpus's memory.)

    _LAYOUT_ATTRS = (
        "centroids", "centroids_exp", "slice_bias", "_slice_cluster_dev", "_slice_cluster",
        "_slice_base", "_slice_count", "buckets", "_bucket_counts",
        "slot_slice", "slot_pos", "bucket_vectors", "bucket_bias",
        "bucket_scales", "bucket_codes", "pq", "codes", "_trained_size",
        "_bias_stale",
    )

    def capture_build_state(self) -> dict:
        return {
            "mutations": self._mutations,
            "vectors": self.vectors,
            "valid": self.valid,
            "sq_norms": self.sq_norms,
            "scales": self.scales,
            "capacity": self.capacity,
            "live": len(self),
        }

    def build_retrained(self, cap: dict) -> "ShardedIVFIndex":
        shadow = self._shadow()
        shadow.vectors = cap["vectors"]
        shadow.valid = cap["valid"]
        shadow.sq_norms = cap["sq_norms"]
        shadow.scales = cap["scales"]
        shadow.capacity = cap["capacity"]
        shadow._pk_slot = _CountOnly(cap["live"])  # train only needs len()
        shadow.train(force=True)
        return shadow

    def install_retrained(self, cap: dict, shadow: "ShardedIVFIndex") -> bool:
        if self._mutations != cap["mutations"] or not shadow.trained:
            return False
        for attr in self._LAYOUT_ATTRS:
            setattr(self, attr, getattr(shadow, attr))
        self._mutations += 1
        return True

    def _shadow(self) -> "ShardedIVFIndex":
        return ShardedIVFIndex(
            self.dims, self.mesh, self.metric, self.precision,
            num_clusters=self.num_clusters_cfg, nprobe=self.nprobe,
            min_train_size=self.min_train_size,
            pq_subspaces=self.pq_subspaces, pq_centroids=self.pq_centroids,
            rerank_factor=self.rerank_factor, pq_rerank=self.pq_rerank,
        )

    def needs_compact(self, ratio_threshold: float = 0.10) -> bool:
        return (
            self.trained
            and self.deleted_count > 0
            and self.deleted_ratio >= ratio_threshold
        )

    def capture_compact_state(self) -> dict:
        from ..vector.filters import FilterColumns

        fc = FilterColumns(self.filter_columns.device)
        fc.columns = dict(self.filter_columns.columns)
        fc.int_columns = dict(self.filter_columns.int_columns)
        return {
            "mutations": self._mutations,
            "vectors": self.vectors,
            "valid": self.valid,
            "scales": self.scales,
            "slot_pks": self._slot_pks.copy(),
            "filters": fc,
            "centroids": self.centroids,
            "trained_size": self._trained_size,
            "pq_book": self.pq,
        }

    def build_compacted(self, cap: dict) -> "ShardedIVFIndex":
        """Re-stripe live rows into a fresh shadow with no lock held (the
        inline compact()'s host readback + re-upsert, off the write path).
        PQ codebooks transfer: slices rebuild from the same centroids, so
        the residual space is unchanged."""
        shadow = self._shadow()
        shadow.min_train_size = 1 << 62  # suppress retrain during refill
        slot_pks = cap["slot_pks"]
        live = np.flatnonzero(
            np.asarray([pk is not None for pk in slot_pks])
        )
        if len(live):
            vecs = cap["vectors"].gather(live).float().cpu().numpy()
            if cap["scales"] is not None:
                vecs = vecs * cap["scales"].gather(live).cpu().numpy()[:, None]
            new_slots = shadow.upsert(
                list(slot_pks[live]), vecs[:, : self.dims], _prepped=vecs
            )
            cols = cap["filters"].gather_host(live)
            shadow.filter_columns.scatter(cols, new_slots, shadow.capacity)
        shadow.min_train_size = self.min_train_size
        shadow.centroids = cap["centroids"]
        shadow._trained_size = cap["trained_size"]
        shadow.pq = cap["pq_book"]
        if shadow.trained:
            shadow._rebuild_buckets()
        return shadow

    _CORPUS_ATTRS = (
        "vectors", "valid", "sq_norms", "scales", "_slot_pks", "_pk_slot",
        "_shard_fill", "capacity", "filter_columns",
    )

    def install_compacted(self, cap: dict, shadow: "ShardedIVFIndex") -> bool:
        if self._mutations != cap["mutations"]:
            return False
        for attr in self._CORPUS_ATTRS:
            setattr(self, attr, getattr(shadow, attr))
        self.deleted_count = 0
        for attr in self._LAYOUT_ATTRS:
            setattr(self, attr, getattr(shadow, attr))
        self._mutations += 1
        return True

    # --- buckets -------------------------------------------------------------

    def _assign(self, slots: np.ndarray) -> np.ndarray:
        """Nearest cluster of each slot's stored row, in f32 (the append
        path's compute type)."""
        out = np.empty(len(slots), np.int64)
        cents = self.centroids.local
        for a in range(0, len(slots), 65536):
            chunk = slots[a : a + 65536]
            s = torch.mm(self._rows_true_f32(chunk), cents.t())
            if self.metric == "l2":
                s = 2.0 * s - torch.sum(cents * cents, dim=1)[None, :]
            out[a : a + len(chunk)] = torch.argmax(s, dim=1).cpu().numpy()
        return out

    def _bucket_cap(self, n_live: int) -> int:
        num_c = self.centroids.shape[0]
        avg_sh = max(1, n_live // max(1, num_c * self.nsh))
        return int(max(64, round_up(int(self.BALANCE_FACTOR * avg_sh) + 1, 64)))

    def _install_slices(self, nsl: np.ndarray) -> int:
        num_c = self.centroids.shape[0]
        total = int(nsl.sum())
        c_exp = int(round_up(max(total, 8), 8))
        sl_cl = np.full(c_exp, -1, np.int64)
        sl_cl[:total] = np.repeat(np.arange(num_c), nsl)
        base = np.zeros(num_c, np.int64)
        base[1:] = np.cumsum(nsl)[:-1]
        self._slice_cluster = sl_cl
        self._slice_base = base
        self._slice_count = nsl.astype(np.int64)
        clamped = torch.from_numpy(np.maximum(sl_cl, 0)).to(self.mesh.device)
        self._slice_cluster_dev = Replicated(self.mesh, clamped)
        self.centroids_exp = Replicated(self.mesh, self.centroids.local[clamped])
        self.slice_bias = Replicated(
            self.mesh, np.where(sl_cl >= 0, 0.0, NEG_INF).astype(np.float32))
        return c_exp

    def _rebuild_buckets(self):
        """Sliced per-shard build: one assignment pass over the mesh, a
        [nsh, C] counts readback to size the shared slice layout, one
        placement pass. No row leaves its nearest cluster."""
        num_c = self.centroids.shape[0]
        rps = self._rows_per_shard()
        n_live = len(self._pk_slot)
        cap = self._bucket_cap(n_live)
        self._bias_stale = False
        if n_live == 0:
            c_exp = self._install_slices(np.ones(num_c, np.int64))
            self.buckets = Striped.full(self.mesh, c_exp, (cap,), -1, torch.int64)
            self._bucket_counts = np.zeros((self.nsh, c_exp), np.int64)
            self.slot_slice = (Striped.full(self.mesh, rps, (), -1, torch.int64)
                               if self.capacity else None)
            self.slot_pos = (Striped.full(self.mesh, rps, (), -1, torch.int64)
                             if self.capacity else None)
            self.codes = None
            self.bucket_vectors = None
            self.bucket_bias = None
            self.bucket_scales = None
            self.bucket_codes = None
            return
        assign, counts = _sharded_ivf_assign(
            self.vectors, self.valid, self.centroids, self.scales,
            chunk=min(65536, rps), l2=(self.metric == "l2"), mesh=self.mesh,
        )
        counts_np = counts.cpu().numpy().astype(np.int64)  # [nsh, C]
        nsl = np.maximum(1, -(-counts_np.max(axis=0) // cap))
        c_exp = self._install_slices(nsl)
        pq_mode = self.pq is not None or self.pq_subspaces
        nbytes = c_exp * cap * self.d_pad * self.vectors.dtype.itemsize
        with_vec = not pq_mode and nbytes <= self.CONTIG_MAX_BYTES
        (self.buckets, scounts, self.slot_slice, self.slot_pos, bbias, bvec,
         bscales) = _sharded_ivf_place(
            assign, self.valid, Replicated(self.mesh, self._slice_base),
            self.vectors, self.sq_norms, self.scales,
            cap=cap, c_exp=c_exp, with_vectors=with_vec,
            bias_l2=(not pq_mode and self.metric == "l2"), mesh=self.mesh,
        )
        self._bucket_counts = scounts.cpu().numpy().astype(np.int64)
        self.bucket_bias = bbias if (with_vec or pq_mode) else None
        self.bucket_vectors = bvec
        self.bucket_scales = bscales
        self.bucket_codes = None
        if self.pq is not None:
            self._reencode_all()

    def _append_to_buckets(self, slots: np.ndarray) -> bool:
        """Incremental append past the high-water mark of each row's
        cluster's slices (shard-local); returns False when a (shard,
        cluster) runs out of slice space (caller rebuilds)."""
        rps = self._rows_per_shard()
        cap = self.buckets.shape[1]
        c_exp = self._slice_cluster.shape[0]
        assign = self._assign(slots)
        sh = slots // rps
        counts = self._bucket_counts  # [nsh, C_exp]
        base, nsl = self._slice_base, self._slice_count
        sl_out = np.full(len(slots), -1, np.int64)  # global bucket rows
        ps_out = np.full(len(slots), -1, np.int64)
        new_counts = counts.copy()
        for s, cl in {(int(a), int(b)) for a, b in zip(sh, assign)}:
            rows = np.flatnonzero((sh == s) & (assign == cl))
            sls = np.arange(base[cl], base[cl] + nsl[cl])
            free = np.maximum(cap - new_counts[s, sls], 0)
            cumfree = np.cumsum(free)
            if not len(cumfree) or cumfree[-1] < len(rows):
                return False
            offs = np.arange(len(rows))
            si = np.searchsorted(cumfree, offs, side="right")
            prev = np.where(si > 0, cumfree[np.maximum(si - 1, 0)], 0)
            sl_ids = sls[si]
            sl_out[rows] = s * c_exp + sl_ids
            ps_out[rows] = new_counts[s, sl_ids] + (offs - prev)
            np.add.at(new_counts[s], sl_ids, 1)
        self._bucket_counts = new_counts
        local_slice = sl_out - sh * c_exp
        # a row's bucket entries live on its own shard: one pass per owned
        # cell writes all of them from that cell's stripe
        books = self._codebooks() if self.pq is not None else None
        for dpi, s, sel, pos in self.vectors.split(slots):
            key = (dpi, s)
            dev = pos.device
            sl = torch.from_numpy(local_slice[sel]).to(dev)
            ps = torch.from_numpy(ps_out[sel]).to(dev)
            self.buckets.parts[key][sl, ps] = pos
            if self.slot_slice is not None:
                self.slot_slice.parts[key][pos] = sl
            if self.slot_pos is not None:
                self.slot_pos.parts[key][pos] = ps
            rows = self.vectors.parts[key][pos]
            if self.bucket_vectors is not None:
                self.bucket_vectors.parts[key][sl, ps] = rows
                self.bucket_bias.parts[key][sl, ps] = (
                    -self.sq_norms.parts[key][pos] if self.metric == "l2" else 0.0)
                if self.bucket_scales is not None:
                    self.bucket_scales.parts[key][sl, ps] = self.scales.parts[key][pos]
            elif self.bucket_bias is not None:  # PQ mode: validity-only bias
                self.bucket_bias.parts[key][sl, ps] = 0.0
            if self.pq is not None:
                v = rows.float()
                if self.scales is not None:
                    v = v * self.scales.parts[key][pos][:, None]
                v = v[:, : self.dims] - self.centroids_exp.on(dev)[sl, : self.dims]
                codes = pq_encode(books.on(dev), v)
                self.codes.parts[key][pos] = codes
                if self.bucket_codes is not None:
                    scatter = (IVFVectorIndex._pack_codes(codes)
                               if self._pack_nibbles else codes)
                    self.bucket_codes.parts[key][sl, :, ps] = scatter
        return True

    def _vacate_slots(self, slots: np.ndarray):
        """Clear overwritten rows' bucket entries (the new vector may
        belong to a different cluster); the caller re-appends them.
        Fill-count holes are reclaimed by the next rebuild/compact,
        mirroring the single-device index."""
        slots = np.asarray(slots)
        slots = slots[slots >= 0]
        if not len(slots) or self.slot_slice is None or self.buckets is None:
            return
        for dpi, s, _, pos in self.slot_slice.split(slots):
            key = (dpi, s)
            sl = self.slot_slice.parts[key][pos]  # local slice ids, -1 = unplaced
            ps = self.slot_pos.parts[key][pos]
            ok = sl >= 0
            pos, sl, ps = pos[ok], sl[ok], ps[ok]
            self.buckets.parts[key][sl, ps] = -1
            if self.bucket_bias is not None:
                self.bucket_bias.parts[key][sl, ps] = NEG_INF
            self.slot_slice.parts[key][pos] = -1
            self.slot_pos.parts[key][pos] = -1

    def upsert(self, pks, raw, _prepped=None):
        self._mutations += 1
        pks = list(pks)
        existing = [pk for pk in pks if pk in self._pk_slot]
        cap_before = self.capacity
        slots = super().upsert(pks, raw, _prepped=_prepped)
        rebuilt = self._maybe_retrain()
        if self.trained and not rebuilt:
            if self.capacity != cap_before:  # re-stripe moved rows
                self._rebuild_buckets()
            else:
                if existing:
                    # vacate overwritten rows' old entries, then place the
                    # whole batch fresh (a full mesh rebuild on every
                    # overwrite would stall streaming-update workloads)
                    self._vacate_slots(self.slots_for_pks(existing))
                if not self._append_to_buckets(np.asarray(slots, np.int64)):
                    self._rebuild_buckets()  # slice overflow: new layout
        return slots

    def delete(self, pks) -> int:
        self._mutations += 1
        n = super().delete(pks)
        if n and self.bucket_bias is not None:
            # the folded validity bias is stale; the next search rebuilds
            # it in one cheap gather pass (cheaper than per-row scatters
            # here, and deletes batch)
            self._bias_stale = True
        return n

    def compact(self):
        """Re-stripe live rows, preserving IVF configuration + training
        (the inherited compact re-runs __init__, which would reset
        num_clusters/nprobe and drop the centroids; reachable from the
        background compaction cron)."""
        cfg = (self.num_clusters_cfg, self.nprobe, self.min_train_size,
               self.pq_subspaces, self.pq_centroids, self.rerank_factor,
               self.pq_rerank)
        cents, tsize, pq = self.centroids, self._trained_size, self.pq
        mut = self._mutations  # __init__ would reset the mutation count
        defer = self.defer_retrain  # __init__ would reset engine ownership
        self.min_train_size = 1 << 62  # suppress retrain during re-stripe
        try:
            super().compact()
        finally:
            (self.num_clusters_cfg, self.nprobe, self.min_train_size,
             self.pq_subspaces, self.pq_centroids, self.rerank_factor,
             self.pq_rerank) = cfg
        self.centroids = cents
        self._trained_size = tsize
        self.pq = pq
        self._mutations = mut + 1
        self.defer_retrain = defer
        if self.trained:
            self._rebuild_buckets()

    # --- search -----------------------------------------------------------------

    def _shard_probe_index(self, dpi: int, s: int, dev) -> ProbeIndex:
        """What `_ivf_probe` reads of cell (dpi, s): its stripe's tensors,
        the replicated centroids and codebooks on its device (codebooks only
        where codes exist; residual codes always)."""
        def part(t):
            return None if t is None else t.part(dpi, s)

        pq = self.pq is not None and self.codes is not None
        return ProbeIndex(
            metric=self.metric, dims=self.dims, residual=True, centroids=self.centroids.on(dev),
            slice_cluster=self._slice_cluster_dev.on(dev), slice_bias=self.slice_bias.on(dev),
            centroids_exp=self.centroids_exp.on(dev), buckets_slots=part(self.buckets),
            vectors=part(self.vectors), scales=part(self.scales), valid=part(self.valid),
            sq_norms=part(self.sq_norms), bucket_vectors=part(self.bucket_vectors),
            bucket_scales=part(self.bucket_scales), bucket_bias=part(self.bucket_bias),
            codebooks=self._codebooks().on(dev) if pq else None, codes=part(self.codes),
            bucket_codes=part(self.bucket_codes))

    def search_arrays(self, q, k: int, slot_mask=None, nprobe: int | None = None,
                      mode: str = "auto"):
        if (not self.trained or self.capacity == 0 or len(self) == 0
                or mode == "exact"):
            # incl. trained-but-emptied indexes restored from snapshots;
            # mode='exact' bypasses the probe for the full sharded scan
            return super().search_arrays(q, k, slot_mask=slot_mask, mode=mode)
        qx, qsq, b = self._prep_queries(q)
        if self._bias_stale:
            # deletes staled the cached bucket bias: one rebuild, re-cached
            # (a per-call mask folds into a bias of its own in `_ivf_probe`)
            self.bucket_bias = _sharded_bucket_bias(
                self.buckets, self.valid, self.sq_norms,
                l2=self.metric == "l2" and self.bucket_vectors is not None, mesh=self.mesh)
            self._bias_stale = False
        allowed = None if slot_mask is None else self._masked_valid(slot_mask)
        np_probe = min(int(nprobe or self.nprobe), self.centroids_exp.shape[0])
        pool = self.pq_rerank or max(self.rerank_factor * k, 51 * k, 512)

        def body(dpi, s, dev, qb):
            return _ivf_probe(qb, self._shard_probe_index(dpi, s, dev), k=k, nprobe=np_probe,
                              rerank=pool,
                              slot_mask=None if allowed is None else allowed.part(dpi, s))

        scores, idx = _run_probe(qx, k, self._rows_per_shard(), self.mesh, body)
        return self._results(scores, idx, qsq, b)

    # search(): inherited; the base passes extra kwargs (nprobe) through
    # to search_arrays polymorphically.

    # --- persistence ----------------------------------------------------------------

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["type"] = "sharded_ivf"
        d["num_clusters_cfg"] = self.num_clusters_cfg
        d["nprobe"] = self.nprobe
        d["centroids"] = self.centroids.numpy() if self.trained else None
        d["trained_size"] = self._trained_size
        d["pq_subspaces"] = self.pq_subspaces
        d["pq_centroids"] = self.pq_centroids
        d["rerank_factor"] = self.rerank_factor
        d["pq_rerank"] = self.pq_rerank
        d["pq"] = self.pq.state_dict() if self.pq is not None else None
        return d

    def _install_centroids(self, cents, trained_size, pq_state):
        """Adopt saved centroids (+ PQ codebooks) and build the layout."""
        cents = np.asarray(cents, np.float32)
        if cents.shape[1] < self.d_pad:
            cents = np.pad(cents, ((0, 0), (0, self.d_pad - cents.shape[1])))
        self.centroids = Replicated(self.mesh, cents)
        self._trained_size = trained_size
        if pq_state is not None:
            self.pq = PQCodebook.from_state_dict(pq_state, device=self.mesh.device)
        self._rebuild_buckets()  # re-encodes codes when pq is set

    @staticmethod
    def from_state_dict(d: dict, mesh) -> "ShardedIVFIndex":
        idx = ShardedIVFIndex(
            d["dims"], mesh, d["metric"], d["precision"],
            num_clusters=d.get("num_clusters_cfg", 0), nprobe=d.get("nprobe", 8),
            pq_subspaces=d.get("pq_subspaces", 0),
            pq_centroids=d.get("pq_centroids", 0),
            rerank_factor=d.get("rerank_factor", 2),
            pq_rerank=d.get("pq_rerank", 0),
        )
        orig_min = idx.min_train_size
        idx.min_train_size = 1 << 62  # the saved centroids are about to be
        # installed: a retrain during the restore upsert would be thrown away
        try:
            if d["pks"]:
                vecs = state_vectors_f32(d)
                slots = idx.upsert(d["pks"], vecs[:, : d["dims"]], _prepped=vecs)
                idx.filter_columns.scatter(
                    d.get("filter_columns", {}), slots, idx.capacity
                )
        finally:
            idx.min_train_size = orig_min
        if d.get("centroids") is not None:
            idx._install_centroids(d["centroids"], d.get("trained_size", len(idx)), d.get("pq"))
        return idx
