"""DeviceCorpus: a growable, mutable vector matrix in device memory
(counterpart of `tostore_tpu/vector/corpus.py`).

The corpus is one block-padded [capacity, D_pad] tensor plus a validity
mask, on the device the caller names:

  - slot allocation = a host-side free list + monotonically growing tail;
  - delete = clearing a validity bit (tombstone);
  - compaction = one device gather that re-packs live rows;
  - capacity growth = allocate a larger tensor and copy (amortized
    doubling, rounded by `canonical_cap`), so capacities, slots and
    therefore search results match the JAX package's exactly.

Primary keys live on the host: an object array slot -> pk and a dict
pk -> slot. Persistence (`state_dict` / `from_state_dict`) is in
convert.py, in the JAX package's snapshot format.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.runtime import LANE, ROW_BLOCK, round_up
from .filters import FilterColumns

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float32,  # stored f32 on the device (reference-compat alias)
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}

# Legacy int8 dequant rule value/127, kept for snapshots without per-row
# scales. New int8 rows store a per-vector factor scale_i = max|x_i|/127.
INT8_SCALE = 127.0

# Host rows staged per transfer: float32 rows are cast to the stored type
# on the device, so a chunk bounds that f32 staging copy (64 MiB).
_UPLOAD_BYTES = 64 << 20


def quantize_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-vector int8 quantization: (codes int8, dequant factors f32) with
    scale_i = max|x_i|/INT8_SCALE (1/INT8_SCALE for all-zero rows)."""
    amax = np.max(np.abs(x), axis=1)
    dq = np.where(amax > 0, amax / INT8_SCALE, 1.0 / INT8_SCALE).astype(np.float32)
    enc = np.clip(np.round(x / dq[:, None]), -INT8_SCALE, INT8_SCALE).astype(np.int8)
    return enc, dq


def pks_at(slot_pks: np.ndarray, capacity: int, slots: np.ndarray) -> np.ndarray:
    """slot indices -> pks (object array of the slots' shape; None for a
    slot outside [0, capacity)), in one fancy index."""
    out = np.empty(slots.shape, dtype=object)
    keep = (slots >= 0) & (slots < capacity)
    out[keep] = slot_pks[slots[keep]]
    return out


class DeviceCorpus:
    """Mutable [capacity, D_pad] device matrix with tombstones and PK map."""

    def __init__(self, dims: int, precision: str = "float32", normalize: bool = False,
                 *, device):
        if precision not in _DTYPES:
            raise ValueError(f"unsupported precision {precision!r}")
        self.device = torch.device(device)
        self.dims = dims
        self.d_pad = round_up(max(dims, LANE), LANE)
        self.precision = precision
        self.dtype = _DTYPES[precision]
        self.normalize = normalize  # cosine metric stores L2-normalized rows

        self.capacity = 0
        self.vectors: torch.Tensor | None = None  # [capacity, d_pad] dtype
        self.valid: torch.Tensor | None = None  # [capacity] bool
        self.sq_norms: torch.Tensor | None = None  # [capacity] f32 (of stored rows)
        # per-row dequant factor (int8 only): x = enc * scales[i]
        self.scales: torch.Tensor | None = None  # [capacity] f32

        self._slot_pks = np.empty(0, dtype=object)  # slot -> pk
        self._pk_slot: dict = {}  # pk -> slot
        self._free: list[int] = []
        self._high = 0  # first never-used slot
        self.deleted_count = 0
        self.filter_columns = FilterColumns(self.device)

    # --- capacity ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._pk_slot)

    @property
    def live_count(self) -> int:
        return len(self._pk_slot)

    @property
    def deleted_ratio(self) -> float:
        used = self._high
        return (self.deleted_count / used) if used else 0.0

    @staticmethod
    def canonical_cap(n_slots: int) -> int:
        """Capacity covering n_slots: the block count rounded up to m * 2^e
        blocks with m in [8, 15], which caps the scan's overscan at 1/8.
        Kept from the JAX package (where it bounds XLA's shape family) so
        that both packages hold the same capacities."""
        blocks = max(1, (n_slots + ROW_BLOCK - 1) // ROW_BLOCK)
        if blocks <= 8:
            return ROW_BLOCK * blocks
        e = blocks.bit_length() - 4  # blocks >> e lands in [8, 15]
        m = (blocks + (1 << e) - 1) >> e  # ceil(blocks / 2^e)
        if m == 16:
            m, e = 8, e + 1
        return ROW_BLOCK * (m << e)

    def _alloc(self, cap: int):
        dev = self.device
        vec = torch.zeros((cap, self.d_pad), dtype=self.dtype, device=dev)
        val = torch.zeros(cap, dtype=torch.bool, device=dev)
        nrm = torch.zeros(cap, dtype=torch.float32, device=dev)
        scl = (
            torch.full((cap,), 1.0 / INT8_SCALE, dtype=torch.float32, device=dev)
            if self.precision == "int8" else None
        )
        return vec, val, nrm, scl

    def _ensure_capacity(self, n_slots: int):
        if n_slots <= self.capacity:
            return
        new_cap = n_slots
        if self.capacity:
            new_cap = max(new_cap, 2 * self.capacity)  # amortized doubling
        new_cap = self.canonical_cap(new_cap)
        vec, val, nrm, scl = self._alloc(new_cap)
        if self.capacity:
            c = self.capacity
            vec[:c] = self.vectors
            val[:c] = self.valid
            nrm[:c] = self.sq_norms
            if scl is not None:
                scl[:c] = self.scales
        self.vectors, self.valid, self.sq_norms, self.scales = vec, val, nrm, scl
        pks = np.empty(new_cap, dtype=object)
        pks[: len(self._slot_pks)] = self._slot_pks
        self._slot_pks = pks
        self.capacity = new_cap

    # --- host-side encode -------------------------------------------------

    def _prepare(self, raw: np.ndarray):
        """[m, dims] float input -> ([m, d_pad] host array, f32 for float
        corpora or int8 codes, and [m] f32 dequant factors or None)."""
        x = np.asarray(raw, np.float32)
        if x.ndim != 2 or x.shape[1] != self.dims:
            raise ValueError(f"expected [m, {self.dims}] vectors, got {x.shape}")
        if self.normalize:
            n = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(n, 1e-12)
        if self.d_pad != self.dims:
            x = np.pad(x, ((0, 0), (0, self.d_pad - self.dims)))
        if self.precision == "int8":
            return quantize_int8(x)
        return x, None

    @staticmethod
    def _stored_sq_norms(enc: np.ndarray, dq: np.ndarray | None) -> np.ndarray:
        # norms of the encoded f32 rows (before any bf16 rounding), as the
        # JAX package computes them
        x = enc if enc.dtype == np.float32 else enc.astype(np.float32)
        if dq is not None:
            x = x * dq[:, None]
        return np.einsum("ij,ij->i", x, x)

    def _upload_rows(self, host: np.ndarray, slots: np.ndarray | None, start: int):
        """vectors[start : start+m] (or vectors[slots]) = host, staged in
        chunks and cast to the stored type on the device."""
        row_bytes = host.shape[1] * host.dtype.itemsize
        chunk = max(1, _UPLOAD_BYTES // row_bytes)
        for off in range(0, host.shape[0], chunk):
            blk = torch.from_numpy(np.ascontiguousarray(host[off : off + chunk]))
            blk = blk.to(self.device).to(self.dtype)
            if slots is None:
                self.vectors[start + off : start + off + blk.shape[0]] = blk
            else:
                idx = torch.from_numpy(slots[off : off + chunk]).to(self.device)
                self.vectors[idx] = blk

    # --- mutation ----------------------------------------------------------

    def upsert(self, pks, raw: np.ndarray) -> np.ndarray:
        """Insert or overwrite vectors for `pks`. Returns slot indices."""
        pks = list(pks)
        enc, dq = self._prepare(raw)
        if len(pks) != enc.shape[0]:
            raise ValueError("pks/vectors length mismatch")
        m = len(pks)
        if m == 0:
            return np.zeros(0, np.int64)
        if not self._free and not self._pk_slot:
            # bulk-load fast path (empty corpus, all pks new)
            slots = np.arange(self._high, self._high + m, dtype=np.int64)
            self._high += m
            self._pk_slot = dict(zip(pks, slots.tolist()))
            self._ensure_capacity(self._high)
            self._slot_pks[slots] = np.asarray(pks, dtype=object)
        else:
            slots = np.empty(m, np.int64)
            for j, pk in enumerate(pks):
                slot = self._pk_slot.get(pk)
                if slot is None:
                    if self._free:
                        slot = self._free.pop()
                        self.deleted_count = max(0, self.deleted_count - 1)
                    else:
                        slot = self._high
                        self._high += 1
                    self._pk_slot[pk] = slot
                slots[j] = slot
            self._ensure_capacity(self._high)
            for j, pk in enumerate(pks):
                self._slot_pks[slots[j]] = pk

        nrm = torch.from_numpy(self._stored_sq_norms(enc, dq)).to(self.device)
        dq_dev = torch.from_numpy(dq).to(self.device) if dq is not None else None
        start = int(slots[0])
        if m >= 64 and np.array_equal(slots, np.arange(start, start + m)):
            # contiguous slots (bulk loads): block copies. Capacity grows to
            # the batch's power-of-two bucket, as in the JAX package, so
            # both packages keep the same capacity.
            self._ensure_capacity(start + (1 << (m - 1).bit_length()))
            end = start + m
            self._upload_rows(enc, None, start)
            self.valid[start:end] = True
            self.sq_norms[start:end] = nrm
            if dq_dev is not None:
                self.scales[start:end] = dq_dev
            return slots
        # general (overwrite / free-list reuse) path: row scatter
        idx = torch.from_numpy(slots).to(self.device)
        self._upload_rows(enc, slots, 0)
        self.valid[idx] = True
        self.sq_norms[idx] = nrm
        if dq_dev is not None:
            self.scales[idx] = dq_dev
        return slots

    def delete(self, pks) -> int:
        """Tombstone rows for `pks`. Returns number actually deleted."""
        slots = []
        for pk in pks:
            slot = self._pk_slot.pop(pk, None)
            if slot is not None:
                slots.append(slot)
                self._slot_pks[slot] = None
                self._free.append(slot)
        if not slots:
            return 0
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        self.valid[idx] = False
        self.deleted_count += len(slots)
        return len(slots)

    def compact(self):
        """Re-pack live rows to the front with one device gather."""
        live = np.flatnonzero(
            np.asarray([pk is not None for pk in self._slot_pks[: self._high]], np.bool_)
        )
        m = len(live)
        if m == self._high and not self._free:
            return
        gather = torch.from_numpy(live.astype(np.int64)).to(self.device)
        new_cap = self.canonical_cap(max(m, 1))
        vec, val, nrm, scl = self._alloc(new_cap)
        if m:
            vec[:m] = self.vectors[gather]
            val[:m] = True
            nrm[:m] = self.sq_norms[gather]
            if scl is not None:
                scl[:m] = self.scales[gather]
        self.vectors, self.valid, self.sq_norms, self.scales = vec, val, nrm, scl
        self.filter_columns.gather_permute(gather, new_cap)

        pks = np.empty(new_cap, dtype=object)
        pks[:m] = self._slot_pks[live]
        self._slot_pks = pks
        self._pk_slot = {pk: j for j, pk in enumerate(pks[:m])}
        self._free = []
        self._high = m
        self.capacity = new_cap
        self.deleted_count = 0

    # --- lookup -------------------------------------------------------------

    def pks_for_slots(self, slots: np.ndarray) -> np.ndarray:
        """slot indices -> pks (object array; None for invalid/padded)."""
        return pks_at(self._slot_pks, self.capacity, slots)

    def slots_for_pks(self, pks) -> np.ndarray:
        return np.asarray([self._pk_slot.get(pk, -1) for pk in pks], np.int64)

    def get_vectors(self, pks) -> np.ndarray:
        """Fetch stored (dequantized, possibly normalized) vectors by pk."""
        slots = self.slots_for_pks(pks)
        if np.any(slots < 0):
            missing = [pk for pk, s in zip(pks, slots) if s < 0]
            raise KeyError(f"pks not in corpus: {missing[:5]}")
        idx = torch.from_numpy(slots).to(self.device)
        x = self.vectors[idx].float()
        if self.scales is not None:
            x = x * self.scales[idx][:, None]
        return x.cpu().numpy()[:, : self.dims]
