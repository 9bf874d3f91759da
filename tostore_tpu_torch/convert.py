"""State conversion between the JAX package's indexes and the port's.

A `FlatVectorIndex.state_dict()` or `IVFVectorIndex.state_dict()` of the
JAX package is a dict of numpy arrays: bf16 vectors are ml_dtypes arrays,
read here bit for bit through `.view(np.int16)`. The port writes the same
format, so a snapshot made by either package opens in the other. The port
holds bf16 vectors on the host as `BF16Array` (utils/bf16.py: the same
bits in a uint16 array, no ml_dtypes), which the codec writes with the
same wire tag as the ml_dtypes type, 2 bytes a value; handed to the JAX
package in memory it widens exactly to float32 (`__array__`), which that
package's `from_state_dict` casts back to bf16. An IVF snapshot carries the
corpus, the centroids and the PQ codebooks; the bucket layout is rebuilt
from them on load, in either package. The sharded indexes' snapshots
(`ShardedFlatIndex.state_dict()`, `ShardedIVFIndex.state_dict()`) hold the
live rows in storage dtype with their pks; the stripes, the slots and the
bucket layout are rebuilt on load over whatever mesh the loader has.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.bf16 import BF16Array, is_bf16
from .vector.corpus import INT8_SCALE, DeviceCorpus
from .vector.flat import FlatVectorIndex
from .vector.ivf import IVFVectorIndex
from .vector.pq import PQCodebook
from .parallel.sharded import ShardedFlatIndex
from .parallel.sharded_ivf import ShardedIVFIndex


def _rows_to_tensor(vecs: np.ndarray) -> torch.Tensor:
    """A host copy of snapshot rows as a tensor of the same bits (bf16 rows
    through int16). Copies, since snapshot arrays may be read-only."""
    if is_bf16(vecs):
        return torch.tensor(vecs.view(np.int16)).view(torch.bfloat16)
    if vecs.dtype == np.int8:
        return torch.tensor(vecs)
    return torch.tensor(vecs.astype(np.float32, copy=False))


def _vectors_to_numpy(t: torch.Tensor):
    if t.dtype != torch.bfloat16:
        return t.cpu().numpy()
    return BF16Array(t.view(torch.int16).cpu().numpy())


def corpus_from_reference(d: dict, device) -> DeviceCorpus:
    """A DeviceCorpus from the JAX package's `DeviceCorpus.state_dict()`."""
    c = DeviceCorpus(d["dims"], d["precision"], d["normalize"], device=device)
    pks = d["pks"]
    m = len(pks)
    if not m:
        return c
    c._ensure_capacity(m)
    vecs = d["vectors"]
    if not is_bf16(vecs):  # a BF16Array stays as its bits
        vecs = np.asarray(vecs)
    # staged in chunks; f32 snapshots of bf16 corpora cast on the device
    chunk = max(1, (64 << 20) // max(1, vecs.shape[1] * vecs.dtype.itemsize))
    for off in range(0, m, chunk):
        blk = _rows_to_tensor(vecs[off : off + chunk])
        c.vectors[off : off + blk.shape[0]] = blk.to(c.device).to(c.dtype)
    c.valid[:m] = True
    dq = None
    if c.precision == "int8":
        # legacy snapshots (no per-row scales) keep the global value/127 rule
        raw = d.get("scales")
        dq = (np.asarray(raw, np.float32) if raw is not None
              else np.full(m, 1.0 / INT8_SCALE, np.float32))
        c.scales[:m] = torch.tensor(dq, device=c.device)
    nrm = d.get("sq_norms")
    if nrm is not None and len(nrm) == m:
        c.sq_norms[:m] = torch.tensor(np.asarray(nrm, np.float32), device=c.device)
    else:  # legacy snapshot: recompute on the device
        x = c.vectors[:m].float()
        if dq is not None:
            x = x * c.scales[:m, None]
        c.sq_norms[:m] = torch.sum(x * x, dim=1)
    c._slot_pks[:m] = np.asarray(pks, dtype=object)
    c._pk_slot = {pk: j for j, pk in enumerate(pks)}
    c._high = m
    c.filter_columns.load_state_dict(d.get("filter_columns", {}), c.capacity)
    return c


def corpus_to_reference_state(c: DeviceCorpus) -> dict:
    """The JAX package's `DeviceCorpus.state_dict()` format (compacts)."""
    c.compact()  # persist a packed corpus
    m = c._high
    return {
        "dims": c.dims,
        "precision": c.precision,
        "normalize": c.normalize,
        "vectors": (_vectors_to_numpy(c.vectors[:m]) if m
                    else np.zeros((0, c.d_pad))),
        "scales": (c.scales[:m].cpu().numpy()
                   if c.scales is not None and m else None),
        "sq_norms": c.sq_norms[:m].cpu().numpy().astype(np.float32) if m else None,
        "pks": list(c._slot_pks[:m]),
        "filter_columns": c.filter_columns.state_dict(upto=m),
    }


def flat_index_from_reference(state: dict, device) -> FlatVectorIndex:
    """The port's FlatVectorIndex from a JAX `FlatVectorIndex.state_dict()`."""
    idx = FlatVectorIndex.__new__(FlatVectorIndex)
    idx.metric = state["metric"]
    idx.corpus = corpus_from_reference(state["corpus"], device)
    return idx


def flat_index_to_reference_state(idx: FlatVectorIndex) -> dict:
    """A state dict that the JAX `FlatVectorIndex.from_state_dict` opens."""
    return {"metric": idx.metric, "corpus": corpus_to_reference_state(idx.corpus),
            "type": "flat"}


def ivf_index_from_reference(state: dict, device) -> IVFVectorIndex:
    """The port's IVFVectorIndex from a JAX `IVFVectorIndex.state_dict()`:
    corpus, centroids and PQ codebooks; the layout is rebuilt here."""
    d = state
    idx = IVFVectorIndex(
        d["corpus"]["dims"], metric=d["metric"], precision=d["corpus"]["precision"],
        num_clusters=d["num_clusters_cfg"], nprobe=d["nprobe"],
        pq_subspaces=d["pq_subspaces"], pq_centroids=d["pq_centroids"],
        rerank_factor=d["rerank_factor"],
        # codebooks trained before residual mode existed decode raw
        # vectors; the flag must match how they were trained
        pq_residual=d.get("pq_residual", False), pq_rerank=d.get("pq_rerank", 0),
        device=device,
    )
    idx.corpus = corpus_from_reference(d["corpus"], device)
    if d.get("centroids") is not None:
        idx.centroids = torch.tensor(np.asarray(d["centroids"], np.float32), device=device)
        idx._trained_size = d.get("trained_size", len(idx.corpus))
        if d.get("pq") is not None:
            idx.pq = PQCodebook.from_state_dict(d["pq"], device=device)
        idx._rebuild_buckets()
    return idx


def ivf_index_to_reference_state(idx: IVFVectorIndex) -> dict:
    """A state dict that the JAX `IVFVectorIndex.from_state_dict` opens.
    The snapshot holds a packed corpus: an index with holes is compacted
    first (its layout rebuilt with it), so the live index stays
    consistent."""
    if idx.corpus._free or idx.corpus.deleted_count:
        idx.compact()
    return {
        "type": "ivf",
        "metric": idx.metric,
        "corpus": corpus_to_reference_state(idx.corpus),
        "num_clusters_cfg": idx.num_clusters_cfg,
        "nprobe": idx.nprobe,
        "pq_subspaces": idx.pq_subspaces,
        "pq_centroids": idx.pq_centroids,
        "rerank_factor": idx.rerank_factor,
        "pq_residual": idx.pq_residual,
        "pq_rerank": idx.pq_rerank,
        "centroids": idx.centroids.cpu().numpy() if idx.trained else None,
        "trained_size": idx._trained_size,
        "pq": idx.pq.state_dict() if idx.pq is not None else None,
    }


def _sharded_state_in(state: dict) -> dict:
    """The reference's sharded state with its bf16 rows (an `ml_dtypes`
    array) as a BF16Array of the same bits, which needs no `ml_dtypes`."""
    vecs = state["vectors"]
    if is_bf16(vecs) and not isinstance(vecs, BF16Array):
        state = {**state, "vectors": BF16Array(np.ascontiguousarray(vecs).view(np.int16))}
    return state


def sharded_flat_index_from_reference(state: dict, mesh) -> ShardedFlatIndex:
    """The port's ShardedFlatIndex over `mesh` from a JAX
    `ShardedFlatIndex.state_dict()`: rows re-striped in pk order, as the
    JAX package restores them, so the slots agree."""
    return ShardedFlatIndex.from_state_dict(_sharded_state_in(state), mesh)


def sharded_flat_index_to_reference_state(idx: ShardedFlatIndex) -> dict:
    """A state dict that the JAX `ShardedFlatIndex.from_state_dict` opens
    (bf16 rows widen exactly to float32 there and are cast back)."""
    return idx.state_dict()


def sharded_ivf_index_from_reference(state: dict, mesh) -> ShardedIVFIndex:
    """The port's ShardedIVFIndex over `mesh` from a JAX
    `ShardedIVFIndex.state_dict()`: corpus, centroids and residual PQ
    codebooks; the slice layout and the codes are rebuilt here."""
    return ShardedIVFIndex.from_state_dict(_sharded_state_in(state), mesh)


def sharded_ivf_index_to_reference_state(idx: ShardedIVFIndex) -> dict:
    """A state dict that the JAX `ShardedIVFIndex.from_state_dict` opens."""
    return idx.state_dict()
