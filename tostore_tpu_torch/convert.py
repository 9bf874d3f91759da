"""State conversion between the JAX package's flat index and the port's.

A `FlatVectorIndex.state_dict()` of the JAX package is a dict of numpy
arrays: bf16 vectors are ml_dtypes arrays, read here bit for bit through
`.view(np.int16)`. The port writes the same format, so a snapshot made by
either package opens in the other. bf16 vectors are written as ml_dtypes
arrays where ml_dtypes imports (the JAX package's own type), else as
float32, which widens bf16 exactly and which the JAX package's
`from_state_dict` casts back to bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from .vector.corpus import INT8_SCALE, DeviceCorpus
from .vector.flat import FlatVectorIndex


def _rows_to_tensor(vecs: np.ndarray) -> torch.Tensor:
    """A host copy of snapshot rows as a tensor of the same bits (bf16 rows
    through int16). Copies, since snapshot arrays may be read-only."""
    if vecs.dtype.name == "bfloat16":
        return torch.tensor(vecs.view(np.int16)).view(torch.bfloat16)
    if vecs.dtype == np.int8:
        return torch.tensor(vecs)
    return torch.tensor(vecs.astype(np.float32, copy=False))


def _vectors_to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype != torch.bfloat16:
        return t.cpu().numpy()
    try:
        import ml_dtypes
    except ImportError:  # the card's environment: widen exactly to f32
        return t.float().cpu().numpy()
    return t.view(torch.int16).cpu().numpy().view(ml_dtypes.bfloat16)


def corpus_from_reference(d: dict, device) -> DeviceCorpus:
    """A DeviceCorpus from the JAX package's `DeviceCorpus.state_dict()`."""
    c = DeviceCorpus(d["dims"], d["precision"], d["normalize"], device=device)
    pks = d["pks"]
    m = len(pks)
    if not m:
        return c
    c._ensure_capacity(m)
    vecs = np.asarray(d["vectors"])
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
