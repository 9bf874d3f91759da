"""Mesh construction, striped tensors and the collectives (counterpart of
`tostore_tpu/parallel/mesh.py`).

Axes, as in the JAX package:
  - "shard": the corpus axis, N rows striped across cells;
  - "dp":    the query axis, independent query batches in parallel.

A mesh is a [dp, shard] grid of cells; a cell is a (process rank, torch
device) pair. Where the JAX package hands a `shard_map` body to XLA, the
port runs the body as a plain function once per cell that this process
OWNS (the cells whose rank is its own), on that cell's device. What XLA
did with `all_gather` / `psum` is here a copy between the owned cells
plus one `torch.distributed` collective across processes
(`Mesh.all_gather_cells`, `Mesh.all_reduce_sum`).

One process may own several cells, and several cells may share a device:
`make_mesh(devices=["cpu"] * 4)` is a 4-cell mesh on the CPU (the
counterpart of the JAX package's virtual CPU devices), `["cuda:0"] * 4`
four cells on one card. Multi-process jobs call `init_distributed` first
and then `make_mesh()` with no device list: cells follow the process
group's ranks. Every process runs the same host code on the same data
and every process gets the same global result (the JAX package's SPMD
contract).

`Striped` is the sharded array: per-cell tensors addressed by GLOBAL row
(row = shard * rows_per_stripe + j), replicated over "dp". `Replicated`
holds one copy of a small tensor on each device this process owns cells
on.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch

# seconds a rendezvous or a collective may take before it fails
DIST_TIMEOUT_S = 120

# set by init_distributed: CPU cells per process (gloo), or None for one
# rank per card (nccl)
_DIST: dict = {}


@dataclass(frozen=True)
class Cell:
    """One mesh position: the process that owns it and its device."""

    rank: int
    device: torch.device


def _dist():
    import torch.distributed as dist

    return dist


def distributed_initialized() -> bool:
    """True once `init_distributed` joined a process group."""
    dist = _dist()
    return bool(_DIST) and dist.is_available() and dist.is_initialized()


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_cpu_devices: int | None = None,
    timeout_s: float = DIST_TIMEOUT_S,
) -> None:
    """Join a multi-process job BEFORE building the mesh: every process
    calls this, then `make_mesh()` spans the cells of all processes.

    `local_cpu_devices` gives every process that many CPU cells over the
    gloo backend (tests and smoke runs without several cards); without it
    the backend is nccl with one rank per card. A rendezvous or collective
    that does not complete within `timeout_s` fails instead of waiting."""
    dist = _dist()
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    backend = "gloo" if local_cpu_devices is not None else "nccl"
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", process_id % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=addr, world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _DIST["local_cpu_devices"] = local_cpu_devices


def shutdown_distributed() -> None:
    """Leave the process group joined by `init_distributed`."""
    if distributed_initialized():
        _dist().destroy_process_group()
    _DIST.clear()


class Mesh:
    """A [dp, shard] grid of cells."""

    def __init__(self, cells: np.ndarray, axis_names=("dp", "shard")):
        self.devices = cells  # object array [dp, shard] of Cell
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, cells.shape))
        self.distributed = distributed_initialized()
        self.rank = _dist().get_rank() if self.distributed else 0
        for c in cells.flat:
            if not self.distributed and c.rank != 0:
                raise ValueError("cells of other ranks need init_distributed first")
        # the cells this process runs, in grid order: (dp index, shard, device)
        self.owned = [
            (dpi, s, cells[dpi, s].device)
            for dpi in range(cells.shape[0]) for s in range(cells.shape[1])
            if cells[dpi, s].rank == self.rank
        ]
        if not self.owned:
            raise ValueError(f"rank {self.rank} owns no cell of the mesh")
        if self.distributed:
            per_rank = {}
            for c in cells.flat:
                per_rank[c.rank] = per_rank.get(c.rank, 0) + 1
            world = _dist().get_world_size()
            if set(per_rank) != set(range(world)) or len(set(per_rank.values())) != 1:
                raise ValueError("every rank of the group must own the same number of cells")
        # collectives and replicated host-facing values live here
        self.device = self.owned[0][2]
        self.owned_devices = list(dict.fromkeys(dev for _, _, dev in self.owned))

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, owned={len(self.owned)})"

    # --- collectives -------------------------------------------------------

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` (on `self.device`) over the processes; the local
        value when the job is one process."""
        if self.distributed:
            _dist().all_reduce(t, op=_dist().ReduceOp.SUM)
        return t

    def all_gather_cells(self, local: dict) -> dict:
        """{(dp index, shard): tensor} for the owned cells -> the same for
        EVERY cell of the mesh, on `self.device`: copies between the owned
        cells plus one all_gather across processes. Every cell's tensor has
        the same shape and dtype."""
        out = {key: t.to(self.device) for key, t in local.items()}
        if not self.distributed:
            return out
        dist = _dist()
        mine = torch.stack([out[(dpi, s)] for dpi, s, _ in self.owned])
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine.contiguous())
        seen = [0] * len(parts)
        res = {}
        for dpi in range(self.devices.shape[0]):
            for s in range(self.devices.shape[1]):
                r = self.devices[dpi, s].rank
                res[(dpi, s)] = parts[r][seen[r]]
                seen[r] += 1
        return res


def make_mesh(
    n_devices: int | None = None,
    dp: int = 1,
    axis_names: tuple[str, str] = ("dp", "shard"),
    devices=None,
) -> Mesh:
    """Build a (dp, shard) mesh over the first n_devices cells.

    `devices` is an explicit list and may repeat a device (several cells
    on one CPU or one card). With no list: after `init_distributed` the
    cells follow the group's ranks (rank r owns cells r*L .. r*L+L-1 on
    the CPU for `local_cpu_devices=L`, or cell r on its card); otherwise
    cell i lives on cuda:i, and a machine with fewer cards raises: a mesh
    never falls back to the CPU."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        rank = _dist().get_rank() if distributed_initialized() else 0
        cells = [Cell(rank, d) for d in devs]
    elif distributed_initialized():
        world = _dist().get_world_size()
        local = _DIST.get("local_cpu_devices")
        if local is not None:
            cells = [Cell(r, torch.device("cpu")) for r in range(world) for _ in range(local)]
        else:
            ncards = max(torch.cuda.device_count(), 1)
            cells = [Cell(r, torch.device("cuda", r % ncards)) for r in range(world)]
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = n_devices or have
        if want < 1 or want > have:
            raise RuntimeError(
                f"a mesh of {want} CUDA devices needs {want} cards, this machine has {have}; "
                "pass devices=[...] to place several cells on one device")
        cells = [Cell(0, torch.device("cuda", i)) for i in range(want)]
    n = n_devices or len(cells)
    if n > len(cells):
        raise ValueError(f"n_devices {n} exceeds the {len(cells)} available cells")
    cells = cells[:n]
    if n % dp != 0:
        raise ValueError(f"n_devices {n} not divisible by dp {dp}")
    grid = np.empty(n, dtype=object)
    for i, c in enumerate(cells):
        grid[i] = c
    return Mesh(grid.reshape(dp, n // dp), axis_names)


def shard_count(mesh: Mesh) -> int:
    return mesh.shape["shard"]


# --------------------------------------------------------------------------
# Replicated and striped values
# --------------------------------------------------------------------------


class Replicated:
    """One copy of a (small) tensor on every device this process owns
    cells on; `.local` is the copy on the mesh's own device."""

    def __init__(self, mesh: Mesh, value):
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        self._by_dev = {dev: t.to(dev) for dev in mesh.owned_devices}
        self.local = self._by_dev[mesh.device]

    def on(self, device) -> torch.Tensor:
        return self._by_dev[device]

    @property
    def shape(self):
        return self.local.shape

    @property
    def dtype(self):
        return self.local.dtype

    def numpy(self) -> np.ndarray:
        return self.local.cpu().numpy()


class Striped:
    """A [shard * rows, ...] array as per-cell tensors: cell (dp index,
    shard) holds rows shard*rows .. (shard+1)*rows - 1, and every dp row of
    the mesh holds a full copy. Host code addresses GLOBAL rows; `split`
    turns them into per-cell local rows, `scatter` / `gather` write and
    read through it."""

    def __init__(self, mesh: Mesh, parts: dict):
        self.mesh = mesh
        self.parts = parts  # {(dp index, shard): tensor} for the owned cells
        self.rows = next(iter(parts.values())).shape[0]

    @classmethod
    def full(cls, mesh: Mesh, rows: int, tail: tuple, fill, dtype) -> "Striped":
        return cls(mesh, {
            (dpi, s): torch.full((rows, *tail), fill, dtype=dtype, device=dev)
            for dpi, s, dev in mesh.owned})

    @classmethod
    def from_global(cls, mesh: Mesh, x) -> "Striped":
        """Stripe a global array that every process holds in full."""
        nsh = shard_count(mesh)
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.shape[0] % nsh:
            raise ValueError(f"{t.shape[0]} rows do not stripe over {nsh} shards")
        rows = t.shape[0] // nsh
        return cls(mesh, {(dpi, s): t[s * rows:(s + 1) * rows].to(dev).contiguous()
                          for dpi, s, dev in mesh.owned})

    # --- shape -------------------------------------------------------------

    @property
    def shape(self):
        first = next(iter(self.parts.values()))
        return (self.rows * shard_count(self.mesh), *first.shape[1:])

    @property
    def dtype(self):
        return next(iter(self.parts.values())).dtype

    def part(self, dpi: int, s: int) -> torch.Tensor:
        return self.parts[(dpi, s)]

    def map(self, fn) -> "Striped":
        """A new Striped of fn(part) per owned cell."""
        return Striped(self.mesh, {key: fn(t) for key, t in self.parts.items()})

    # --- global rows ---------------------------------------------------------

    def _split_host(self, rows):
        """Global rows -> [(dp index, shard, positions in `rows`, local
        rows)] as numpy arrays, for the owned cells that hold any of them."""
        rows = np.asarray(rows, np.int64)
        sh = rows // self.rows
        out = []
        cache = {}
        for dpi, s, _ in self.mesh.owned:
            if s not in cache:
                sel = np.flatnonzero(sh == s)
                cache[s] = (sel, rows[sel] - s * self.rows)
            sel, loc = cache[s]
            if len(sel):
                out.append((dpi, s, sel, loc))
        return out

    def split(self, rows):
        """`_split_host` with the local rows as an int64 tensor on the
        cell's device, ready to index its part."""
        return [(dpi, s, sel, torch.from_numpy(loc).to(self.parts[(dpi, s)].device))
                for dpi, s, sel, loc in self._split_host(rows)]

    def scatter(self, rows, values):
        """part[local rows] = values, in place, on every dp copy. `values`
        is a scalar or a host array with one entry per row (every process
        passes the same), cast to the parts' dtype on the device."""
        scalar = np.ndim(values) == 0
        if not scalar:
            values = np.asarray(values)
        for dpi, s, sel, loc in self._split_host(rows):
            part = self.parts[(dpi, s)]
            # a bulk load fills each stripe with one run of consecutive rows
            # from one run of the batch: block copies, no gather or scatter
            n = len(sel)
            run = int(sel[-1]) - int(sel[0]) + 1 == n and int(loc[-1]) - int(loc[0]) + 1 == n \
                and (n < 2 or bool((loc[1:] > loc[:-1]).all()))
            dst = part[int(loc[0]):int(loc[0]) + n] if run else None
            at = None if run else torch.from_numpy(loc).to(part.device)
            if scalar:
                if run:
                    dst.fill_(values)
                else:
                    part[at] = values
                continue
            blk = values[int(sel[0]):int(sel[0]) + n] if run else values[sel]
            blk = torch.from_numpy(np.ascontiguousarray(blk)).to(part.device).to(part.dtype)
            if run:
                dst.copy_(blk)
            else:
                part[at] = blk

    def gather(self, rows, fn=None) -> torch.Tensor:
        """[len(rows), ...] on the mesh's device, the same on every
        process: part[local rows] of each shard's first dp copy, passed
        through fn(block, dp index, shard) where given (so that only its
        result crosses devices and processes)."""
        rows = np.asarray(rows, np.int64)
        # the result's tail shape and dtype, which fn may change (a process
        # that reads none of the rows needs them too)
        key0, first = next(iter(self.parts.items()))
        probe = first[:0] if fn is None else fn(first[:0], *key0)
        out = torch.zeros((len(rows), *probe.shape[1:]), dtype=probe.dtype,
                          device=self.mesh.device)
        for dpi, s, sel, loc in self.split(rows):
            if dpi != self._reader(s):
                continue
            blk = self.parts[(dpi, s)][loc]
            if fn is not None:
                blk = fn(blk, dpi, s)
            out[torch.from_numpy(sel).to(self.mesh.device)] = blk.to(self.mesh.device)
        return _sum_exact(self.mesh, out) if self.mesh.distributed else out

    def _reader(self, s: int) -> int:
        """The dp copy of shard s that answers reads: in a multi-process
        job the first dp row's (one contributor per shard, so that the sum
        across processes counts every row once); in one process the first
        owned one."""
        if self.mesh.distributed:
            return 0
        return next(dpi for dpi, ss, _ in self.mesh.owned if ss == s)

    def to_global(self) -> torch.Tensor:
        """The whole array on the mesh's device, the same on every process."""
        nsh = shard_count(self.mesh)
        first = next(iter(self.parts.values()))
        out = torch.zeros((nsh * self.rows, *first.shape[1:]), dtype=first.dtype,
                          device=self.mesh.device)
        for dpi, s, _ in self.mesh.owned:
            if dpi == self._reader(s):
                out[s * self.rows:(s + 1) * self.rows] = self.parts[(dpi, s)].to(self.mesh.device)
        return _sum_exact(self.mesh, out) if self.mesh.distributed else out


def _sum_exact(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """all_reduce of a tensor that is zero outside one process's rows, for
    any dtype: the bytes are summed as integers, which is exact because at
    most one contribution to a byte is non-zero."""
    if t.dtype in (torch.float32, torch.int64, torch.int32):
        return mesh.all_reduce_sum(t)
    if t.dtype == torch.bool:
        return mesh.all_reduce_sum(t.to(torch.uint8)).bool()
    raw = t.contiguous().view(torch.uint8)
    return mesh.all_reduce_sum(raw).view(t.dtype).reshape(t.shape)


def host_local_to_global(x, mesh: Mesh, spec) -> "Striped | Replicated":
    """A global array from this process's host-local part. A spec that
    starts with "shard" takes the rows of the shards this process owns, in
    shard order (each process holds its stripes of the corpus); a spec
    without a mesh axis declares the host value, identical on every
    process, the global value."""
    spec = tuple(spec)
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if spec and spec[0] == "shard":
        shards = list(dict.fromkeys(s for _, s, _ in mesh.owned))
        if t.shape[0] % len(shards):
            raise ValueError(f"{t.shape[0]} local rows do not split over {len(shards)} shards")
        rows = t.shape[0] // len(shards)
        at = {s: j for j, s in enumerate(shards)}
        return Striped(mesh, {
            (dpi, s): t[at[s] * rows:(at[s] + 1) * rows].to(dev).contiguous()
            for dpi, s, dev in mesh.owned})
    if any(a is not None for a in spec):
        raise ValueError(f"unsupported partition spec {spec}")
    return Replicated(mesh, t)


def read_to_host(x) -> np.ndarray:
    """numpy readback of a striped, replicated or plain value: the global
    value on every process."""
    if isinstance(x, Striped):
        return x.to_global().cpu().numpy()
    if isinstance(x, Replicated):
        return x.numpy()
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def replicated_from_host(x: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """The host value (identical on every process by construction) as one
    tensor on the mesh's device. Queries go this way: one upload, of which
    the per-cell bodies take their "dp" slice."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)
