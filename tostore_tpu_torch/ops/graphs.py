"""CUDA-graph capture and replay of a search's fixed chain of device stages.

A search route whose stages launch the same kernels in the same order on
inputs of fixed shape, with no host sync among them, can be captured once
as CUDA graphs and replayed: one graph launch a stage where the host would
otherwise issue every aten op and kernel launch itself. `GraphCache` keeps
one `StageGraphs` a key. The caller names the key by the search's shape,
and the cache adds the identity (address, shape, stride, dtype) of every
tensor the stages read, so that a replay reads the tensors its capture
read: a tensor replaced by another misses the key and is captured again,
and a tensor written in place is read at replay as it is eagerly. Each
entry holds the tensors it captured, so that no address it baked in can
be freed under it.

The first search of a key runs eagerly and records the key; the second
captures, on a side stream into the entry's private memory pool, after one
eager pass of each stage on that stream, and replays; later ones replay.
A captured entry stays until its tensors are replaced (`clear`), so a set
of tensors pays at most MAX_ENTRIES captures: past that, a new key makes
room only by evicting a key recorded but not captured, and else runs
eagerly. Traffic of more keys than that never recaptures a key it evicted.
A search that finds its entry held by another thread runs eagerly, so
concurrent searches never queue behind one another. Launch counters move
as the kernels run: a capture counts nothing, and each replay adds the
launches its capture recorded (`_kernels.recording`). A search takes its
entry through `GraphCache.stages` and releases it with `Stages.release`.

Nothing here runs at import time; capture and replay need a CUDA device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from . import _kernels

# Entries a cache keeps. On an H100, at 1M x 768 nlist 1024 nprobe 16, an
# entry's private pool reserves 44 MB (B = 1) to 86 MB (B = 32) and its
# capture search takes 6-11 ms (B = 1) to 9-43 ms (B = 32): 8 entries hold
# under 0.7 GB and cost under 0.35 s of captures a layout. Under traffic of
# 12 keys, 8 captured and the rest eager ran 10-20% faster than all eager;
# under 32 keys, even with it (experiments/_ivf_graph_traffic_torch.py).
MAX_ENTRIES = 8


def identities(tensors) -> tuple:
    """What a captured kernel bakes in of each tensor: its address, shape,
    stride and dtype (None for an absent tensor)."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


def eager(_stage: int, fn):
    """The eager counterpart of `StageGraphs.stage`: run the stage."""
    return fn()


class Stages:
    """One search's way through its stages (`GraphCache.stages`): `run(i,
    fn)` gives stage i's output (`eager`, or the entry's `StageGraphs.stage`),
    `inputs` are what the stages read (the entry's static buffers, or the
    search's own), `graphed` says whether they run as the entry's graphs and
    `captures` whether this search captures them. `release()` frees the
    entry, once the search no longer reads the stages' outputs."""

    __slots__ = ("run", "inputs", "graphed", "captures", "_entry")

    def __init__(self, inputs: tuple, entry: "StageGraphs | None" = None):
        self._entry = entry
        self.graphed = entry is not None
        self.run = entry.stage if self.graphed else eager
        self.inputs = entry.load(*inputs) if self.graphed else inputs
        self.captures = self.graphed and not entry.captured

    def release(self):
        if self._entry is not None:
            entry, self._entry = self._entry, None
            entry.lock.release()


class StageGraphs:
    """The graphs of one key: static input buffers and one graph a stage,
    each with its static output and the launches its capture recorded.
    `lock` is held by the one search that uses the entry."""

    def __init__(self, ident: tuple, held: tuple):
        self.ident = ident
        self.held = held  # the captured tensors, alive as long as the graphs
        self.lock = threading.Lock()
        self.broken = False  # a capture failed: the key runs eagerly
        self.inputs: tuple | None = None
        self._graphs: list = []  # (graph, static output, recorded launches)
        self._pool = None

    @property
    def captured(self) -> bool:
        return bool(self._graphs)

    def load(self, *tensors) -> tuple:
        """Copy a search's inputs into the static buffers (made at the first
        call, like the inputs) and return the buffers."""
        if self.inputs is None:
            self.inputs = tuple(torch.empty_like(t) for t in tensors)
        for buf, t in zip(self.inputs, tensors):
            buf.copy_(t)
        return self.inputs

    def stage(self, i: int, fn):
        """Stage i's output: its graph replayed on the current stream, the
        graph first captured from `fn()` where stage i has none yet. `fn`
        reads the static inputs and the earlier stages' outputs only."""
        if i == len(self._graphs):
            try:
                self._graphs.append(self._capture(fn))
            except BaseException:
                self.broken = True
                raise
        graph, out, launches = self._graphs[i]
        graph.replay()
        _kernels.add(launches)
        return out

    def _capture(self, fn):
        dev = self.inputs[0].device
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn()  # lazy per-stream state (cuBLAS's workspace) before the capture
                graph = torch.cuda.CUDAGraph()
                with _kernels.recording() as launches:
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        out = fn()
                    finally:
                        graph.capture_end()
            cur.wait_stream(side)
        self._pool = graph.pool()
        return graph, out, launches


class GraphCache:
    """StageGraphs by key, at most MAX_ENTRIES; captured entries are never
    evicted, recorded ones least recently used first."""

    def __init__(self):
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._entries)

    def clear(self):
        """Drop every entry, with the tensors and graphs it holds: the owner
        calls this where it replaces the tensors the entries captured."""
        with self._lock:
            self._entries.clear()

    def acquire(self, key, held: tuple) -> StageGraphs | None:
        """The entry of (key, the identities of `held`), its lock taken for
        the caller to release; or None where the search runs eagerly: a key
        not seen before (recorded now where there is room; entries whose
        tensors were replaced are dropped), an entry another thread holds,
        or a broken one."""
        ident = identities(held)
        full = (key, ident)
        with self._lock:
            entry = self._entries.get(full)
            if entry is None:
                for k in [k for k, e in self._entries.items() if e.ident != ident]:
                    del self._entries[k]
                if len(self._entries) >= MAX_ENTRIES:
                    spare = next((k for k, e in self._entries.items() if not e.captured
                                  and not e.broken and not e.lock.locked()), None)
                    if spare is None:  # every entry captured (or in use): no room
                        return None
                    del self._entries[spare]
                self._entries[full] = StageGraphs(ident, held)
                return None
            self._entries.move_to_end(full)
        if not entry.lock.acquire(blocking=False):
            return None
        if entry.broken:
            entry.lock.release()
            return None
        return entry

    def stages(self, key, held: tuple, *inputs) -> Stages:
        """A search's `Stages` through the entry of (key, the identities of
        `held`): its graphs on its static buffers, loaded from `inputs`;
        eagerly on `inputs` where the key is None or `acquire` gives no
        entry. The entry stays locked until `Stages.release()` (released
        here if the load fails): the stages' outputs are static buffers that
        another search's replay would overwrite, so the search releases it
        after their copy."""
        entry = None if key is None else self.acquire(key, held)
        if entry is None:
            return Stages(inputs)
        try:
            return Stages(inputs, entry)
        except BaseException:
            entry.lock.release()
            raise
