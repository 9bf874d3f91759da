"""The port's multi-process path: two OS processes joined over
`torch.distributed` (gloo), 2 CPU cells each, one mesh spanning both. The
workers are those of tests/test_multihost.py on `tostore_tpu_torch`:
sharded k-means + sharded flat top-k with cross-process collectives, and
the engine opened with `mesh_shape` (sharded residual-PQ IVF insert,
search, checkpoint, reopen), for (1, 4) and (2, 2).

Each worker is a fresh interpreter that blocks `jax`, `jaxlib`,
`tostore_tpu` and `ml_dtypes`. Both ranks must print equal results (every
process returns the global result), equal to what one process computes on
a 4-cell mesh (scores rtol 1e-5: the cross-process sum adds the partial
sums in another order), and within the reference test's oracle bounds.
Nothing can hang the suite: the process group has a timeout
(`init_distributed(timeout_s=)`) and so has `communicate`.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_PRELUDE = r"""
import importlib.abc, json, sys

BLOCKED = ("jax", "jaxlib", "tostore_tpu", "ml_dtypes")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
torch.set_num_threads(1)
"""

_FUNCTIONS = r"""
from tostore_tpu_torch.parallel.mesh import (
    Striped, host_local_to_global, init_distributed, make_mesh, shutdown_distributed)
from tostore_tpu_torch.parallel.sharded import sharded_flat_topk, sharded_kmeans_step


def run(mesh, local_rows=None):
    n, d, k, c = 512, 32, 5, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)   # same on both procs
    q = rng.standard_normal((4, d)).astype(np.float32)
    if local_rows is None:
        corpus = Striped.from_global(mesh, x)
    else:  # each process contributes its host-local stripes of the corpus
        corpus = host_local_to_global(local_rows(x), mesh, ("shard", None))
    valid = Striped.from_global(mesh, np.ones(n, bool))
    cents = sharded_kmeans_step(corpus, x[:c], valid, mesh=mesh)
    bias = Striped.from_global(mesh, np.zeros(n, np.float32))
    scores, idx = sharded_flat_topk(q, corpus, bias, k=k, alpha=1.0, mesh=mesh)
    # read a stripe this process does not own
    far = corpus.gather(np.array([n - 1, 0, n // 2]))
    assert np.array_equal(far.numpy(), x[[n - 1, 0, n // 2]])
    return {"cents": cents.numpy().tolist(), "scores": scores.numpy().tolist(),
            "idx": idx.numpy().tolist()}
"""

_WORKER = _PRELUDE + _FUNCTIONS + r"""
coord, pid, dp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
init_distributed(coord, num_processes=2, process_id=pid, local_cpu_devices=2, timeout_s=60)
mesh = make_mesh(4, dp=dp)
assert len(mesh.devices.flat) == 4 and len(mesh.owned) == 2 and mesh.distributed
assert [c.rank for c in mesh.devices.flat] == [0, 0, 1, 1]
nsh = mesh.shape["shard"]
mine = sorted({s for _, s, _ in mesh.owned})
out = run(mesh, lambda x: x.reshape(nsh, -1, x.shape[1])[mine].reshape(-1, x.shape[1]))
shutdown_distributed()
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("RESULT " + json.dumps(out), flush=True)
"""

_SINGLE = _PRELUDE + _FUNCTIONS + r"""
dp = int(sys.argv[1])
print("RESULT " + json.dumps(run(make_mesh(4, dp=dp, devices=["cpu"] * 4))), flush=True)
"""

_ENGINE = r"""
from tostore_tpu_torch import (DataStoreConfig, DataType, FieldSchema, IndexSchema,
                               TableSchema, ToStoreTPU, VectorFieldConfig)
from tostore_tpu_torch.models.schema import VectorIndexConfig, VectorIndexType


def run(tmp, dp, shard):
    schema = TableSchema(
        name="docs",
        fields=(FieldSchema("emb", DataType.vector,
                            vector_config=VectorFieldConfig(dimensions=32)),),
        indexes=(IndexSchema(fields=("emb",), type="vector",
                             vector_config=VectorIndexConfig(
                                 index_type=VectorIndexType.ivf, num_clusters=8,
                                 nprobe=8, pq_subspaces=8)),),
    )
    cfg = DataStoreConfig(mesh_shape=(dp, shard), device="cpu")
    db = ToStoreTPU.open(tmp, config=cfg, schemas=[schema])
    vi = db.engine._table("docs").vector_indexes["emb"]
    vi.min_train_size = 100
    rng = np.random.default_rng(0)  # identical data on both processes
    nat, n = 12, 2000
    centers = rng.standard_normal((nat, 32)).astype(np.float32) * 4
    x = (centers[rng.integers(0, nat, n)]
         + rng.standard_normal((n, 32)) * 0.5).astype(np.float32)
    db.batch_insert("docs", [{"id": i + 1, "emb": x[i].tolist()} for i in range(n)])
    q = x[rng.integers(0, n, 8)]
    hits = [[r.primary_key for r in db.vector_search("docs", "emb", q[b], top_k=10)]
            for b in range(8)]
    assert vi.index_type == "sharded_ivf" and vi.trained and vi.pq is not None
    assert vi.bucket_codes is not None  # the contiguous ADC path, cross-process
    assert len(vi.mesh.devices.flat) == 4
    db.delete_by_pk("docs", hits[0][0])
    gone = [r.primary_key for r in db.vector_search("docs", "emb", q[0], top_k=10)]
    assert hits[0][0] not in gone
    db.close()
    db2 = ToStoreTPU.open(tmp, config=cfg, schemas=[schema])
    hits2 = [[r.primary_key for r in db2.vector_search("docs", "emb", q[b], top_k=10)]
             for b in range(8)]
    db2.close()
    return {"hits": hits, "hits2": hits2, "gone": gone}
"""

_ENGINE_WORKER = _PRELUDE + _ENGINE + r"""
from tostore_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed

coord, pid, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dp, shard = int(sys.argv[4]), int(sys.argv[5])
init_distributed(coord, num_processes=2, process_id=pid, local_cpu_devices=2, timeout_s=60)
out = run(tmp + f"/db{pid}", dp, shard)
shutdown_distributed()
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("RESULT " + json.dumps(out), flush=True)
"""

_ENGINE_SINGLE = _PRELUDE + _ENGINE + r"""
print("RESULT " + json.dumps(run(sys.argv[1] + "/single", int(sys.argv[2]), int(sys.argv[3]))),
      flush=True)
"""


def _free_port() -> str:
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()
    return addr


def _run_all(scripts_and_args):
    """Start every (script, args) at once in its own interpreter; return
    each one's RESULT. A worker that outlives 150 s is killed."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env,
                         text=True)
        for script, args in scripts_and_args
    ]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
            results.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


@pytest.mark.parametrize("dp", [1, 2])
def test_two_process_sharded_search_and_train(dp):
    coord = _free_port()
    r0, r1, one = _run_all([(_WORKER, (coord, 0, dp)), (_WORKER, (coord, 1, dp)),
                            (_SINGLE, (dp,))])
    assert r0 == r1  # every process returns the same global result
    # one process on a 4-cell mesh: the same rows win; the partial sums of
    # the Lloyd step meet in another order (rtol 1e-5)
    assert r0["idx"] == one["idx"]
    np.testing.assert_allclose(r0["scores"], one["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r0["cents"], one["cents"], rtol=1e-5, atol=1e-5)

    # the reference test's oracle: single-process exact
    rng = np.random.default_rng(0)
    n, d, k, c = 512, 32, 5, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((4, d)).astype(np.float32)
    d2 = ((x[:c][:, None, :] - x[None, :, :]) ** 2).sum(-1)
    assign = d2.argmin(0)
    cents = np.stack([
        x[assign == j].mean(0) if (assign == j).any() else x[j] for j in range(c)
    ])
    assert abs(np.sum(r0["cents"]) - cents.sum()) < 1e-2
    scores = q @ x.T
    top = np.argsort(-scores, axis=1)[:, :k]
    np.testing.assert_allclose(
        np.asarray(r0["scores"]), np.take_along_axis(scores, top, 1), rtol=1e-4, atol=1e-4
    )
    assert (np.asarray(r0["idx"]) == top).mean() > 0.95  # ties may reorder


@pytest.mark.parametrize("dp,shard", [(1, 4), (2, 2)])
def test_two_process_engine_sharded_ivf_pq(tmp_path, dp, shard):
    """Engine opened with mesh_shape across 2 processes: sharded residual-
    PQ IVF batch insert, search, delete, checkpoint + reopen. The (2, 2)
    case splits the QUERIES over dp across the processes as well."""
    coord = _free_port()
    r0, r1, one = _run_all([
        (_ENGINE_WORKER, (coord, 0, tmp_path, dp, shard)),
        (_ENGINE_WORKER, (coord, 1, tmp_path, dp, shard)),
        (_ENGINE_SINGLE, (tmp_path, dp, shard)),
    ])
    assert r0 == r1  # SPMD: identical global results
    # the reopened index answers alike (the first query's best row was deleted)
    assert r0["hits2"] == [r0["gone"]] + r0["hits"][1:]
    # one process on a 4-cell mesh: the Lloyd sums meet in another order, so
    # a row between two centroids may move and with it a borderline
    # candidate; at least 9 of 10 hits a query must be the same rows
    for key in ("hits", "hits2", "gone"):
        rows = [r0[key]] if key == "gone" else r0[key]
        ones = [one[key]] if key == "gone" else one[key]
        for a, b in zip(rows, ones):
            assert len(set(a) & set(b)) >= 9, (key, a, b)

    # the reference test's oracle: single-process exact, recall >= 0.8
    rng = np.random.default_rng(0)
    nat, n = 12, 2000
    centers = rng.standard_normal((nat, 32)).astype(np.float32) * 4
    x = (centers[rng.integers(0, nat, n)]
         + rng.standard_normal((n, 32)) * 0.5).astype(np.float32)
    q = x[rng.integers(0, n, 8)]
    d2 = np.sum((q[:, None, :] - x[None]) ** 2, axis=-1)
    ex = np.argsort(d2, axis=1)[:, :10] + 1  # pks are 1-based
    for key in ("hits", "hits2"):
        rec = np.mean([len(set(r0[key][b]) & set(ex[b].tolist())) / 10 for b in range(8)])
        assert rec >= 0.8, (key, rec)


def test_rendezvous_that_cannot_complete_fails():
    """A process group whose peer never comes must fail within its
    timeout, not wait."""
    script = _PRELUDE + r"""
from tostore_tpu_torch.parallel.mesh import init_distributed
try:
    init_distributed(sys.argv[1], num_processes=2, process_id=0, local_cpu_devices=2,
                     timeout_s=3)
except Exception as e:
    print("RESULT " + json.dumps({"failed": type(e).__name__}), flush=True)
"""
    (res,) = _run_all([(script, (_free_port(),))])
    assert res["failed"]
