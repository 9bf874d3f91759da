"""The port imports neither JAX nor tostore_tpu (nor ml_dtypes, which comes
with JAX): a GPU machine with PyTorch and numpy alone must run it. A fresh
interpreter blocks those packages with a sys.meta_path finder, then
imports tostore_tpu_torch and runs CPU searches (flat and IVF-PQ),
snapshot round trips, and the engine through the facade: a memory and a
file database, inserts, searches, a checkpoint of a bf16 corpus (written
as dtype code 8 without ml_dtypes) and a reopen; then the sharded indexes
and a `mesh_shape` database on a mesh of 4 CPU cells.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent("""
    import importlib.abc, sys

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
    import tostore_tpu_torch
    from tostore_tpu_torch import FlatVectorIndex
    from tostore_tpu_torch.ops import _kernels, distance, runtime, topk

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 96)).astype(np.float32)
    idx = FlatVectorIndex(96, "l2", "bfloat16", device="cpu")
    idx.upsert(list(range(3000)), x)
    idx.delete([5, 6])
    hits = idx.search(x[7], top_k=3)
    assert hits[0].primary_key == 7, hits
    d, s, p = idx.search_arrays(x[:40], 10, mode="fused")
    assert (p[:, 0] == np.arange(40)).sum() >= 38
    state = idx.state_dict()
    # bf16 rows stay 2 bytes a value without ml_dtypes (utils/bf16.py)
    assert state["corpus"]["vectors"].dtype.name == "bfloat16"
    assert state["corpus"]["vectors"].nbytes == 3000 * 128 * 2 - 2 * 128 * 2
    again = FlatVectorIndex.from_state_dict(state, device="cpu")
    assert again.search(x[7], top_k=1)[0].primary_key == 7

    from tostore_tpu_torch.query import QueryCondition
    from tostore_tpu_torch.vector import filters
    slots = idx.corpus.slots_for_pks(list(range(3000)))
    live = np.flatnonzero(slots >= 0)
    fc = idx.corpus.filter_columns
    fc.update("ts", slots[live], (1_700_000_000_000 + live).tolist(), idx.corpus.capacity,
              kind="int")
    cond = QueryCondition().where("ts", ">=", 1_700_000_000_100)
    assert filters.compilable(cond, fc.names())
    mask = filters.device_mask(cond, fc, idx.corpus.capacity)
    d, s, p = idx.search_arrays(x[:3], 5, slot_mask=mask)
    assert (p >= 100).all(), p
    c = idx.corpus.vectors
    bias, alpha, _ = idx._bias_alpha(mask)
    qt, _, _ = idx._prep_queries(x[200:203])
    assert topk._fused_group_emit(qt, c, bias, k=1, alpha=alpha, blk_n=2048)[1][0, 0] == slots[200]
    assert topk.pipe_topk(qt, c, bias, k=1, alpha=alpha, gsz=2)[1][0, 0] == slots[200]

    from tostore_tpu_torch import IVFVectorIndex
    from tostore_tpu_torch.ops import ivfprobe
    ivf = IVFVectorIndex(96, "l2", "bfloat16", num_clusters=8, nprobe=4, pq_subspaces=16,
                         min_train_size=100, device="cpu")
    ivf.upsert(list(range(3000)), x)
    assert ivf.pq is not None and ivf.bucket_codes is not None and ivf._pack_nibbles
    assert ivf.search(x[7], top_k=1, mode="probe")[0].primary_key == 7
    ivf.delete([7])
    assert ivf.search(x[7], top_k=1, mode="probe")[0].primary_key != 7
    state = ivf.state_dict()
    assert state["corpus"]["vectors"].dtype.name == "bfloat16" and state["pq"] is not None
    again = IVFVectorIndex.from_state_dict(state, device="cpu")
    assert again.search(x[8], top_k=1, mode="probe")[0].primary_key == 8
    # the engine through the facade: memory and file databases
    import tempfile
    from tostore_tpu_torch import (DataType, FieldSchema, IndexSchema, TableSchema, ToStoreTPU,
                                   VectorFieldConfig, VectorIndexConfig, native)
    from tostore_tpu_torch.utils import codec
    schema = TableSchema(
        name="docs",
        fields=(FieldSchema("price", DataType.double),
                FieldSchema("emb", DataType.vector,
                            vector_config=VectorFieldConfig(dimensions=96, precision="bfloat16"))),
        indexes=(IndexSchema(fields=("emb",), type="vector",
                             vector_config=VectorIndexConfig(index_type="flat", metric="l2")),),
    )
    recs = [{"price": float(i % 50), "emb": x[i]} for i in range(600)]
    mem = ToStoreTPU.memory(schemas=[schema], device="cpu")
    assert mem.batch_insert("docs", recs).is_success
    assert mem.vector_search("docs", "emb", x[7], top_k=1)[0].primary_key == 8
    hits = mem.vector_search("docs", "emb", x[7], top_k=3,
                             condition=QueryCondition().where("price", ">", 20.0))
    assert hits and all(mem.get_by_pk("docs", h.primary_key)["price"] > 20.0 for h in hits)
    assert mem.query("docs").where("price", "=", 3.0).count() == 12
    mem.close()
    path = tempfile.mkdtemp()
    db = ToStoreTPU.open(path, schemas=[schema], device="cpu")
    assert db.batch_insert("docs", recs).is_success
    db.flush()  # the checkpoint: the bf16 corpus goes out as dtype code 8
    snap = open(path + "/default/tables/default@docs.snap", "rb").read()
    state = codec._py_loads(next(iter(codec.iter_frames(snap))))
    vecs = state["vector_indexes"]["emb"]["corpus"]["vectors"]
    assert vecs.dtype.name == "bfloat16" and vecs.shape == (600, 128)
    assert len(snap) < 600 * (96 * 4 + 128 * 2 + 64)
    db.insert("docs", {"price": 1.0, "emb": x[700]})  # lives only in the WAL
    want = [h.primary_key for h in db.vector_search("docs", "emb", x[700], top_k=3)]
    assert want[0] == 601
    db.engine._wal.close(); db.engine._crontab.stop()  # a hard drop: no close()
    del db
    db = ToStoreTPU.open(path, device="cpu")
    assert db.engine._counters["recovered_wal_entries"] == 1
    assert [h.primary_key for h in db.vector_search("docs", "emb", x[700], top_k=3)] == want
    assert db.count("docs") == 601
    db.close()
    assert native.which() in ("native", "python")
    # the sharded indexes on a mesh of 4 CPU cells, (2, 2)
    from tostore_tpu_torch.parallel import ShardedFlatIndex, make_mesh
    from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
    mesh = make_mesh(4, dp=2, devices=["cpu"] * 4)
    sh = ShardedFlatIndex(96, mesh, "l2", "bfloat16")
    sh.upsert(list(range(3000)), x)
    d, p = sh.search_arrays(x[:5], 3)
    assert p[:, 0].tolist() == [0, 1, 2, 3, 4]
    assert sh.state_dict()["vectors"].dtype.name == "bfloat16"
    siv = ShardedIVFIndex(96, mesh, "l2", "bfloat16", num_clusters=8, nprobe=4,
                          pq_subspaces=16, min_train_size=100)
    siv.upsert(list(range(3000)), x)
    assert siv.bucket_codes is not None and siv.search(x[7], top_k=1)[0].primary_key == 7
    mdb = ToStoreTPU.memory(schemas=[schema], device="cpu", mesh_shape=(4,))
    assert mdb.batch_insert("docs", recs).is_success
    assert mdb.engine._table("docs").vector_indexes["emb"].index_type == "sharded_flat"
    assert mdb.vector_search("docs", "emb", x[7], top_k=1)[0].primary_key == 8
    mdb.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("OK")
""")


def test_port_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_jax_or_reference_imports_in_sources():
    for path in (REPO / "tostore_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "tostore_tpu", "ml_dtypes"), f"{path}: {s}"


def test_port_exports_the_reference_names():
    import tostore_tpu
    import tostore_tpu_torch

    missing = [n for n in tostore_tpu.__all__ if not hasattr(tostore_tpu_torch, n)
               or n not in tostore_tpu_torch.__all__]
    assert not missing, missing


def test_parallel_exports_the_reference_names():
    import tostore_tpu.parallel as ref
    import tostore_tpu_torch.parallel as port
    from tostore_tpu_torch.parallel import mesh, sharded, sharded_ivf

    # the reference's NamedSharding spec helpers have no counterpart: the
    # port builds `mesh.Striped` / `mesh.Replicated` values directly
    specs = {"corpus_sharding", "query_sharding", "replicated"}
    assert port.__all__ == [n for n in ref.__all__ if n not in specs]
    assert all(hasattr(port, n) for n in port.__all__)
    for mod, names in ((mesh, ("init_distributed", "host_local_to_global", "read_to_host",
                               "replicated_from_host", "make_mesh", "shard_count", "Striped",
                               "Replicated")),
                       (sharded, ("sharded_flat_topk", "sharded_kmeans", "sharded_kmeans_step",
                                  "state_vectors_f32", "ShardedFlatIndex")),
                       (sharded_ivf, ("_sharded_ivf_assign", "_sharded_ivf_place",
                                      "_sharded_bucket_bias", "_sharded_bucket_codes",
                                      "_merge_local_topk", "ShardedIVFIndex"))):
        assert not [n for n in names if not hasattr(mod, n)], mod.__name__


def test_port_mirrors_the_reference_layout():
    """Every module of the JAX package has its counterpart in the port,
    under the same file name, parallel/ included."""
    ref = {p.relative_to(REPO / "tostore_tpu").as_posix()
           for p in (REPO / "tostore_tpu").rglob("*.py")}
    port = {p.relative_to(REPO / "tostore_tpu_torch").as_posix()
            for p in (REPO / "tostore_tpu_torch").rglob("*.py")}
    assert ref - port == set()
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/sharded.py",
            "parallel/sharded_ivf.py"} <= port


# The port's measuring scripts at the root and in experiments/: the same rule as the
# package, read from the source (a nested import or an __import__ string
# counts too), and run in an interpreter that blocks the forbidden packages.
SCRIPTS = sorted(
    [REPO / n for n in ("bench_torch.py", "bench_all_torch.py", "_verify_drive_torch.py",
                        "__graft_entry_torch__.py", "chip_smoke.py")]
    + list((REPO / "experiments").glob("*_torch.py"))
)
FORBIDDEN = ("jax", "jaxlib", "tostore_tpu", "ml_dtypes")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_bench_scripts_import_no_jax_or_reference():
    assert len(SCRIPTS) == 12, SCRIPTS
    for path in SCRIPTS:
        tree = ast.parse(path.read_text())
        bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.name}: {bad}"


def _import_time_statements(tree):
    """Statements that run when the module is imported: the module body
    outside function and class bodies and the `if __name__ == "__main__"`
    block."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(node, ast.If) and "__main__" in ast.unparse(node.test):
            continue
        yield node
        todo.extend(c for c in ast.iter_child_nodes(node) if isinstance(c, ast.stmt))


def test_no_global_torch_state_at_import():
    """Importing the port or a measuring script sets no process-wide torch state (TF32,
    cudnn.benchmark, matmul precision): callers and tests own it."""
    sources = SCRIPTS + sorted((REPO / "tostore_tpu_torch").rglob("*.py"))
    for path in sources:
        for node in _import_time_statements(ast.parse(path.read_text())):
            for sub in ast.walk(node):
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target] if isinstance(sub, (ast.AugAssign, ast.AnnAssign))
                           else [])
                for t in targets:
                    assert not ast.unparse(t).startswith("torch.backends"), \
                        f"{path.name}:{sub.lineno}: {ast.unparse(sub)}"
                if isinstance(sub, ast.Call):
                    fn = ast.unparse(sub.func)
                    assert not fn.startswith(("torch.backends", "torch.set_float32_matmul")), \
                        f"{path.name}:{sub.lineno}: {fn}"


_BENCH_SCRIPT = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "tostore_tpu", "ml_dtypes")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    torch.set_num_threads(1)
    import bench_all_torch, bench_torch, _verify_drive_torch
    res = bench_all_torch.config4_hybrid(device="cpu", n=4096, d=128)
    assert res["all_hits_satisfy_predicate"], res
    assert bench_torch.run("cpu")["value"] > 0
    _verify_drive_torch.drive(device="cpu", rows=1500, tail=100)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("OK")
""")


def test_bench_scripts_run_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BENCH_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


# The JAX package's own test suites on the port: every reference test file
# either runs unchanged through tests/torch_suites.py (one shim each) or is
# named in its CARRIED_BY table with the port tests that carry it, so that a
# suite added later cannot be forgotten.
TESTS = REPO / "tests"


def _shim_suites():
    """{shim file name: the suite its load() call names}."""
    out = {}
    for path in sorted(TESTS.glob("test_torch_suite_*.py")):
        calls = [n for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "load"]
        assert len(calls) == 1, path.name
        out[path.name] = calls[0].args[0].value
    return out


def test_every_reference_suite_has_a_shim_or_carrier():
    import torch_suites as ts

    ref = {p.stem for p in TESTS.glob("test_*.py") if not p.name.startswith("test_torch_")}
    shims = _shim_suites()
    assert {f"test_torch_suite_{s[len('test_'):]}.py": s for s in ts.SUITES} == shims
    assert set(ts.SUITES).isdisjoint(ts.CARRIED_BY)
    assert ref == set(ts.SUITES) | set(ts.CARRIED_BY), ref ^ (set(ts.SUITES) | set(ts.CARRIED_BY))
    # the suites that build vector tables are the ones the smoke runs on the card
    vector = re.compile(r"DataType\.vector|VectorIndex|vector_search")
    assert set(ts.VECTOR_SUITES) == {s for s in ts.SUITES
                                     if vector.search((TESTS / f"{s}.py").read_text())}
    for carriers in ts.CARRIED_BY.values():
        assert all((TESTS / f).is_file() for f in carriers), carriers


def test_excluded_cases_exist_and_have_hand_counterparts():
    import torch_suites as ts

    def cases(path):
        tree = ast.parse(path.read_text())
        out = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
            out |= {f"{cls.name}::{f.name}" for f in cls.body if isinstance(f, ast.FunctionDef)}
        return out

    for suite, excluded in ts.EXCLUDED.items():
        assert suite in ts.SUITES
        ref = cases(TESTS / f"{suite}.py")
        shim = cases(TESTS / f"test_torch_suite_{suite[len('test_'):]}.py")
        for case, (reason, replacement) in excluded.items():
            assert case in ref and reason, case
            assert replacement in shim, replacement


def test_suite_loader_and_shims_import_no_jax_or_reference():
    for path in [TESTS / "torch_suites.py", *sorted(TESTS.glob("test_torch_suite_*.py"))]:
        tree = ast.parse(path.read_text())
        bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.name}: {bad}"


def test_suite_rewrite_raises_on_leftover_jax():
    import pytest
    import torch_suites as ts

    src = "import jax\njax.config.update('jax_platforms', 'cpu')\nfrom tostore_tpu import X\n"
    assert ts.rewrite("t", src, "cpu") == "pass\npass\nfrom tostore_tpu_torch import X\n"
    with pytest.raises(RuntimeError, match="refers to JAX"):
        ts.rewrite("t", "import jax.numpy as jnp\n", "cpu")
    with pytest.raises(RuntimeError, match="refers to JAX"):
        ts.rewrite("t", "x = jnp.zeros(3)\n", "cpu")


def test_suite_device_is_test_only(monkeypatch):
    import pytest
    import torch_suites as ts

    from tostore_tpu_torch.models.config import DataStoreConfig

    monkeypatch.delenv(ts.DEVICE_VAR, raising=False)
    assert ts.suite_device() == "cpu"
    if not torch.cuda.is_available():
        monkeypatch.setenv(ts.DEVICE_VAR, "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.suite_device()
    undo = ts.set_default_device("cpu")
    try:
        assert DataStoreConfig().device == "cpu"
        assert DataStoreConfig(device="meta").device == "meta"
    finally:
        undo()
    assert DataStoreConfig().device == "cuda"
    for path in (REPO / "tostore_tpu_torch").rglob("*.py"):
        assert ts.DEVICE_VAR not in path.read_text(), path


def test_smoke_runs_the_vector_suites_on_the_card():
    """chip_smoke.py phase 12a runs exactly the loader's vector suites (it
    does not import the loader, which sets torch's thread count)."""
    import torch_suites as ts

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    value = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and [ast.unparse(t) for t in n.targets] == ["SUITES_ON_CARD"])
    assert ast.literal_eval(value) == ts.VECTOR_SUITES
