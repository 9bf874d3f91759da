"""The port imports neither JAX nor tostore_tpu (nor ml_dtypes, which comes
with JAX): a GPU machine with PyTorch and numpy alone must run it. A fresh
interpreter blocks those packages with a sys.meta_path finder, then
imports tostore_tpu_torch and runs a CPU search and a snapshot round trip.
"""

import os
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
    assert state["corpus"]["vectors"].dtype == np.float32  # no ml_dtypes here
    again = FlatVectorIndex.from_state_dict(state, device="cpu")
    assert again.search(x[7], top_k=1)[0].primary_key == 7
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("OK")
""")


def test_port_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_jax_or_reference_imports_in_sources():
    for path in (REPO / "tostore_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "tostore_tpu"), f"{path}: {s}"
