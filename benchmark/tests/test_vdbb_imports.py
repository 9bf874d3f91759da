"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level name: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tostore_tpu"}
PROGRAM = "tostore_tpu_torch"
# the modules that may import the program: the system under test alone
SYSTEM = {BENCH / "vdbbench" / "system.py"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import_and_program_only_in_the_system(path):
    names = top_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path not in SYSTEM:
        assert PROGRAM not in names, f"{path.name} imports the program"


def test_a_run_loads_no_forbidden_module():
    """A whole run at a tiny size on the CPU, then the process's modules."""
    code = f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
from vdbbench import harness
small = {{"rows": 4096, "dims": 32, "load_chunk": 2048,
          "data": {{"generator": "clustered", "modes": 8, "centre_scale": 3.0, "noise": 1.0}}}}
r = harness.run_cell("cohere768-1m-flat.serial", 9, 0.2, False, device="cpu",
                     config_patch=small, traffic_patch={{"pool": 64, "warmup_requests": 2}})
print(json.dumps({{"correct": r["correct"], "found": harness.forbidden_modules(),
                  "program": "tostore_tpu_torch" in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": [], "program": True}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from vdbbench import harness

    monkeypatch.setitem(sys.modules, "tostore_tpu_torch_x", sys)
    assert "tostore_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
