"""The command refuses to run without a card, and prints no result."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cohere768-1m-flat.serial",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def _no_result(out):
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_exits_non_zero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and "CUDA" in out.stderr
    _no_result(out)


def test_exits_non_zero_beside_only_its_own_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)


def test_a_run_starts_again_with_one_interpreter_layout(tmp_path):
    """`steady_layout` re-executes the process with hash seed 0, once, and
    carries the start time over."""
    probe = tmp_path / "probe.py"
    probe.write_text("import os; print(os.environ['PYTHONHASHSEED'], "
                     "os.environ['VDBBENCH_T_START'], hash('tostore'))\n")
    code = ("import importlib.util, sys; sys.argv = [sys.argv[1]]; "
            f"s = importlib.util.spec_from_file_location('r', {str(BENCH / 'run.py')!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); m.steady_layout()")
    outs = [subprocess.run([sys.executable, "-c", code, str(probe)], capture_output=True,
                           text=True, timeout=120, env={"PATH": "/usr/bin:/bin"}).stdout
            for _ in range(2)]
    seed, start, h = outs[0].split()
    assert seed == "0" and float(start) > 0 and outs[1].split()[2] == h
