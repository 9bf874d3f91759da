"""The port's measuring scripts against the JAX package's: bench_torch.py
beside bench.py, bench_all_torch.py beside bench_all.py (its 17 configs,
each at a tiny size on the CPU, must return every key that
BENCH_REPORT.json holds for it), the exact oracles of the flat configs
beside tostore_tpu.ops.topk.flat_topk_xla on the same numpy arrays, and
_verify_drive_torch.py's steps at a small size.

Timings at these sizes mean nothing; the one-call `timeit` below only
keeps the configs short.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TOL, assert_topk_match

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench_all_torch as B  # noqa: E402
import bench_torch  # noqa: E402

torch.set_num_threads(1)

# Tiny sizes of every config. Keys that embed a size (batches, record
# counts, re-rank pools) keep the published values.
TINY = {
    "1": dict(n=4096, d=128, b=32),
    "2": dict(n=4096, d=128),
    "3": dict(n=4096, d=128, clusters=8),
    "4": dict(n=4096, d=128, b=32),
    "5": dict(),
    "6": dict(),
    "7": dict(n=4096, d=128),
    # 192 dims: divisible by both published PQ widths, M = 96 and M = 192
    "8": dict(n=1024, d=192, modes=16, clusters=4, nprobe=2),
    "9": dict(per_thread=10),
    "10": dict(n=4096, d=128, clusters=8),
    "11": dict(n=2000, d=64, step=1000, dur=0.3, rel_dur=0.2),
    "11b": dict(n=2000, d=64, step=1000, reps=20, dur=0.3),
    "12": dict(n_rel=20_000, n_vec=2_000, d=64, step=10_000, vstep=1_000, tail_rows=2_000),
    "13": dict(n=20_000, step=10_000, pairs=20),
    "14": dict(n=5_000, step=2_500, writes=100),
    "15": dict(nu=1000, no=5000, step=2500, n_cats=500),
    "16": dict(n=2000, gets=500, sets=500, incrs=100, ttl_keys=500),
}


def _reference_configs():
    """{config name: the `config` string its function returns}, read from
    bench_all.py's source (importing it would start JAX's TPU setup)."""
    tree = ast.parse((REPO / "bench_all.py").read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    table = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and any(getattr(t, "id", None) == "CONFIGS" for t in n.targets))
    out = {}
    for key, val in zip(table.keys, table.values):
        for node in ast.walk(funcs[val.id]):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == "config" \
                            and isinstance(v, ast.Constant):
                        out[key.value] = v.value
    return out


REF_CONFIGS = _reference_configs()
REPORT = json.loads((REPO / "BENCH_REPORT.json").read_text())


@pytest.fixture
def one_call_timeit(monkeypatch):
    orig = B.timeit
    monkeypatch.setattr(B, "timeit", lambda fn, *a, reps=30, trials=3: orig(fn, *a, reps=1,
                                                                            trials=1))


def test_configs_are_the_reference_configs():
    assert list(B.CONFIGS) == list(REF_CONFIGS)
    assert set(TINY) == set(B.CONFIGS)


def _missing_keys(ref: dict, got: dict, path=""):
    out = []
    for key, val in ref.items():
        name = B.RENAMED.get(key, key)
        if name not in got:
            out.append(path + name)
        elif isinstance(val, dict):
            out += _missing_keys(val, got[name], f"{path}{name}.")
    return out


@pytest.mark.parametrize("name", list(TINY))
def test_config_returns_the_reference_keys(name, one_call_timeit):
    res = B.CONFIGS[name](device="cpu", **TINY[name])
    assert res["config"] == REF_CONFIGS[name]
    assert not _missing_keys(REPORT[res["config"]], res)
    assert not [k for k in B.RENAMED if k in res]
    json.dumps(res)  # one JSON line, as the child prints it
    if name == "5":
        assert res["dryrun_ok"] is True and set(res["dryrun_launches"]) >= {"ivf_adc"}
    if name in ("1", "4"):
        assert min(v for k, v in res.items() if "recall" in k) >= 0.999
    if name == "4":
        assert res["all_hits_satisfy_predicate"] is True


# --------------------------------------------------------------------------
# The exact oracles of configs 1, 2, 4 and 7 against the JAX package's
# --------------------------------------------------------------------------


def _jax_exact(q, corpus, bias, alpha, k, dtype):
    from tostore_tpu.ops import topk as J

    c = jnp.asarray(corpus)
    if dtype == "bfloat16":
        c = c.astype(jnp.bfloat16)
    s, i = J.flat_topk_xla(jnp.asarray(q), c, jnp.asarray(bias), alpha, k)
    return np.asarray(s), np.asarray(i)


def _np32(t):
    return t.float().numpy()


K = 10


def test_config1_oracle_matches_reference():
    from tostore_tpu_torch.ops import topk

    q, corpus, bias = B.config1_data(4096, 128, 32, torch.device("cpu"))
    s, i = topk.flat_topk_xla(q, corpus, bias, 1.0, K)
    js, ji = _jax_exact(_np32(q), _np32(corpus), _np32(bias), 1.0, K, "float32")
    assert_topk_match(s.numpy(), i.numpy(), js, ji, TOL["float32"])


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_config2_oracle_matches_reference(metric):
    from tostore_tpu_torch.ops import topk

    dev = torch.device("cpu")
    corpus, norms = B.config2_data(4096, 128, dev)
    q = B.config2_queries(128, 128, dev)
    bias, alpha = (torch.zeros(4096), 1.0) if metric == "dot" else (-norms, 2.0)
    s, i = topk.flat_topk_xla(q, corpus, bias, alpha, K)
    js, ji = _jax_exact(_np32(q), _np32(corpus), _np32(bias), alpha, K, "bfloat16")
    assert_topk_match(s.numpy(), i.numpy(), js, ji, TOL["bfloat16"])


def test_config4_oracle_matches_reference():
    from tostore_tpu_torch.ops import topk

    q, corpus, bias, sel = B.config4_data(4096, 128, 32, torch.device("cpu"))
    assert 0.2 < float(sel.float().mean()) < 0.3
    s, i = topk.flat_topk_xla(q, corpus, bias, 1.0, K)
    js, ji = _jax_exact(_np32(q), _np32(corpus), _np32(bias), 1.0, K, "bfloat16")
    assert_topk_match(s.numpy(), i.numpy(), js, ji, TOL["bfloat16"])
    assert sel.numpy()[i.numpy().ravel()].all()


def test_config7_quantization_and_oracle_match_reference():
    """The int8 rows and scales are the reference's quantization of the same
    f32 rows, and the bf16 search that `top10_agreement_vs_bf16` holds
    them to is the exact scan at this size on both sides."""
    from tostore_tpu_torch.ops import topk

    n, d = 4096, 128
    q, corpus, scales, xb = B.config7_data(n, d, 128, torch.device("cpu"))
    x = jnp.asarray(np.concatenate([c for _, c in bench_torch.normal_chunks(B.SEED, n, d)]))
    amax = jnp.max(jnp.abs(x), axis=1)
    jscales = jnp.where(amax > 0, amax / 127.0, 1.0 / 127.0)
    jcorpus = jnp.clip(jnp.round(x / jscales[:, None]), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(corpus.numpy(), np.asarray(jcorpus))
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=1e-7)
    bias = torch.zeros(n)
    s, i = topk.flat_search(q, xb, bias, k=K)
    js, ji = _jax_exact(_np32(q), np.asarray(x), np.zeros(n, np.float32), 1.0, K, "bfloat16")
    assert_topk_match(s.numpy(), i.numpy(), js, ji, TOL["bfloat16"])


# --------------------------------------------------------------------------
# bench_torch.py beside bench.py; _verify_drive_torch.py
# --------------------------------------------------------------------------

# bench.py as it is, with JAX's persistent compile cache left off (it would
# write outside the checkout)
_RUN_BENCH = (
    "import jax, runpy\n"
    "update = jax.config.update\n"
    "jax.config.update = lambda k, v: None if 'cache' in k else update(k, v)\n"
    "runpy.run_path('bench.py', run_name='__main__')\n"
)


def _last_json(stdout: str) -> dict:
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])


def test_bench_torch_cpu_line_matches_bench_py():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    ref = subprocess.run([sys.executable, "-c", _RUN_BENCH], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_line = _last_json(ref.stdout)
    assert "error" not in ref_line, ref_line
    port = subprocess.run([sys.executable, "bench_torch.py", "--device", "cpu"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr[-2000:]
    line = _last_json(port.stdout)
    assert set(line) - set(ref_line) == {"device"} and set(ref_line) <= set(line)
    assert line["metric"] == ref_line["metric"] == "flat_knn_qps_b8_4096x128_bf16_top10"
    assert line["unit"] == "QPS" and line["value"] > 0
    assert line["device"]["name"] == "cpu" and line["device"]["torch"] == torch.__version__


def test_bench_torch_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would measure it")
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"value": 0' not in r.stdout and not r.stdout.strip()


def test_bench_all_torch_child_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the config would run on it")
    r = subprocess.run([sys.executable, "bench_all_torch.py", "4"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "{" not in r.stdout


def test_verify_drive_steps_on_cpu(capsys):
    import _verify_drive_torch as v

    v.drive(device="cpu", rows=2000, tail=200)
    out = capsys.readouterr().out
    assert out.strip().endswith("VERIFY DRIVE OK")
    assert "recovered_wal_entries: 1" in out
