"""The plain reference against a brute-force NumPy top-k, the documented
candidate rule, the judge's verdicts, the generator and the roofline
arithmetic."""

import numpy as np
import pytest
import torch

from vdbbench import datagen, reference, roofline

DATA = {"generator": "clustered", "modes": 20, "centre_scale": 3.0, "noise": 1.0}


def _config(n=6000, d=32, k=10, rule=None, limits=None):
    check = {"limits": limits or {"dist_err": 1e-5, "gap": 1e-5, "bad": 0}}
    if rule:
        check["candidate_rule"] = rule
    return {"rows": n, "dims": d, "top_k": k, "metric": "cosine", "precision": "bfloat16",
            "check": check}


def _brute(mix, n, queries, k, keep_from=0):
    """Exact cosine top-k in NumPy over the bf16-rounded unit rows."""
    rows = torch.cat([r for _, r in mix.rows(n)])
    unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True))  # noqa: E731
    r = torch.from_numpy(unit(rows.numpy())).to(torch.bfloat16).double().numpy()
    q = torch.from_numpy(unit(queries)).to(torch.bfloat16).double().numpy()
    s = q @ r.T
    s[:, :keep_from] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return order, s


@pytest.mark.parametrize("keep_from", [0, 5400])
def test_exact_top_k_equals_brute_force(keep_from):
    cfg = _config()
    mix = datagen.Mixture(DATA, cfg["dims"], 3, "cpu")
    q = mix.queries(16).numpy()
    order, s = _brute(mix, cfg["rows"], q, cfg["top_k"], keep_from)
    pks = order + 1
    dists = 1.0 - np.take_along_axis(s, order, 1)
    out = reference.judge(cfg, mix, q, pks, dists, np.full(16, cfg["top_k"]), keep_from)
    assert out["recall"] == 1.0 and out["numbers"]["bad"] == 0
    assert out["numbers"]["dist_err"] < 1e-6 and out["numbers"]["gap"] == 0.0
    blk = reference.score_block(cfg, mix, torch.from_numpy(q), torch.from_numpy(pks), keep_from)
    assert (blk["exact_pos"].numpy() == order).all()


def test_rule_kth_with_constructed_bucket():
    """Rows made so that the top 3 share bucket (0, 0): the documented rule
    keeps two of them, so its 3rd best is the 4th true row, and an answer
    that misses the true 3rd is not held against it."""
    cfg = _config(n=64, d=4, k=3, rule={"block_rows": 16, "lanes": 4, "per_bucket": 2})

    class Fixed:
        device = torch.device("cpu")

        def rows(self, n):
            x = torch.full((64, 4), 0.0)
            x[:, 1] = 1.0
            for j, p in enumerate((0, 4, 8, 1)):  # 0, 4, 8: bucket (0, 0); 1: bucket (0, 1)
                x[p] = torch.tensor([1.0, 0.05 * (j + 1), 0.0, 0.0])
            yield 0, x

    q = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
    blk = reference.score_block(cfg, Fixed(), torch.from_numpy(q), torch.zeros((1, 3), dtype=torch.long), 0)
    assert blk["exact_pos"][0].tolist() == [0, 4, 8]
    s = reference._prepared(torch.tensor([[1.0, 0.2, 0.0, 0.0]]), "cosine", "bfloat16")
    assert blk["kth"][0].item() == pytest.approx(float(s[0, 0]), abs=1e-12)


def test_judge_flags_altered_short_duplicate_and_filtered_answers():
    cfg = _config()
    mix = datagen.Mixture(DATA, cfg["dims"], 4, "cpu")
    q = mix.queries(5).numpy()
    order, s = _brute(mix, cfg["rows"], q, 10)
    pks = order + 1
    dists = 1.0 - np.take_along_axis(s, order, 1)
    counts = np.full(5, 10)
    pks[0, 9] = pks[0, 9] % cfg["rows"] + 777  # a row that is far from the query
    pks[1, 3] = pks[1, 2]  # twice
    counts[2] = 9  # short
    dists[3] = dists[3][::-1]  # out of order
    out = reference.judge(cfg, mix, q, pks, dists, counts)
    assert out["wrong"].tolist() == [True, True, True, True, False]
    assert out["numbers"]["bad"] == 3 and out["numbers"]["gap"] > 1e-3
    assert out["numbers"]["dist_err"] > 1e-3
    out = reference.judge(cfg, mix, q[4:], pks[4:], dists[4:], counts[4:], keep_from=5000)
    assert out["numbers"]["bad"] == (pks[4] <= 5000).any()


def test_generator_repeats_per_seed_and_chunk():
    a = datagen.Mixture(DATA, 16, 2**33 + 5, "cpu")
    b = datagen.Mixture(DATA, 16, 2**33 + 5, "cpu")
    ra = torch.cat([r for _, r in a.rows(3000, chunk=1024)])
    rb = torch.cat([r for _, r in b.rows(3000, chunk=1024)])
    assert torch.equal(ra, rb) and torch.equal(a.queries(50), b.queries(50))
    c = datagen.Mixture(DATA, 16, 2**33 + 6, "cpu")
    assert not torch.equal(ra, torch.cat([r for _, r in c.rows(3000, chunk=1024)]))
    assert not torch.equal(a.queries(50), a.queries(50, "warmup"))


def test_roofline_of_the_main_corpus_by_hand():
    n, d = 1_048_576, 768
    nbytes, flops = roofline.scan_work(n, d, "bfloat16", 1, 100)
    assert nbytes == 1_610_612_736 + 768 * 2 + 100 * 8
    assert flops == 2 * n * d
    ms, by = roofline.bound_ms(nbytes, flops, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(1_610_614_336 / 3.35e12 * 1e3)
    nbytes, flops = roofline.scan_work(n, d, "bfloat16", 256, 100)
    assert roofline.bound_ms(nbytes, flops, "bfloat16")[1] == "bytes"
    assert flops / 989e12 * 1e3 == pytest.approx(0.4169, abs=1e-4)
    cfg = {"rows": n, "dims": d, "top_k": 100, "precision": "bfloat16",
           "index": {"index_type": "ivf", "num_clusters": 1024, "nprobe": 16}}
    per_q = 16 * 1024 * d * 2 + 1024 * d * 4 + d * 2 + 800
    assert roofline.least_ms_per_query(cfg, 1) == pytest.approx(per_q / 3.35e12 * 1e3)
    cfg["index"]["pq_subspaces"] = 192
    assert roofline.least_ms_per_query(cfg, 1) is None
