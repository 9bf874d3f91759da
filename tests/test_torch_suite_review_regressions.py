"""The JAX package's tests/test_review_regressions.py, run unchanged on the
port (tests/torch_suites.py says how), and below it, carried by hand, the
cases that build a mesh of 8 cells: on the port `make_mesh` takes the
cells' devices (8 cells of the suite's device). Each asserts what its
reference case asserts."""

import numpy as np

from torch_suites import load, suite_device

load("test_review_regressions", globals())

DEVICE = suite_device()


def _mesh(dp):
    from tostore_tpu_torch.parallel import make_mesh

    return make_mesh(8, dp=dp, devices=[DEVICE] * 8)


class TestShardedIvfRetrainNoDuplicatesPort:
    def test_training_batch_not_double_appended(self, rng):
        from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        idx = ShardedIVFIndex(16, _mesh(1), metric="l2", num_clusters=8, nprobe=8,
                              min_train_size=64)
        x = rng.standard_normal((100, 16)).astype(np.float32)
        idx.upsert(list(range(100)), x)
        assert idx.trained
        assert int(idx._bucket_counts.sum()) == 100
        buckets = np.asarray(idx.buckets)
        entries = buckets[buckets >= 0]
        assert len(entries) == 100
        dists, pks = idx.search_arrays(x[0], k=10, nprobe=8)
        found = [p for p in pks[0] if p is not None]
        assert len(found) == len(set(found)), f"duplicate pks: {found}"

    def test_force_retrain_at_growth_not_double_appended(self, rng):
        from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        idx = ShardedIVFIndex(16, _mesh(1), metric="l2", num_clusters=8, nprobe=8,
                              min_train_size=32)
        x = rng.standard_normal((200, 16)).astype(np.float32)
        idx.upsert(list(range(40)), x[:40])
        idx.upsert(list(range(40, 200)), x[40:])
        assert int(idx._bucket_counts.sum()) == 200
        dists, pks = idx.search_arrays(x[50], k=10, nprobe=8)
        found = [p for p in pks[0] if p is not None]
        assert len(found) == len(set(found)), f"duplicate pks: {found}"


class TestRound3ReviewFindingsPort:
    def test_sharded_compact_preserves_defer_retrain(self, rng):
        from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        idx = ShardedIVFIndex(16, _mesh(2), metric="l2", num_clusters=8, min_train_size=100)
        idx.defer_retrain = True
        x = rng.standard_normal((500, 16)).astype(np.float32)
        idx.upsert(list(range(500)), x)
        idx.delete(list(range(100)))
        idx.compact()
        assert idx.defer_retrain

    def test_sharded_search_distance_parity_after_host_conversion(self, rng):
        from tostore_tpu_torch.parallel.sharded import ShardedFlatIndex

        idx = ShardedFlatIndex(16, _mesh(2), metric="l2")
        x = rng.standard_normal((300, 16)).astype(np.float32)
        idx.upsert(list(range(300)), x)
        d, pks = idx.search_arrays(x[42], k=1)
        assert pks[0][0] == 42 and abs(float(d[0][0])) < 1e-2


def test_port_sharded_arrays_convert_like_global_arrays():
    """np.asarray of a sharded index's striped or replicated state is its
    global value, as for the reference's sharded jax Arrays (the first
    hand-carried case reads `np.asarray(idx.buckets)`)."""
    from tostore_tpu_torch.parallel.mesh import Replicated, Striped

    mesh = _mesh(2)
    g = np.arange(16 * 3, dtype=np.int32).reshape(16, 3)
    assert np.array_equal(np.asarray(Striped.from_global(mesh, g)), g)
    assert np.asarray(Striped.from_global(mesh, g), np.float32).dtype == np.float32
    assert np.array_equal(np.asarray(Replicated(mesh, g)), g)
