"""The JAX package's tests/test_surface_r4.py, run unchanged on the port
(tests/torch_suites.py says how), and below it, carried by hand, the cases
that build an IVFVectorIndex by itself: the port's index needs its device.
Each asserts what its reference case asserts. The dispatch cases take the
CPU, where the port's cost model keeps the reference's constants
(`IVFVectorIndex._route_costs`); the others the suite's device."""

from types import SimpleNamespace

import numpy as np
import torch

from torch_suites import load, suite_device

load("test_surface_r4", globals())

DEVICE = suite_device()


class TestSearchModePort:
    def test_ivf_exact_bypasses_probe(self):
        from tostore_tpu_torch.vector.ivf import IVFVectorIndex

        rng = np.random.default_rng(1)
        x = rng.standard_normal((600, 32)).astype(np.float32)
        idx = IVFVectorIndex(32, metric="l2", num_clusters=16, nprobe=1,
                             min_train_size=64, device=DEVICE)
        idx.upsert(list(range(600)), x)
        q = x[17] + 0.001
        d_ex, s_ex, pk_ex = idx.search_arrays(q, 10, mode="exact")
        d2 = np.sum((x - q) ** 2, axis=1)
        oracle = np.argsort(d2, kind="stable")[:10]
        assert list(pk_ex[0]) == list(oracle)
        d_auto, _, pk_auto = idx.search_arrays(q, 10)
        assert pk_ex[0][0] == 17


class TestAutoPQDefaultPort:
    def test_default_resolves_to_4bit_k16(self):
        from tostore_tpu_torch.vector.ivf import IVFVectorIndex

        rng = np.random.default_rng(2)
        x = rng.standard_normal((700, 32)).astype(np.float32)
        idx = IVFVectorIndex(32, metric="l2", num_clusters=8,
                             pq_subspaces=16, min_train_size=64, device=DEVICE)
        assert idx.pq_centroids == 0
        idx.upsert(list(range(700)), x)
        assert idx.pq is not None and idx.pq.k == 16
        assert idx._pack_nibbles

    def test_explicit_k_respected_and_odd_m_falls_back(self):
        from tostore_tpu_torch.vector.ivf import IVFVectorIndex

        idx = IVFVectorIndex(32, pq_subspaces=16, pq_centroids=256, device=DEVICE)
        assert idx._resolve_pq_k() == 256
        idx2 = IVFVectorIndex(32, pq_subspaces=8, device=DEVICE)
        assert idx2._resolve_pq_k() == 256

    def test_state_roundtrip_preserves_auto(self):
        from tostore_tpu_torch.vector.ivf import IVFVectorIndex

        rng = np.random.default_rng(3)
        x = rng.standard_normal((400, 32)).astype(np.float32)
        idx = IVFVectorIndex(32, metric="l2", num_clusters=8,
                             pq_subspaces=16, min_train_size=64, device=DEVICE)
        idx.upsert(list(range(400)), x)
        idx2 = IVFVectorIndex.from_state_dict(idx.state_dict(), device=DEVICE)
        assert idx2.pq.k == 16 and idx2.pq_centroids == 0
        q = x[5]
        a = idx.search_arrays(q, 5)[2][0]
        b = idx2.search_arrays(q, 5)[2][0]
        assert list(a) == list(b)


class TestIVFLargeBatchDispatchPort:
    def _fake(self, capacity, d_pad=768):
        from tostore_tpu_torch.vector.ivf import IVFVectorIndex

        idx = IVFVectorIndex(768, precision="bfloat16", nprobe=16, device="cpu")
        idx.corpus = SimpleNamespace(capacity=capacity, d_pad=d_pad,
                                     vectors=torch.empty(0, dtype=torch.bfloat16))
        return idx

    def test_crossover_matches_measurements(self):
        idx = self._fake(503808)
        assert not idx._flat_beats_probe(8, 16)
        assert idx._flat_beats_probe(64, 16)
        assert idx._flat_beats_probe(128, 16)
        assert idx._flat_beats_probe(256, 16)

    def test_small_corpus_never_falls_back(self):
        idx = self._fake(4096)
        assert not idx._flat_beats_probe(256, 16)

    def test_low_nprobe_shifts_crossover_up(self):
        idx = self._fake(503808)
        assert not idx._flat_beats_probe(64, 2)

    def test_mode_probe_forces_probe_path(self, monkeypatch):
        from tostore_tpu_torch.vector import flat as flat_mod
        from tostore_tpu_torch.vector.ivf import IVFVectorIndex

        rng = np.random.default_rng(0)
        x = rng.standard_normal((900, 32)).astype(np.float32)
        idx = IVFVectorIndex(32, metric="l2", num_clusters=8, nprobe=8,
                             min_train_size=64, device=DEVICE)
        idx.upsert(list(range(900)), x)
        monkeypatch.setattr(type(idx), "_flat_beats_probe", lambda self, b, np_: True)
        flat_spy = []
        # the port's IVF index runs its flat view's device work, not its
        # search_arrays, inside the one search skeleton (vector/flat.py)
        real = flat_mod.FlatVectorIndex._dispatch

        def spy(self, *a, **kw):
            flat_spy.append(1)
            return real(self, *a, **kw)

        monkeypatch.setattr(flat_mod.FlatVectorIndex, "_dispatch", spy)
        d1, s1, p1 = idx.search_arrays(x[3], 5)
        assert flat_spy and p1[0][0] == 3
        n_flat = len(flat_spy)
        d2, s2, p2 = idx.search_arrays(x[3], 5, mode="probe")
        assert len(flat_spy) == n_flat
        assert p2[0][0] == 3
