"""Re-rank-pool sweep for IVF-PQ on the port (the counterpart of
`_exp_rerank_sweep.py`): recall@10 and probe latency against the pool
size on config #8's shape (500k x 768 bf16, hard clustered, C = 1024,
nprobe 16), for M = 96 / K = 256 and M = 192 / K = 16 (nibble-packed).
The probe runs K4 (ivf_adc) on the card; recall is over 256 queries
against the exact flat scan, latency at B = 8 (the mean of 20 calls after
a warm-up, the card synchronised at both ends).

    python3 experiments/_exp_rerank_sweep_torch.py
"""

import sys
import time
from pathlib import Path

N, D, K, NQ, MODES, CLUSTERS, NPROBE = 500_000, 768, 10, 256, 2000, 1024, 16
POOLS = (160, 512, 1024, 2048, 4096, 8192)


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import numpy as np
    import torch

    from bench_all_torch import _load_ivf, _near_queries, clustered_chunks
    from bench_torch import device_info, require_device
    from tostore_tpu_torch import IVFVectorIndex
    from tostore_tpu_torch.ops import distance as Dm
    from tostore_tpu_torch.ops.ivfprobe import LAUNCHES
    from tostore_tpu_torch.ops.runtime import round_up
    from tostore_tpu_torch.ops.topk import flat_search
    from tostore_tpu_torch.vector.ivf import _ivf_probe

    dev = require_device("cuda")
    print(device_info("cuda"), flush=True)
    n = round_up(N, 4096)
    chunks = clustered_chunks(n, D, MODES)

    def timeit(fn, *a, reps=20):
        fn(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*a)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def recall_at_k(slots, exact):
        hit = sum(len(set(map(int, s)) & set(map(int, e))) for s, e in zip(slots, exact))
        return hit / exact.size

    ex = qj = None
    for pq_m, pq_k, tag in ((96, 256, "adc8"), (192, 16, "adc4")):
        idx = IVFVectorIndex(D, metric="l2", precision="bfloat16", num_clusters=CLUSTERS,
                             nprobe=NPROBE, pq_subspaces=pq_m, pq_centroids=pq_k,
                             rerank_factor=4, min_train_size=100, device=dev)
        _load_ivf(idx, chunks)
        idx.train(force=True)
        c = idx.corpus
        if ex is None:  # the queries and the exact oracle, once (same rows in both indexes)
            rng = np.random.default_rng(5)
            qn = _near_queries(c, rng, n, NQ, D)
            qj = torch.from_numpy(np.pad(qn, ((0, 0), (0, c.d_pad - D)))).to(dev)
            bias = Dm.make_bias("l2", c.sq_norms, c.valid)
            ex = np.concatenate([
                flat_search(qj[lo:lo + 64], c.vectors, bias, k=K, alpha=2.0)[1].cpu().numpy()
                for lo in range(0, NQ, 64)])
        for pool in POOLS:
            def probe(qq, pool=pool):  # K4 over the contiguous codes, then the re-rank
                return _ivf_probe(qq, idx._probe_index(), k=K, nprobe=NPROBE, rerank=pool)

            slots = np.concatenate([probe(qj[lo:lo + 64])[1].cpu().numpy()
                                    for lo in range(0, NQ, 64)])
            rec = recall_at_k(slots, ex)
            ms = timeit(probe, qj[:8])
            print(f"{tag} pool={pool:5d}: recall@10={rec:.4f} probe_b8={ms:.4f} ms", flush=True)
        del idx
        torch.cuda.empty_cache()
    print(f"launches {dict(LAUNCHES)}", flush=True)


if __name__ == "__main__":
    main()
