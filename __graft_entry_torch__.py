"""Entry points of the PyTorch port (`tostore_tpu_torch`) for a harness that
calls in from outside; the JAX package's are in `__graft_entry__.py`.

entry():            the single-device forward step on the flagship path
                    (the fused flat-scan top-k search over a vector corpus)
                    on the card: K1 of ops/topk.py.
dryrun_multichip(n): ONE full "training step" of the engine over a mesh of
                    n cells with real striping: a sharded k-means Lloyd
                    update (index training, the all-reduce over the mesh),
                    a scattered insert into the striped corpus, a sharded
                    search (per-shard top-k + merge), and a sharded
                    residual-PQ IVF. The n cells all live on one device,
                    the first card unless the caller names another
                    (`device="cpu"` for a machine without one): on the card
                    the per-stripe scan launches K1 and the IVF probe K4.
"""

import numpy as np


def entry(device="cuda"):
    """Returns (fn, example_args): the fused flat search forward step on
    `device` (the card unless the caller asks for the CPU, where the plain
    version of the kernel runs)."""
    import torch

    from tostore_tpu_torch.ops.topk import fused_flat_topk

    n, d, b, k = 4096, 256, 8, 10
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    corpus = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    corpus = corpus.to(dev).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    bias = torch.zeros(n, dtype=torch.float32, device=dev)

    def fn(q, corpus, bias):
        return fused_flat_topk(q, corpus, bias, k=k)

    return fn, (q, corpus, bias)


def dryrun_multichip(n_devices: int, device="cuda:0") -> None:
    """One full sharded engine step on a mesh of n_devices cells, all on
    `device` (tiny shapes). On a CUDA device the scans launch the kernels
    (the wrappers never take their plain versions there); without a card
    the default raises and `device="cpu"` has to be asked for."""
    import torch

    from tostore_tpu_torch.ops import distance as D
    from tostore_tpu_torch.parallel.mesh import Striped, make_mesh
    from tostore_tpu_torch.parallel.sharded import sharded_flat_topk, sharded_kmeans_step

    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, dp=dp, devices=[device] * n_devices)
    nsh = mesh.shape["shard"]

    n, d, k, c = 2048 * nsh, 128, 4, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)

    corpus = Striped.from_global(mesh, x)
    valid = Striped.from_global(mesh, np.ones(n, np.bool_))

    # 1. index training step: data-parallel Lloyd update (sum over the mesh)
    cents = sharded_kmeans_step(corpus, x[:c], valid, mesh=mesh)
    assert cents.shape == (c, d) and bool(torch.isfinite(cents).all())

    # 2. streaming insert: scatter a new batch into the striped corpus
    new = rng.standard_normal((8, d)).astype(np.float32)
    rows = np.arange(8, dtype=np.int64) * (n // 8)
    corpus.scatter(rows, new)
    np.testing.assert_array_equal(corpus.gather(rows).cpu().numpy(), new)

    # 3. sharded search: per-shard top-k + merge. The stripes are far below
    #    the size at which `auto` leaves the exact scan, so the fused scan
    #    (K1) is asked for by name
    q = rng.standard_normal((4 * dp, d)).astype(np.float32)
    bias = valid.map(lambda v: D.make_bias("dot", None, v))
    scores, idx = sharded_flat_topk(q, corpus, bias, k=k, alpha=1.0, mesh=mesh, mode="fused")
    assert scores.shape == (4 * dp, k) and idx.shape == (4 * dp, k)
    # sanity: merged indices span multiple shards' ranges on random data
    spans = set((idx.cpu().numpy().ravel() // (n // nsh)).tolist())
    assert len(spans) >= min(2, nsh), f"merge only saw shards {spans}"

    # 4. sharded IVF with residual PQ (IVFADC): per-shard sliced bucket
    #    build, residual codes, per-shard ADC + exact re-rank, merge: the
    #    full ANN training + serving step over the mesh
    from tostore_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    ivf = ShardedIVFIndex(
        d, mesh, metric="l2", num_clusters=8, nprobe=4,
        min_train_size=64, pq_subspaces=8,
    )
    ivf.upsert(list(range(512)), x[:512])
    assert ivf.trained and ivf.pq is not None
    # the bucket-contiguous ADC stripes (kernel K4's layout) must be the
    # active mesh path, not the row-gather fallback
    assert ivf.bucket_codes is not None
    hit = ivf.search(x[17], top_k=1, nprobe=8)[0]
    assert hit.primary_key == 17, hit
