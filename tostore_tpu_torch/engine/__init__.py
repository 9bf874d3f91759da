"""Engine core: tables, durability, transactions, spaces, KV.

Re-design of the reference's L2/L5-L7 stack (SURVEY.md §1): DataStoreImpl
orchestration (data_store_impl.dart), paged B+Tree storage
(table_tree_partition_manager.dart), WAL/journal pipeline
(wal_manager.dart, parallel_journal_manager.dart) and transaction manager —
rebuilt as a columnar host store (vectorized NumPy reads feeding device
bitmasks) + device-resident vector corpora + snapshot/WAL durability.

Counterpart of `tostore_tpu/engine/`: the host code is carried as it is,
and the vector indexes are the port's (`tostore_tpu_torch.vector`), on the
torch device the database's config names. Times, rates and sizes quoted
in the comments of the carried host modules (a soak's seconds, rows/s of
a replay) are the JAX package's history on its own host; what this
package measured on the GPU machine is in PERF.md.
"""

from .database import Database

__all__ = ["Database"]
