"""Engine configuration.

Mirrors the reference's layered config (reference model/data_store_config.dart:
13-151 immutable ctor + copyWith; global_config.dart; space_config.dart) with
device-native additions: the torch device of the vector corpora, device
dtype policy, mesh/shard settings, and HBM budgeting instead of the mobile
cache budgets. Counterpart of `tostore_tpu/models/config.py`.

Where a mesh's cells live (`mesh_shape` of more than one cell, with
`device`; engine/database.py `_make_mesh`, parallel/mesh.py):
  - after `parallel.mesh.init_distributed`, the cells follow the process
    group's ranks (gloo: so many CPU cells a process; nccl: one rank and
    one cell per card);
  - `device` without an index (`"cuda"`, the default): cell i lives on
    `cuda:i`; a machine with fewer cards than cells raises, and nothing
    is built on the CPU in their place;
  - `device` with an index (`"cuda:0"`) or `"cpu"`: every cell lives on
    that one device (several stripes of one card, or the CPU cells the
    tests use).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DistributedNodeConfig:
    """Distributed identity (reference data_store_config.dart:746-769).

    In the reference this only feeds central-server ID segments. Here it
    additionally names the mesh axes for the sharded corpus path
    (parallel/mesh.py)."""

    enable_distributed: bool = False
    cluster_id: int = 0
    node_id: int = 0
    central_server_url: str | None = None
    access_token: str | None = None
    id_fetch_threshold: float = 0.2


@dataclass(frozen=True)
class EncryptionConfig:
    """At-rest encryption of host artifacts (reference
    data_store_config.dart:992 `encryptVectorIndex`, handler/chacha20_poly1305
    + aes_gcm). Algorithm: 'chacha20-poly1305' (pure-Python, portable)."""

    enable_encoding: bool = False
    encoding_key: str | None = None
    encryption_key: str | None = None
    key_id: int = 1
    encrypt_vector_index: bool = False
    algorithm: str = "chacha20-poly1305"
    # reference data_store_config.dart:945-961: derive the key with a
    # host/path-bound factor so a copied database refuses to open elsewhere
    device_binding: bool = False


@dataclass(frozen=True)
class IsolationLevel:
    readCommitted = "readCommitted"
    serializable = "serializable"


@dataclass(frozen=True)
class DataStoreConfig:
    """Top-level engine config (reference data_store_config.dart:13-151)."""

    db_path: str | None = None  # None = memory mode (reference ToStore.memory())
    db_name: str = "default"

    # write pipeline (reference writeBatchSize / maxFlushLatencyMs)
    write_batch_size: int = 10_000
    max_flush_latency_ms: int = 500
    enable_journal: bool = True
    persist_recovery_on_commit: bool = False  # shorthand for policy="commit"
    # WAL fsync cadence (reference recoveryFlushPolicy): "commit" fsyncs
    # every append, "interval" at most once per recovery_flush_interval_ms
    # (default — bounds the power-loss window), "os" leaves it to the page
    # cache.
    recovery_flush_policy: str = "interval"
    recovery_flush_interval_ms: int = 1000
    wal_segment_max_bytes: int = 64 << 20
    # at-rest zlib compression of snapshots/WAL/backups (reference
    # data_compressor.dart; applied before encryption)
    enable_compression: bool = False
    compression_level: int = 6

    # query surface (reference defaultQueryLimit=1000 / maxQueryOffset=10000)
    default_query_limit: int = 1000
    max_query_offset: int = 10_000

    # transactions
    isolation_level: str = IsolationLevel.readCommitted

    # maintenance
    ttl_cleanup_interval_s: float = 300.0
    crontab_interval_s: float = 1.0
    # workload QoS (reference workload_scheduler.dart:48-53 maintenance
    # share): background jobs defer while foreground ops ran within
    # `maintenance_defer_s` or maintenance exceeds this time share
    maintenance_share: float = 0.15
    maintenance_defer_s: float = 0.25
    # transaction(retries=) escalates to per-row pessimistic locks from
    # this conflict count on (reference lock_manager.dart:38-44)
    txn_escalate_after: int = 2
    tombstone_compact_ratio: float = 0.10  # reference vim:897 10% threshold

    # startup prewarm (reference loadDataToCache at open, dsi:908): run
    # one vector search per index on a background thread after open,
    # hottest tables first, so that the kernels' build (nvcc at first use)
    # is paid before a user's first search. Opt-in: a cold build should
    # not surprise short-lived processes.
    prewarm_on_open: bool = False

    # device-native (the JAX package's fields are kept so that a config
    # written for it still constructs; `device` is the port's own)
    device: str = "cuda"  # torch device of the vector corpora; tests pass "cpu"
    device_put_vectors: bool = True  # keep vector corpora device-resident
    default_vector_dtype: str = "float32"  # scoring dtype for new indexes
    hbm_budget_mb: int = 0  # 0 = auto from device memory stats
    mesh_shape: tuple[int, ...] = ()  # () = single device; (shard,) or (dp, shard)
    mesh_axis_names: tuple[str, ...] = ("shard",)

    # subsystem configs
    distributed: DistributedNodeConfig = field(default_factory=DistributedNodeConfig)
    encryption: EncryptionConfig = field(default_factory=EncryptionConfig)

    # parallel host I/O
    max_io_concurrency: int = 8
    max_open_files: int = 128

    # logging (reference LogConfig + onLogHandler, README.md:1415-1435):
    # applied process-wide at engine open
    log_level: str = "warning"
    on_log: "object | None" = None  # callable(level, tag, msg)

    def copy_with(self, **kw) -> "DataStoreConfig":
        return dataclasses.replace(self, **kw)

    @property
    def memory_mode(self) -> bool:
        return self.db_path is None


@dataclass
class GlobalConfig:
    """Persisted per-database global state (reference global_config.dart:
    activeSpace, maxEntriesPerDir)."""

    active_space: str = "default"
    version: int = 1
    extras: dict[str, Any] = field(default_factory=dict)

    def to_json(self):
        return {"active_space": self.active_space, "version": self.version, "extras": self.extras}

    @staticmethod
    def from_json(d):
        return GlobalConfig(
            active_space=d.get("active_space", "default"),
            version=d.get("version", 1),
            extras=d.get("extras", {}),
        )


@dataclass
class SpaceConfig:
    """Per-space persisted state (reference space_config.dart)."""

    name: str = "default"
    created_ms: int = 0
    extras: dict[str, Any] = field(default_factory=dict)

    def to_json(self):
        return {"name": self.name, "created_ms": self.created_ms, "extras": self.extras}

    @staticmethod
    def from_json(d):
        return SpaceConfig(
            name=d.get("name", "default"),
            created_ms=d.get("created_ms", 0),
            extras=d.get("extras", {}),
        )
