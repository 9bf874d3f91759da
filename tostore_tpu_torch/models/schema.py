"""Table / field / index schema models.

Same capability surface as the reference's `TableSchema` vocabulary
(reference model/table_schema.dart:12-3055): typed fields with constraints,
primary-key strategies, secondary (btree-equivalent) indexes, vector fields
with per-index ANN configuration, TTL configs, and foreign keys — plus
TPU-specific knobs (device dtype, shard axis) that have no Dart counterpart.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field, asdict
from typing import Any, Iterable


class DataType(str, enum.Enum):
    """Field data types (reference table_schema.dart:1888-1915)."""

    integer = "integer"
    bigInt = "bigInt"
    double = "double"
    text = "text"
    blob = "blob"
    boolean = "boolean"
    datetime = "datetime"
    array = "array"
    json = "json"
    vector = "vector"


class PrimaryKeyType(str, enum.Enum):
    """PK generation strategies (reference table_schema.dart:1917-2107)."""

    none = "none"  # user supplies the key
    sequential = "sequential"
    timestampBased = "timestampBased"
    datePrefixed = "datePrefixed"
    shortCode = "shortCode"


@dataclass(frozen=True)
class PrimaryKeyConfig:
    name: str = "id"
    type: PrimaryKeyType = PrimaryKeyType.sequential
    # sequential: starting value and step
    initial_value: int = 1
    increment: int = 1

    def to_json(self):
        return {
            "name": self.name,
            "type": self.type.value,
            "initial_value": self.initial_value,
            "increment": self.increment,
        }

    @staticmethod
    def from_json(d):
        return PrimaryKeyConfig(
            name=d.get("name", "id"),
            type=PrimaryKeyType(d.get("type", "sequential")),
            initial_value=d.get("initial_value", 1),
            increment=d.get("increment", 1),
        )


class VectorPrecision(str, enum.Enum):
    """On-device storage precision for vector fields. The reference offers
    {float64, float32, int8} (table_schema.dart:2481); TPU-native adds
    bfloat16 (the MXU-preferred scoring dtype)."""

    float32 = "float32"
    bfloat16 = "bfloat16"
    int8 = "int8"
    # accepted for reference compat; stored as float32 on device
    float64 = "float64"


class VectorIndexType(str, enum.Enum):
    """ANN index families. The reference has only `ngh` (Vamana graph,
    table_schema.dart:2502); TPU-native replaces the graph with `flat`
    (full MXU scan; the default search_mode='auto' uses a per-lane
    candidate selection with a tiny documented miss probability
    (~1e-5..1e-8 per query, ops/topk.py:26-35) — set search_mode='exact'
    for the reference's zero-miss exact-scan semantics) and `ivf` (coarse
    quantizer + nprobe scan), and keeps `ngh` as an accepted alias mapped
    to ivf."""

    flat = "flat"
    ivf = "ivf"
    ngh = "ngh"


class VectorDistanceMetric(str, enum.Enum):
    cosine = "cosine"
    l2 = "l2"
    innerProduct = "innerProduct"

    @property
    def kernel_name(self) -> str:
        return {"cosine": "cosine", "l2": "l2", "innerProduct": "dot"}[self.value]


@dataclass(frozen=True)
class VectorIndexConfig:
    """ANN parameters (reference table_schema.dart:2547 exposes maxDegree,
    efSearch, constructionEf, pruneAlpha, pqSubspaces; here the graph knobs
    map onto IVF/PQ equivalents)."""

    index_type: VectorIndexType = VectorIndexType.flat
    metric: VectorDistanceMetric = VectorDistanceMetric.cosine
    # IVF
    num_clusters: int = 0  # 0 = auto: ~sqrt(N), rounded to a multiple of 8
    nprobe: int = 8
    # PQ (0 subspaces = no PQ; auto rule mirrors ngh_index_meta.dart:237:
    # clamp(D/8, 8, 128))
    pq_subspaces: int = 0
    # 0 = auto: K=16 (4-bit nibble-packed codes) when pq_subspaces % 16
    # == 0 (lane alignment): the JAX package's rule, kept so that both
    # packages build the same index from one schema; else K=256
    pq_centroids: int = 0
    # exact re-rank pool multiplier (reference rerank pool max(2k, 20),
    # ngh_graph_engine.dart:115)
    rerank_factor: int = 2
    # IVFADC residual codes (x - centroid[bucket]); large recall win over
    # raw-vector PQ at identical code size
    pq_residual: bool = True
    # PQ exact-re-rank pool size; 0 = auto max(rerank_factor*k, 16k, 64)
    pq_rerank: int = 0
    # 'auto' (default): flat scans may use the per-lane candidate
    # selection (miss ~1e-5..1e-8, ops/topk.py:26-35); 'exact' forces the
    # exact scan everywhere — on ivf indexes it bypasses the probe and
    # scans the whole corpus (reference exact semantics,
    # vector_index_manager.dart:475); 'fast' is the JAX package's route
    # through the TPU's hardware-binned top-k, which the card does not
    # have: accepted here and served as 'auto' (ops/topk.py)
    search_mode: str = "auto"

    def __post_init__(self):
        # accept plain strings for ergonomic construction
        object.__setattr__(self, "index_type", VectorIndexType(self.index_type))
        object.__setattr__(self, "metric", VectorDistanceMetric(self.metric))
        if self.search_mode not in ("auto", "exact", "fast"):
            raise ValueError(
                "search_mode must be 'auto', 'exact' or 'fast', "
                f"got {self.search_mode!r}"
            )

    def to_json(self):
        d = asdict(self)
        d["index_type"] = self.index_type.value
        d["metric"] = self.metric.value
        return d

    @staticmethod
    def from_json(d):
        return VectorIndexConfig(
            index_type=VectorIndexType(d.get("index_type", "flat")),
            metric=VectorDistanceMetric(d.get("metric", "cosine")),
            num_clusters=d.get("num_clusters", 0),
            nprobe=d.get("nprobe", 8),
            pq_subspaces=d.get("pq_subspaces", 0),
            pq_centroids=d.get("pq_centroids", 0),
            rerank_factor=d.get("rerank_factor", 2),
            pq_residual=d.get("pq_residual", True),
            pq_rerank=d.get("pq_rerank", 0),
            search_mode=d.get("search_mode", "auto"),
        )


@dataclass(frozen=True)
class VectorFieldConfig:
    """Per-field vector storage config (reference table_schema.dart:2406)."""

    dimensions: int
    precision: VectorPrecision = VectorPrecision.float32

    def __post_init__(self):
        object.__setattr__(self, "precision", VectorPrecision(self.precision))

    def to_json(self):
        return {"dimensions": self.dimensions, "precision": self.precision.value}

    @staticmethod
    def from_json(d):
        return VectorFieldConfig(
            dimensions=d["dimensions"],
            precision=VectorPrecision(d.get("precision", "float32")),
        )


class ForeignKeyAction(str, enum.Enum):
    """FK referential actions (reference table_schema.dart:2756-2814)."""

    restrict = "restrict"
    cascade = "cascade"
    setNull = "setNull"
    noAction = "noAction"


@dataclass(frozen=True)
class ForeignKeySchema:
    field: str
    references_table: str
    references_field: str | None = None  # None = referenced table's PK
    on_delete: ForeignKeyAction = ForeignKeyAction.restrict
    on_update: ForeignKeyAction = ForeignKeyAction.restrict

    def to_json(self):
        return {
            "field": self.field,
            "references_table": self.references_table,
            "references_field": self.references_field,
            "on_delete": self.on_delete.value,
            "on_update": self.on_update.value,
        }

    @staticmethod
    def from_json(d):
        return ForeignKeySchema(
            field=d["field"],
            references_table=d["references_table"],
            references_field=d.get("references_field"),
            on_delete=ForeignKeyAction(d.get("on_delete", "restrict")),
            on_update=ForeignKeyAction(d.get("on_update", "restrict")),
        )


@dataclass(frozen=True)
class TableTtlConfig:
    """Row TTL (reference table_schema.dart:1804). If source_field is None an
    internal ingest-timestamp column is used (reference
    ttl_cleanup_manager.dart:40)."""

    ttl_seconds: float
    source_field: str | None = None
    enabled: bool = True

    def to_json(self):
        return {
            "ttl_seconds": self.ttl_seconds,
            "source_field": self.source_field,
            "enabled": self.enabled,
        }

    @staticmethod
    def from_json(d):
        return TableTtlConfig(
            ttl_seconds=d["ttl_seconds"],
            source_field=d.get("source_field"),
            enabled=d.get("enabled", True),
        )


@dataclass(frozen=True)
class FieldSchema:
    """One typed column (reference table_schema.dart:1177)."""

    name: str
    type: DataType
    nullable: bool = True
    unique: bool = False
    default_value: Any = None
    # numeric/text constraints
    min_value: Any = None
    max_value: Any = None
    max_length: int | None = None
    comment: str | None = None
    vector_config: VectorFieldConfig | None = None

    def __post_init__(self):
        if self.type == DataType.vector and self.vector_config is None:
            raise ValueError(f"vector field {self.name!r} requires vector_config")

    def to_json(self):
        return {
            "name": self.name,
            "type": self.type.value,
            "nullable": self.nullable,
            "unique": self.unique,
            "default_value": self.default_value,
            "min_value": self.min_value,
            "max_value": self.max_value,
            "max_length": self.max_length,
            "comment": self.comment,
            "vector_config": self.vector_config.to_json() if self.vector_config else None,
        }

    @staticmethod
    def from_json(d):
        vc = d.get("vector_config")
        return FieldSchema(
            name=d["name"],
            type=DataType(d["type"]),
            nullable=d.get("nullable", True),
            unique=d.get("unique", False),
            default_value=d.get("default_value"),
            min_value=d.get("min_value"),
            max_value=d.get("max_value"),
            max_length=d.get("max_length"),
            comment=d.get("comment"),
            vector_config=VectorFieldConfig.from_json(vc) if vc else None,
        )


@dataclass(frozen=True)
class IndexSchema:
    """Secondary or vector index (reference table_schema.dart:1704-1902).

    type 'btree' = ordered secondary index on one or more fields (the TPU
    build backs it with sorted columnar arrays instead of paged B+Trees);
    type 'vector' = ANN index on a single vector field.
    """

    fields: tuple[str, ...]
    unique: bool = False
    type: str = "btree"  # 'btree' | 'vector'
    vector_config: VectorIndexConfig | None = None
    name: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))
        if self.type == "vector" and self.vector_config is None:
            object.__setattr__(self, "vector_config", VectorIndexConfig())

    @property
    def index_name(self) -> str:
        return self.name or ("idx_" + "_".join(self.fields))

    def to_json(self):
        return {
            "fields": list(self.fields),
            "unique": self.unique,
            "type": self.type,
            "vector_config": self.vector_config.to_json() if self.vector_config else None,
            "name": self.name,
        }

    @staticmethod
    def from_json(d):
        vc = d.get("vector_config")
        return IndexSchema(
            fields=tuple(d["fields"]),
            unique=d.get("unique", False),
            type=d.get("type", "btree"),
            vector_config=VectorIndexConfig.from_json(vc) if vc else None,
            name=d.get("name"),
        )


@dataclass(frozen=True)
class TableSchema:
    """Full table definition (reference table_schema.dart:12)."""

    name: str
    fields: tuple[FieldSchema, ...]
    primary_key: PrimaryKeyConfig = field(default_factory=PrimaryKeyConfig)
    indexes: tuple[IndexSchema, ...] = ()
    foreign_keys: tuple[ForeignKeySchema, ...] = ()
    ttl: TableTtlConfig | None = None
    is_global: bool = False  # global tables are shared across spaces
    comment: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))
        object.__setattr__(self, "indexes", tuple(self.indexes))
        object.__setattr__(self, "foreign_keys", tuple(self.foreign_keys))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in table {self.name!r}")
        if self.primary_key.name in names:
            raise ValueError(
                f"primary key {self.primary_key.name!r} must not also be declared as a field"
            )
        by_name = {f.name: f for f in self.fields}
        for idx in self.indexes:
            for fname in idx.fields:
                if fname not in by_name and fname != self.primary_key.name:
                    raise ValueError(f"index on unknown field {fname!r} in {self.name!r}")
            if idx.type == "vector":
                if len(idx.fields) != 1:
                    raise ValueError("vector index must cover exactly one field")
                f = by_name.get(idx.fields[0])
                if f is None or f.type != DataType.vector:
                    raise ValueError(f"vector index field {idx.fields[0]!r} is not a vector field")

    @property
    def field_map(self) -> dict[str, FieldSchema]:
        return {f.name: f for f in self.fields}

    def field_schema(self, name: str) -> FieldSchema | None:
        return self.field_map.get(name)

    def vector_indexes(self) -> list[IndexSchema]:
        return [i for i in self.indexes if i.type == "vector"]

    def btree_indexes(self) -> list[IndexSchema]:
        return [i for i in self.indexes if i.type == "btree"]

    def unique_fields(self) -> list[str]:
        return [f.name for f in self.fields if f.unique]

    def to_json(self):
        return {
            "name": self.name,
            "fields": [f.to_json() for f in self.fields],
            "primary_key": self.primary_key.to_json(),
            "indexes": [i.to_json() for i in self.indexes],
            "foreign_keys": [fk.to_json() for fk in self.foreign_keys],
            "ttl": self.ttl.to_json() if self.ttl else None,
            "is_global": self.is_global,
            "comment": self.comment,
        }

    @staticmethod
    def from_json(d) -> "TableSchema":
        return TableSchema(
            name=d["name"],
            fields=tuple(FieldSchema.from_json(f) for f in d["fields"]),
            primary_key=PrimaryKeyConfig.from_json(d.get("primary_key", {})),
            indexes=tuple(IndexSchema.from_json(i) for i in d.get("indexes", [])),
            foreign_keys=tuple(ForeignKeySchema.from_json(f) for f in d.get("foreign_keys", [])),
            ttl=TableTtlConfig.from_json(d["ttl"]) if d.get("ttl") else None,
            is_global=d.get("is_global", False),
            comment=d.get("comment"),
        )


def now_ms() -> int:
    return int(time.time() * 1000)
