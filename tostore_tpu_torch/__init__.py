"""tostore_tpu_torch: the PyTorch / CUDA port of tostore_tpu.

The JAX package `tostore_tpu` stays the reference; this package mirrors
its layout file by file (api.py, engine/, query/, chain/, models/, utils/,
native/, ops/, vector/) and imports neither JAX nor `tostore_tpu`. It
offers the same names: `ToStoreTPU.open()` / `.memory()` give an embedded
database with tables, a WAL, transactions, KV, schema migration and
vector search (flat, IVF, IVF-PQ, hybrid). Vector corpora live on the
torch device the config names (`DataStoreConfig.device`, default
`"cuda"`; `ToStoreTPU.open(path, device="cpu")` for the CPU). On a CUDA
device the flat scan and the IVF bucket scans run the hand-written Hopper
kernels in `csrc/`, built with nvcc at first use (ops/_kernels.py). A
database written by either package opens in the other. A `mesh_shape` of
more than one device stripes the vector corpora over a mesh of cells
(parallel/): one cell per card, or several on one device.
"""

from .models.schema import (
    TableSchema,
    FieldSchema,
    IndexSchema,
    DataType,
    PrimaryKeyConfig,
    PrimaryKeyType,
    VectorFieldConfig,
    VectorPrecision,
    VectorIndexType,
    VectorDistanceMetric,
    VectorIndexConfig,
    ForeignKeySchema,
    ForeignKeyAction,
    TableTtlConfig,
)
from .models.config import (
    DataStoreConfig,
    DistributedNodeConfig,
    EncryptionConfig,
    SpaceConfig,
)
from .models.results import (
    BusinessError,
    DbResult,
    ResultType,
    QueryResult,
    VectorSearchResult,
    TransactionResult,
)
from .models.aggregation import Agg
from .models.expr import Expr
from .utils.crypto import ToCrypto
from .utils.logging import LogConfig
from .query.condition import QueryCondition
from .vector.corpus import DeviceCorpus
from .vector.flat import FlatVectorIndex
from .vector.ivf import IVFVectorIndex
from .vector.pq import PQCodebook, train_pq
from .api import ToStoreTPU

__version__ = "0.1.0"

__all__ = [
    "LogConfig",
    "ToStoreTPU",
    "TableSchema",
    "FieldSchema",
    "IndexSchema",
    "DataType",
    "PrimaryKeyConfig",
    "PrimaryKeyType",
    "VectorFieldConfig",
    "VectorPrecision",
    "VectorIndexType",
    "VectorDistanceMetric",
    "VectorIndexConfig",
    "ForeignKeySchema",
    "ForeignKeyAction",
    "TableTtlConfig",
    "DataStoreConfig",
    "DistributedNodeConfig",
    "EncryptionConfig",
    "DbResult",
    "ResultType",
    "QueryResult",
    "VectorSearchResult",
    "TransactionResult",
    "Expr",
    "QueryCondition",
    "Agg",
    "BusinessError",
    "SpaceConfig",
    "ToCrypto",
    # the index objects, usable on their own
    "FlatVectorIndex",
    "IVFVectorIndex",
    "PQCodebook",
    "train_pq",
    "DeviceCorpus",
]
