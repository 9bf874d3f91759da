"""Fluent builders.

Same chain surface as the reference (chain/query_builder.dart:93-375,
update_builder/delete_builder with allowUpdateAll/allowPartialErrors,
schema_builder.dart DDL chain, stream_query_builder.dart). Builders carry a
condition + options and execute against the Database on a terminal call.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

from ..models.aggregation import Agg
from ..query.condition import QueryCondition
from ..query.executor import JoinSpec, QuerySpec


class _ConditionMixin:
    """where-clauses shared by query/update/delete builders."""

    def __init__(self):
        self._cond = QueryCondition()

    def where(self, field: str, op: str, value: Any = None):
        self._cond.where(field, op, value)
        return self

    def where_equal(self, field: str, value):
        return self.where(field, "=", value)

    def where_not_equal(self, field: str, value):
        return self.where(field, "!=", value)

    def where_in(self, field: str, values):
        return self.where(field, "in", list(values))

    def where_not_in(self, field: str, values):
        return self.where(field, "notIn", list(values))

    def where_between(self, field: str, lo, hi):
        return self.where(field, "between", (lo, hi))

    def where_like(self, field: str, pattern: str):
        return self.where(field, "like", pattern)

    def where_not_like(self, field: str, pattern: str):
        return self.where(field, "notLike", pattern)

    def where_null(self, field: str):
        return self.where(field, "is", None)

    def where_not_null(self, field: str):
        return self.where(field, "isNot", None)

    def or_where(self, build: Callable[[QueryCondition], QueryCondition]):
        self._cond.or_(build(QueryCondition()))
        return self

    def and_where(self, build: Callable[[QueryCondition], QueryCondition]):
        self._cond.and_(build(QueryCondition()))
        return self

    def condition(self, cond: QueryCondition):
        self._cond.and_(cond)
        return self


class QueryBuilder(_ConditionMixin):
    def __init__(self, db, table: str):
        super().__init__()
        self._db = db
        self._table = table
        self._spec = QuerySpec(condition=self._cond)

    # projection
    def select(self, *fields: str):
        self._spec.select = list(fields)
        return self

    def as_(self, field: str, alias: str):
        self._spec.aliases[field] = alias
        return self

    # ordering / paging
    def order_by(self, field: str, desc: bool = False):
        self._spec.order_by.append((field, desc))
        return self

    def order_by_desc(self, field: str):
        return self.order_by(field, desc=True)

    def limit(self, n: int):
        self._spec.limit = n
        return self

    def offset(self, n: int):
        self._spec.offset = n
        return self

    def cursor(self, token: str):
        self._spec.cursor = token
        return self

    def distinct(self):
        self._spec.distinct = True
        return self

    def no_cache(self):
        """Bypass the generation-keyed result cache for this query
        (reference query-cache controls, query_builder.dart:258-266)."""
        self._spec.use_cache = False
        return self

    def use_cache(self, enabled: bool = True, expiry_s: float | None = None):
        """Enable the result cache, optionally bounding staleness to
        `expiry_s` seconds (reference useQueryCache([expiry]),
        query_builder.dart:256-260). Generation invalidation still applies
        — expiry only ADDS a time bound."""
        self._spec.use_cache = enabled
        self._spec.cache_expiry_s = expiry_s
        return self

    # joins (reference join/joinReferencedTable/joinReferencingTable)
    def join(self, table: str, left_field: str, right_field: str, kind: str = "inner"):
        # fail loud: an unknown kind would silently take inner semantics
        # on the record path and left semantics on the pair fast path
        if kind not in ("inner", "left", "right"):
            raise ValueError(f"unknown join kind {kind!r}")
        self._spec.joins.append(JoinSpec(table, left_field, right_field, kind))
        return self

    def left_join(self, table: str, left_field: str, right_field: str):
        return self.join(table, left_field, right_field, "left")

    def right_join(self, table: str, left_field: str, right_field: str):
        return self.join(table, left_field, right_field, "right")

    def join_referenced_table(self, table: str):
        """Join via this table's FK that references `table`."""
        schema = self._db.get_schema(self._table)
        for fk in schema.foreign_keys:
            if fk.references_table == table:
                ref_schema = self._db.get_schema(table)
                right = fk.references_field or ref_schema.primary_key.name
                return self.join(table, fk.field, right)
        raise ValueError(f"{self._table} has no FK referencing {table}")

    def join_referencing_table(self, table: str):
        """Join `table` via its FK that references this table."""
        other = self._db.get_schema(table)
        mine = self._db.get_schema(self._table)
        for fk in other.foreign_keys:
            if fk.references_table == self._table:
                left = fk.references_field or mine.primary_key.name
                return self.join(table, left, fk.field)
        raise ValueError(f"{table} has no FK referencing {self._table}")

    def join_with_foreign_key(self, table: str):
        """Join using whichever FK relationship exists between the two
        tables, in either direction (reference joinWithForeignKey,
        query_builder.dart:210)."""
        try:
            return self.join_referenced_table(table)
        except ValueError:
            return self.join_referencing_table(table)

    # aggregates
    def group_by(self, *fields: str):
        self._spec.group_by = list(fields)
        return self

    def aggregate(self, *aggs: Agg):
        self._spec.aggregates.extend(aggs)
        return self

    def having(self, field: str, op: str, value):
        if self._spec.having is None:
            self._spec.having = QueryCondition()
        self._spec.having.where(field, op, value)
        return self

    # terminals
    def fetch(self):
        res = self._db.query(self._table, self._spec)
        res._source = self
        return res

    def _page(self, cursor: str, forward: bool = True):
        import copy

        spec = copy.deepcopy(self._spec)
        spec.cursor = cursor
        spec.cursor_backward = not forward  # prev(): page BEFORE the cursor
        res = self._db.executor.execute(self._db.current_space, self._table, spec)
        res._source = self
        return res

    def first(self):
        self._spec.limit = 1
        recs = self.fetch().records
        return recs[0] if recs else None

    def count(self) -> int:
        return self._db.count(self._table, self._cond)

    def explain(self) -> dict:
        """Plan description for THIS chain's condition + ordering
        (reference query_plan.dart explain()): plan kind, chosen index,
        exact estimated rows, and whether the slice serves the order_by
        pre-sorted."""
        return self._db.explain(self._table, self._spec)

    def exists(self) -> bool:
        return self.first() is not None

    # aggregate shortcuts (reference query_builder.dart:350-362)
    def _agg_one(self, op: str, field: str):
        import copy

        spec = copy.deepcopy(self._spec)
        spec.aggregates = [Agg(op, field, "__v__")]
        spec.group_by = []
        spec.limit = None
        res = self._db.query(self._table, spec)
        return res.records[0]["__v__"] if res.records else None

    def sum(self, field: str):
        return self._agg_one("sum", field)

    def avg(self, field: str):
        return self._agg_one("avg", field)

    def min(self, field: str):
        return self._agg_one("min", field)

    def max(self, field: str):
        return self._agg_one("max", field)

    def clone(self) -> "QueryBuilder":
        """Independent copy of this query chain (reference clone,
        query_builder.dart:375)."""
        import copy

        qb = QueryBuilder(self._db, self._table)
        qb._cond = copy.deepcopy(self._cond)
        qb._spec = copy.deepcopy(self._spec)
        qb._spec.condition = qb._cond
        return qb

    def watch(self, callback=None):
        """Live query: re-runs this query whenever the table changes and
        delivers the fresh record list (reference QueryBuilder.watch,
        query_builder.dart:480 — a Stream of result lists). Re-queries are
        COALESCED per store generation: a columnar batch write bumps the
        generation once, so its burst of change events triggers one
        re-execution (the rest hit the generation check), instead of one
        full query per event inside the writer's critical section."""
        spec = self._spec
        last_gen = [-1]

        def on_change(_ev):
            if callback is None:
                return
            gen = self._db._table(self._table).store.generation
            if gen == last_gen[0]:
                return
            last_gen[0] = gen
            callback(self._db.query(self._table, spec).records)

        return self._db.watch(self._table, callback=on_change)

    def __iter__(self) -> Iterator[dict]:
        return iter(self.fetch().records)

    def __await__(self):  # reference builders are awaitable
        async def _run():
            return self.fetch()

        return _run().__await__()


class UpdateBuilder(_ConditionMixin):
    def __init__(self, db, table: str, updates: dict):
        super().__init__()
        self._db = db
        self._table = table
        self._updates = updates
        self._allow_all = False

    def allow_update_all(self):
        self._allow_all = True
        return self

    def execute(self):
        return self._db.update(
            self._table,
            self._updates,
            condition=self._cond,
            allow_update_all=self._allow_all,
        )


class DeleteBuilder(_ConditionMixin):
    def __init__(self, db, table: str):
        super().__init__()
        self._db = db
        self._table = table
        self._allow_all = False

    def allow_delete_all(self):
        self._allow_all = True
        return self

    def execute(self):
        return self._db.delete(
            self._table, condition=self._cond, allow_delete_all=self._allow_all
        )


class VectorQueryBuilder(_ConditionMixin):
    """Hybrid vector search chain: structured where-clauses become the
    in-kernel bitmask (BASELINE config #4)."""

    def __init__(self, db, table: str, field: str, query):
        super().__init__()
        self._db = db
        self._table = table
        self._field = field
        self._query = query
        self._top_k = 10
        self._threshold = None
        self._nprobe = None
        self._include_records = False
        self._mode = None

    def top_k(self, k: int):
        self._top_k = k
        return self

    def mode(self, m: str):
        """'auto' | 'exact' | 'fast' (overrides
        VectorIndexConfig.search_mode; see schema.py for the contracts)."""
        self._mode = m
        return self

    def threshold(self, d: float):
        self._threshold = d
        return self

    def nprobe(self, n: int):
        self._nprobe = n
        return self

    def include_records(self):
        self._include_records = True
        return self

    def fetch(self):
        cond = None if self._cond.is_empty else self._cond
        return self._db.vector_search(
            self._table,
            self._field,
            self._query,
            top_k=self._top_k,
            threshold=self._threshold,
            condition=cond,
            nprobe=self._nprobe,
            include_records=self._include_records,
            mode=self._mode,
        )


class StreamQueryBuilder(QueryBuilder):
    """Batched streaming reads (reference stream_query_builder.dart)."""

    def __init__(self, db, table: str, batch_size: int = 500):
        super().__init__(db, table)
        self._batch = batch_size

    def stream(self) -> Iterator[dict]:
        self._spec.limit = self._batch
        res = self.fetch()
        while True:
            yield from res.records
            if not res.next_cursor:
                return
            res = self._page(res.next_cursor)


class SchemaBuilder:
    """DDL chain -> one migration (reference schema_builder.dart:
    renameTable/modifyField/renameField/addField/removeField/addIndex/
    removeIndex/setPrimaryKeyConfig)."""

    def __init__(self, db, table: str):
        from ..models.schema import TableSchema

        self._db = db
        self._table = table
        schema = db.get_schema(table)
        if schema is None:
            raise ValueError(f"table {table!r} not found")
        self._fields = {f.name: f for f in schema.fields}
        self._order = [f.name for f in schema.fields]
        self._schema = schema
        self._renames: dict[str, str] = {}
        self._indexes = list(schema.indexes)
        self._new_name = None

    def add_field(self, field):
        self._fields[field.name] = field
        self._order.append(field.name)
        return self

    def remove_field(self, name: str):
        self._fields.pop(name, None)
        if name in self._order:
            self._order.remove(name)
        self._indexes = [i for i in self._indexes if name not in i.fields]
        return self

    def rename_field(self, old: str, new: str):
        import dataclasses

        f = self._fields.pop(old)
        f2 = dataclasses.replace(f, name=new)
        self._fields[new] = f2
        self._order[self._order.index(old)] = new
        self._renames[old] = new
        self._indexes = [
            dataclasses.replace(
                i, fields=tuple(new if x == old else x for x in i.fields)
            )
            if old in i.fields
            else i
            for i in self._indexes
        ]
        return self

    def modify_field(self, name: str, **changes):
        import dataclasses

        self._fields[name] = dataclasses.replace(self._fields[name], **changes)
        return self

    def add_index(self, index):
        self._indexes.append(index)
        return self

    def remove_index(self, name: str):
        self._indexes = [i for i in self._indexes if i.index_name != name]
        return self

    def rename_table(self, new_name: str):
        self._new_name = new_name
        return self

    def execute(self):
        import dataclasses

        new_schema = dataclasses.replace(
            self._schema,
            name=self._new_name or self._schema.name,
            fields=tuple(self._fields[n] for n in self._order),
            indexes=tuple(self._indexes),
        )
        res = self._db.update_schema(self._table, new_schema, self._renames)
        if self._new_name and not res.is_error:
            res2 = self._db.rename_table(self._table, self._new_name)
            if res2.is_error:
                return res2
        return res
