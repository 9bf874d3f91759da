"""Query planning + execution over the columnar store.

Replaces the reference's QueryExecutor/QueryOptimizer pair
(query/query_executor.dart:62 execute, query_optimizer.dart:18 optimize):
predicates evaluate as vectorized column masks (the tableScan plan), with a
sorted-index fast path for single-field range/equality + orderBy
(the indexScan plan); joins are hash joins; aggregates/groupBy/having,
distinct, dual offset/cursor pagination and join semantics match the
reference surface.
"""

from __future__ import annotations

import copy
import base64
import json
import threading
import time
import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..models.aggregation import Agg
from .condition import QueryCondition


@dataclass
class JoinSpec:
    table: str
    left_field: str
    right_field: str
    kind: str = "inner"  # inner | left | right


@dataclass
class QuerySpec:
    condition: QueryCondition | None = None
    select: list[str] | None = None
    aliases: dict[str, str] = field(default_factory=dict)  # field -> alias
    order_by: list[tuple[str, bool]] = field(default_factory=list)  # (field, desc)
    limit: int | None = None
    offset: int = 0
    cursor: str | None = None
    # True = page strictly BEFORE the cursor row (QueryResult.prev();
    # the cursor is the first record of the page navigated from)
    cursor_backward: bool = False
    joins: list[JoinSpec] = field(default_factory=list)
    group_by: list[str] = field(default_factory=list)
    aggregates: list[Agg] = field(default_factory=list)
    having: QueryCondition | None = None
    distinct: bool = False
    use_cache: bool = True  # reference query-cache controls (:258-266)
    # time-based staleness bound on top of generation invalidation
    # (reference useQueryCache([expiry]), query_builder.dart:256-260);
    # None = generation-only (strictly fresher). Not part of the
    # fingerprint: expiry is a read policy, not a query identity.
    cache_expiry_s: float | None = None

    def fingerprint(self) -> str:
        return json.dumps(
            {
                "c": self.condition.to_map() if self.condition else None,
                "s": self.select,
                "a": self.aliases,
                "o": self.order_by,
                "l": self.limit,
                "off": self.offset,
                "cur": self.cursor,
                "back": self.cursor_backward,
                "j": [(j.table, j.left_field, j.right_field, j.kind) for j in self.joins],
                "g": self.group_by,
                "agg": [(a.op, a.field, a.alias) for a in self.aggregates],
                "h": self.having.to_map() if self.having else None,
                "d": self.distinct,
            },
            default=str,
            sort_keys=True,
        )


@dataclass
class ExplainInfo:
    plan: str  # 'indexScan' | 'indexUnion' | 'indexOrder' | 'tableScan'
    index: str | None = None
    estimated_rows: int = 0
    # indexScan/indexUnion: resolved (index_name, lo_pos, hi_pos) bisect
    # slices, one per DNF arm (exact counts — the sorted key array makes
    # true selectivity free, reference cost_estimator.dart:9-11)
    arms: list = field(default_factory=list)
    # single-arm indexScan whose slice already satisfies spec.order_by
    # (composite key order after the equality prefix) — skips the sort
    ordered: bool = False
    # same, but the order_by is all-DESC: the reversed slice serves it
    ordered_rev: bool = False


def _encode_cursor(values: list, pk) -> str:
    return base64.urlsafe_b64encode(json.dumps([values, pk]).encode()).decode()


def _decode_cursor(tok: str):
    return json.loads(base64.urlsafe_b64decode(tok.encode()))


def _coerce_index_value(v, fs):
    """Quoted numerics compare numerically on numeric columns (reference
    quirk, database_tester.dart advanced-queries suite)."""
    from ..models.schema import DataType

    if fs is not None and isinstance(v, str) and fs.type in (
        DataType.integer, DataType.bigInt, DataType.double, DataType.datetime
    ):
        try:
            fv = float(v)
            return int(fv) if fv.is_integer() and fs.type != DataType.double else fv
        except ValueError:
            return v
    return v


def _extract_bounds(leaves: list, field: str, fs):
    """(lo, hi, lo_open, hi_open) for `field` from AND leaves, or None when
    no range/equality leaf constrains it. Superset semantics: the residual
    predicate re-filters, so float bounds widen on integer columns."""
    import math

    from ..models.schema import DataType

    from ..engine.table import NULL_KEY

    lo = hi = None
    lo_open = hi_open = False
    found = False
    for f, op, v in leaves:
        if f != field:
            continue
        if op == "is" and v is None:
            # IS NULL: equality on the null key (nulls sort first in the
            # memcomparable order; reference index_manager.dart null-range
            # scans). NULL_KEY because None means 'unbounded' here.
            lo = hi = NULL_KEY
            lo_open = hi_open = False
            found = True
            continue
        if op not in ("=", ">", "<", ">=", "<=", "between"):
            continue
        v = (
            _coerce_index_value(v, fs)
            if not isinstance(v, tuple)
            else tuple(_coerce_index_value(x, fs) for x in v)
        )
        found = True
        # every assignment sets its open flag: a later leaf on the same
        # field must not inherit a stale flag from an earlier one (found
        # by the differential fuzz: `a > -18 AND a between (1, 13)` left
        # lo_open=True on the closed between-bound, excluding a=1 from a
        # claimed-superset arm). Mixing lo/hi from different leaves stays
        # superset-safe — each is one leaf's own constraint.
        if op == "=":
            lo = hi = v
            lo_open = hi_open = False
        elif op == ">":
            lo, lo_open = v, True
        elif op == ">=":
            lo, lo_open = v, False
        elif op == "<":
            hi, hi_open = v, True
        elif op == "<=":
            hi, hi_open = v, False
        elif op == "between":
            lo, hi = v
            lo_open = hi_open = False
    if not found:
        return None
    if fs is not None and fs.type in (DataType.integer, DataType.bigInt, DataType.datetime):
        if isinstance(lo, float):
            lo, lo_open = math.floor(lo), False
        if isinstance(hi, float):
            hi, hi_open = math.ceil(hi), False
    return lo, hi, lo_open, hi_open


def _like_literal_prefix(pattern: str) -> str | None:
    """Literal prefix of a LIKE pattern up to the first wildcard ('' ->
    None: no index arm). A wildcard-free pattern is its own prefix (the
    arm is exact there; the residual regex confirms)."""
    cut = len(pattern)
    for ch in "%_":
        i = pattern.find(ch)
        if i >= 0:
            cut = min(cut, i)
    return pattern[:cut] or None


_IMMUTABLE_CELLS = (str, int, float, bool, bytes, type(None))


def _copy_record(r: dict) -> dict:
    """Cache-boundary copy: callers own returned records, so mutable cells
    must not alias the cached copy (columnstore get() guards the store the
    same way). Anything outside the immutable primitives deep-copies —
    a list nested inside a tuple or a custom JSON value would otherwise
    alias the cache (VERDICT r2 Weak #10)."""
    return {
        k: v if isinstance(v, _IMMUTABLE_CELLS) else copy.deepcopy(v)
        for k, v in r.items()
    }


def _partial_first(rows, vk, nk, pkv, want):
    """First `want` rows of the sort by (nk, vk, pk) without sorting the
    full candidate set: argpartition finds a value boundary per null-rank
    group, then only the <=boundary subset (a superset of the answer,
    ties included) is exact-sorted with the pk tie-break. Returns None
    when boundary ties explode (full sort is cheaper)."""
    out = []
    taken = 0
    for grp in (0, 1):
        need = want - taken
        if need <= 0:
            break
        m = nk == grp
        g_rows, g_vk, g_pk = rows[m], vk[m], pkv[m]
        if not len(g_rows):
            continue
        if len(g_rows) <= need:
            out.append(g_rows[np.lexsort((g_pk, g_vk))])
            taken += len(g_rows)
            continue
        part = np.argpartition(g_vk, need - 1)[:need]
        sub = g_vk[part]
        # unicode has no maximum ufunc; a small sort stands in
        boundary = np.sort(sub)[-1] if sub.dtype.kind == "U" else sub.max()
        sel = g_vk <= boundary
        if int(sel.sum()) > 4 * need + 1024:
            return None  # massive ties at the boundary
        s_rows = g_rows[sel]
        idx = np.lexsort((g_pk[sel], g_vk[sel]))[:need]
        out.append(s_rows[idx])
        taken += len(idx)
    return np.concatenate(out) if out else rows[:0]


def _sort_key(v):
    # None sorts first; mixed types compare via (typeclass, value).
    # numpy scalars (column views feed rowid-sort fallbacks) must rank
    # with their Python equivalents — np.int64 is NOT an int and would
    # otherwise stringify into typeclass 3
    if v is None:
        return (0, 0)
    if isinstance(v, (bool, np.bool_)):
        return (1, int(v))
    if isinstance(v, (int, float, np.integer, np.floating)):
        return (2, v)
    return (3, str(v))


class QueryExecutor:
    # per-table-generation invalidated result cache (reference
    # query_executor.dart:33-49)
    CACHE_CAP = 256

    def __init__(self, database):
        self.db = database
        self._cache: dict[tuple, tuple] = {}
        # the cache is read AND mutated (LRU reorder, insert, evict) by
        # queries running under the engine's SHARED mode — this mutex
        # makes those compound dict ops atomic between concurrent readers
        self._cache_lock = threading.Lock()

    def _gen_signature(self, space: str, table_name: str, spec: QuerySpec):
        names = [table_name] + [j.table for j in spec.joins]
        return tuple(self.db._table(n, space).store.generation for n in names)

    # --- planning -----------------------------------------------------------

    # an `in` leaf over an indexed field expands to one bisect arm per value
    MAX_IN_ARMS = 16
    # below this the per-row cost difference between plans is noise
    MIN_COST_ROWS = 256
    # desc-serving span cutoff: measured crossover where the group-reversed
    # span beats the partial top-k sort (0.34 vs 0.47 ms at est=1k;
    # 1.31 vs 0.76 ms at est=10k — limit 20, 100k rows)
    DESC_SPAN_MIN_ROWS = 4096

    def choose_plan(self, table, spec: QuerySpec) -> ExplainInfo:
        """Cost-based index selection (reference query_optimizer.dart:30-43
        + cost_estimator.dart): the condition expands to DNF (<=64 arms,
        query_optimizer.dart:11); each arm resolves to a bisect slice on a
        sorted index, and the EXACT candidate count competes against the
        vectorized table scan. Order-only prefix matches fall back to an
        indexOrder plan."""
        cond = spec.condition
        store = table.store
        n = len(store)
        conjs = (
            cond.dnf() if cond is not None and not cond.is_empty else None
        )
        if conjs and conjs != [[]] and table.sorted_indexes and n:
            # uniform-direction order_by fields act as a cost TIE-BREAKER:
            # an arm whose index continues into the sort keys past its
            # equality prefix serves the ordered-slice fast path (no
            # re-sort; all-desc pages the reversed slice)
            dirs = {d for _, d in spec.order_by}
            want_order = (
                tuple(f for f, _ in spec.order_by)
                if spec.order_by and len(dirs) == 1
                else None
            )
            arms, eq_len = self._plan_arms(table, conjs, want_order)
            if arms is not None:
                est = sum(
                    table.sorted_indexes[name].span_count(store, sp)
                    for name, sp in arms
                )
                # candidates re-filter through the full residual mask, so an
                # arm set covering most of the table loses to one vectorized
                # scan; below the noise floor always take the index
                if est <= self.MIN_COST_ROWS or est <= n // 2:
                    names = sorted({name for name, _ in arms})
                    ordered = ordered_rev = False
                    if eq_len is not None and spec.order_by:
                        sidx = table.sorted_indexes[arms[0][0]]
                        want = tuple(f for f, _ in spec.order_by)
                        # the index must END at the order fields: suffix
                        # fields would order ties by the suffix instead of
                        # the pk-ASC cursor contract (rows vanish from
                        # cursor walks)
                        if (
                            sidx.fields[eq_len : eq_len + len(want)] == want
                            and len(sidx.fields) == eq_len + len(want)
                        ):
                            ordered = dirs == {False}
                            # DESC pays an uncached O(est) group-reverse
                            # over object keys; below the measured
                            # crossover (~2-4k rows at limit 20, see
                            # tests) the partial top-k sort is cheaper
                            ordered_rev = (
                                dirs == {True}
                                and est >= self.DESC_SPAN_MIN_ROWS
                            )
                    return ExplainInfo(
                        "indexScan" if len(arms) == 1 else "indexUnion",
                        ",".join(names),
                        est,
                        arms=arms,
                        ordered=ordered,
                        ordered_rev=ordered_rev,
                    )
        if spec.order_by:
            fields_ = tuple(f for f, _ in spec.order_by)
            for name, sidx in table.sorted_indexes.items():
                # exact match only: a longer index orders ties by its
                # suffix fields, not the pk — see serves_order
                if sidx.fields == fields_:
                    return ExplainInfo("indexOrder", name, n)
        return ExplainInfo("tableScan", None, n)

    def _plan_arms(self, table, conjs: list[list], want_order=None):
        """Resolve each DNF conjunction to a (index, lo, hi) bisect slice;
        None when any conjunction has no usable index (the union would not
        be a superset of the matches). Returns (arms, eq_len) — eq_len is
        the equality-prefix length of a SINGLE-conjunction single arm (for
        the ordered-slice fast path), else None. `want_order` (ascending
        order_by fields) breaks cost ties toward order-serving arms."""
        arms: list[tuple] = []
        eq_len = None
        for leaves in conjs:
            if not leaves:
                return None, None  # TRUE arm: the union is the whole table
            arm, arm_eq = self._best_arm(table, leaves, want_order)
            if arm is None:
                return None, None
            arms.extend(arm)
            eq_len = arm_eq if len(conjs) == 1 and len(arm) == 1 else None
        return arms, eq_len

    @staticmethod
    def _eq_value(bounds):
        """Equality value of an _extract_bounds result, else a no-match
        sentinel (None is a legal value only as 'no bound' here)."""
        if bounds is None:
            return None, False
        lo, hi, lo_open, hi_open = bounds
        if lo is not None and lo == hi and not lo_open and not hi_open:
            return lo, True
        return None, False

    def _best_arm(self, table, leaves: list, want_order=None):
        """Cheapest bisect arm(s) for one AND-conjunction across all sorted
        indexes, using the LONGEST usable composite prefix of each index:
        equality leaves consume leading fields, then one range/eq/in leaf
        on the next field bounds the slice (reference
        query_optimizer.dart's composite-index selection; round-1 only ever
        used fields[0]). Equal-cost arms prefer one whose index continues
        into `want_order` past the equality prefix — that arm serves pages
        pre-sorted (plan.ordered), skipping the result sort entirely."""
        from ..models.schema import DataType

        best: list[tuple] | None = None
        best_est = None
        best_eq = None
        best_ord = False
        store = table.store

        def serves_order(sidx, neq):
            # exact end required: suffix fields past the order spec would
            # break the (order values, pk) tie contract cursor walks need
            return (
                want_order is not None
                and sidx.fields[neq : neq + len(want_order)] == want_order
                and len(sidx.fields) == neq + len(want_order)
            )

        for name, sidx in table.sorted_indexes.items():
            # 1. longest equality prefix
            eq: list = []
            for f in sidx.fields:
                fs = table.schema.field_map.get(f)
                v, is_eq = self._eq_value(_extract_bounds(leaves, f, fs))
                if not is_eq:
                    break
                eq.append(v)
            nxt = sidx.fields[len(eq)] if len(eq) < len(sidx.fields) else None
            bounds = None
            vals = None
            if nxt is not None:
                fs = table.schema.field_map.get(nxt)
                bounds = _extract_bounds(leaves, nxt, fs)
                vals = next(
                    (v for f, op, v in leaves if f == nxt and op == "in"), None
                )
            if eq and bounds is None and vals is None:
                # pure equality prefix (possibly the full index)
                sp = sidx.range_span_multi(store, eq)
                cnt = sidx.span_count(store, sp)
                ok = serves_order(sidx, len(eq))
                if (
                    best_est is None
                    or cnt < best_est
                    or (cnt == best_est and ok and not best_ord)
                ):
                    best, best_est = [(name, sp)], cnt
                    best_eq = len(eq)
                    best_ord = ok
            if bounds is not None:
                if eq:
                    sp = sidx.range_span_multi(store, eq, bounds)
                else:
                    sp = sidx.range_span(store, *bounds)
                cnt = sidx.span_count(store, sp)
                # a range leaf on fields[len(eq)] still yields key-ordered
                # pages when the sort key IS that field (eq_len prefix
                # constant across the slice)
                ok = serves_order(sidx, len(eq))
                if (
                    best_est is None
                    or cnt < best_est
                    or (cnt == best_est and ok and not best_ord)
                ):
                    best, best_est = [(name, sp)], cnt
                    best_eq = len(eq)
                    best_ord = ok
            # LIKE with a literal prefix on the field after the eq prefix:
            # a [prefix, prefix-upper) memcomparable slice (reference
            # searchIndex prefix scans, index_manager.dart:3299). Sound
            # because LIKE is case-sensitive (parity with
            # value_matcher.dart:318); the residual regex re-filters.
            if nxt is not None:
                fs_nxt = table.schema.field_map.get(nxt)
                pat = next(
                    (v for f, op, v in leaves
                     if f == nxt and op == "like" and isinstance(v, str)),
                    None,
                ) if fs_nxt is not None and fs_nxt.type == DataType.text else None
                # text columns only: the memcomparable text tag (0x06)
                # never matches int/float/bool-encoded keys, so a prefix
                # arm on a numeric column would return a FALSE-empty slice
                # while the residual matcher compares str(value)
                lp = _like_literal_prefix(pat) if pat else None
                if lp:
                    sp = sidx.prefix_span_multi(store, eq, lp)
                    cnt = sidx.span_count(store, sp)
                    if best_est is None or cnt < best_est:
                        best, best_est = [(name, sp)], cnt
                        best_eq = None
                        best_ord = False
            # in-list on the field after the prefix: one slice per value
            if vals is not None and 0 < len(vals) <= self.MAX_IN_ARMS:
                fs = table.schema.field_map.get(nxt)
                sub = []
                for v in vals:
                    v = _coerce_index_value(v, fs)
                    if eq:
                        sp = sidx.range_span_multi(
                            store, eq, (v, v, False, False)
                        )
                    else:
                        sp = sidx.range_span(store, v, v)
                    sub.append((name, sp))
                est = sum(sidx.span_count(store, sp) for _, sp in sub)
                if best_est is None or est < best_est:
                    best, best_est = sub, est
                    best_eq = None
                    best_ord = False
        return best, best_eq

    # --- execution -----------------------------------------------------------

    def execute(self, space: str, table_name: str, spec: QuerySpec, overlay=None):
        """`overlay` ({pk: record-with-pk | None}) is the calling thread's
        open-transaction write buffer for this table: overlaid pks replace
        (or tombstone) their base rows and overlay inserts join the match
        set BEFORE joins/aggregation/ordering/pagination — the reference's
        write-buffer merge into query results (query_executor.dart:2152).
        Forces the general (materializing) path and skips the cache."""
        from ..models.results import QueryResult

        table = self.db._table(table_name, space)
        store = table.store

        if overlay is not None and not overlay:
            overlay = None
        buf_txn = self.db._buffering_txn()
        cache_key = None
        # buffering transactions bypass the cache: the narrow predicate
        # read-set needs the actual matched rows, which a cache hit skips
        if spec.use_cache and overlay is None and buf_txn is None:
            cache_key = (space, table_name, spec.fingerprint())
            with self._cache_lock:
                hit = self._cache.get(cache_key)
                if (
                    hit is not None
                    and spec.cache_expiry_s is not None
                    and time.time() - hit[2] > spec.cache_expiry_s
                ):
                    self._cache.pop(cache_key, None)
                    hit = None
                if hit is not None and hit[0] == self._gen_signature(
                    space, table_name, spec
                ):
                    # LRU: re-insert at the hot end so capacity- and
                    # pressure-eviction take the coldest entries first
                    self._cache.pop(cache_key, None)
                    self._cache[cache_key] = hit
                else:
                    hit = None
            if hit is not None:
                res = hit[1]
                return QueryResult(
                    records=[_copy_record(r) for r in res.records],
                    next_cursor=res.next_cursor,
                    prev_cursor=res.prev_cursor,
                    has_more=res.has_more,
                    total=res.total,
                )

        # join queries may predicate on joined-table fields ('r.w' or a
        # '<main>.<field>' spelling): the pre-join scan uses a SUPERSET
        # main-table extraction, and the FULL condition re-applies
        # post-join against merged records (reference
        # query_executor.dart:456-466)
        pre_cond = spec.condition
        post_cond = None
        if (
            spec.joins
            and spec.condition is not None
            and not spec.condition.is_empty
        ):
            pre_cond, chg = self._split_join_condition(
                spec.condition, table_name
            )
            if chg:
                post_cond = spec.condition
                spec = dataclasses.replace(spec, condition=pre_cond)
            else:
                pre_cond = spec.condition

        plan = self.choose_plan(table, spec)

        # 1. candidate rows
        all_desc = bool(spec.order_by) and all(d for _, d in spec.order_by)
        if plan.plan in ("indexScan", "indexUnion"):
            rows = self._rows_from_arms(
                table, plan.arms,
                ordered=plan.ordered or plan.ordered_rev,
                desc=plan.ordered_rev,
            )
        elif plan.plan == "indexOrder":
            rows = table.sorted_indexes[plan.index].ordered_rows(
                store, desc=all_desc
            )
        else:
            rows = np.flatnonzero(store.valid_view())
        # 2. residual predicate as vectorized mask
        if pre_cond is not None and not pre_cond.is_empty and len(rows):
            mask = pre_cond.mask(lambda f: store.column_view(f)[rows], len(rows))
            rows = rows[mask]

        if buf_txn is not None:
            # narrow predicate read: condition + read-time match set
            # (pre-limit rows — phantom protection covers the predicate,
            # not just the returned page). Join tables read table-granular.
            tkey = self.db._tkey(table)
            for j in spec.joins:
                jt = self.db._table(j.table, space)
                buf_txn.read_set.add((self.db._tkey(jt), None))
            if post_cond is not None:
                # join-field predicates can't be re-matched against base
                # rows alone: read the main table table-granular too
                buf_txn.read_set.add((tkey, None))
            cond = pre_cond
            self.db._note_pred_read(
                tkey, cond,
                [store.pk_col.get(int(r)) for r in rows]
                if (cond is not None and not cond.is_empty
                    and len(rows) <= self.db.PRED_READ_MAX_PKS) else None,
            )

        pk_name = table.schema.primary_key.name
        order = spec.order_by or [(pk_name, False)]

        # fast path: sort/paginate ROW IDS and materialize only the page
        # (limit-aware selection, reference handler/topk_heap.dart — a
        # limit(10) over 1M matches must not build 1M record dicts)
        if (
            overlay is None
            and not spec.joins
            and (spec.aggregates or spec.group_by)
        ):
            # vectorized aggregation over typed columns: group codes +
            # bincount/ufunc.at reducers — a sum() over 10M matches must
            # not build 10M record dicts first. Object group keys
            # factorize via np.unique; ineligible shapes (missing
            # columns, pk group keys) take the record path below.
            res = self._aggregate_rows(store, rows, spec)
            if res is not None:
                return res

        if (
            overlay is None
            and spec.joins
            and (spec.aggregates or spec.group_by)
            and not spec.distinct
        ):
            # vectorized join + aggregate: expand rowid pairs, group +
            # reduce on column arrays — an order-count per user over a
            # 500k-pair join must not merge 500k record dicts first
            res = self._aggregate_pairs(
                space, table, store, rows, spec, post_cond,
            )
            if res is not None:
                return res

        if (
            overlay is None
            and spec.joins
            and not spec.aggregates
            and not spec.group_by
            and not spec.distinct
        ):
            # vectorized hash join on ROWIDS: sort the right key column,
            # searchsorted the left keys into it, expand (left, right)
            # pairs (right joins append their unmatched tail), sort
            # pairs by the order spec (either side's fields), materialize
            # only the page — a limit-20 join over 500k rows must not
            # merge 30k record dicts. Ineligible shapes (mixed key
            # dtypes, unresolvable order fields) take the record path.
            res = self._join_rows(
                space, table, store, rows, spec, order, pk_name,
                cache_key, table_name, post_cond,
            )
            if res is not None:
                return res

        if (
            overlay is None
            and len(spec.joins) == 1
            and spec.joins[0].kind in ("inner", "left", "right")
            and not spec.aggregates
            and not spec.group_by
            and spec.distinct
            and spec.select
            and spec.cursor is None
        ):
            # vectorized DISTINCT over join pairs (fully-matched sets
            # only: missing-field identity differs from stored null)
            res = self._distinct_pairs(
                space, table, store, rows, spec, order, pk_name,
                cache_key, table_name, post_cond,
            )
            if res is not None:
                return res

        if (
            overlay is None
            and not spec.joins
            and not spec.aggregates
            and not spec.group_by
            and spec.distinct
            and spec.select
            and spec.cursor is None
        ):
            pre_sorted_d = (
                plan.ordered
                or plan.ordered_rev
                or (
                    plan.plan == "indexOrder"
                    and (all_desc or all(not d for _, d in spec.order_by))
                )
            ) if spec.order_by else False
            res = self._distinct_rows(
                store, rows, spec,
                spec.order_by or [(table.schema.primary_key.name, False)],
                table.schema.primary_key.name, pre_sorted_d,
                space, table_name, cache_key,
            )
            if res is not None:
                return res

        if (
            overlay is None
            and not spec.joins
            and not spec.aggregates
            and not spec.group_by
            # distinct without a projection dedups on all fields
            # INCLUDING the pk — a no-op this path serves directly
            and (not spec.distinct or not spec.select)
        ):
            cmask = None
            kpos = None
            pre_sorted = (
                plan.ordered
                or plan.ordered_rev
                or (
                    plan.plan == "indexOrder"
                    and (all_desc or all(not d for _, d in order))
                )
            )
            if spec.cursor is not None:
                # cursor resume: when the plan already serves the order
                # (pre_sorted), bisect the rowid array to the keyset
                # boundary — O(log n) row probes instead of an O(n) mask
                # (reference index_manager.dart:3299 keyset cursor scans).
                # Otherwise a VECTORIZED strictly-after filter over typed
                # columns (strictly-before for backward prev() pages),
                # then a limit-aware partial sort — a cursor walk over 1M
                # rows must not materialize + python-sort every match per
                # page. Object columns / odd cursor payloads fall back to
                # the exact record-compare path below.
                try:
                    vals, last_pk = _decode_cursor(spec.cursor)
                    if pre_sorted:
                        kpos = self._keyset_bisect(
                            store, rows, order, pk_name, vals, last_pk,
                            inclusive=spec.cursor_backward,
                        )
                    if kpos is None:
                        masks = self._after_cursor_mask(
                            store, rows, order, pk_name, vals, last_pk
                        )
                        if masks is not None:
                            after, eq_row = masks
                            cmask = (
                                ~(after | eq_row)
                                if spec.cursor_backward
                                else after
                            )
                except Exception:
                    cmask = None
                    kpos = None
            if spec.cursor is None or cmask is not None or kpos is not None:
                total = int(len(rows))
                limit = (
                    spec.limit
                    if spec.limit is not None
                    else self.db.config.default_query_limit
                )
                if kpos is not None:
                    if spec.cursor_backward:
                        page_lo = max(0, kpos - limit)
                        start = page_lo
                        back_has_more = kpos < total
                        rows = rows[:kpos]
                    else:
                        start = kpos
                        page_lo = kpos
                elif cmask is not None:
                    rows = rows[cmask]
                    if spec.cursor_backward:
                        # before-cursor rows are the FIRST len(rows)
                        # positions of the ordered match set; the prev
                        # page is their tail
                        page_lo = max(0, int(len(rows)) - limit)
                        start = page_lo
                        want = -1  # tail page: partial first-k invalid
                        # rows at/after the cursor exist (record-path
                        # semantics: has_more = pos < total)
                        back_has_more = int(len(rows)) < total
                    else:
                        start = total - int(len(rows))
                        want = limit
                        page_lo = 0
                else:
                    start = (
                        min(spec.offset, self.db.config.max_query_offset)
                        if spec.offset
                        else 0
                    )
                    want = start + limit
                    page_lo = start
                if not pre_sorted:
                    # tableScan (flatnonzero) and indexUnion (np.unique)
                    # yield rowid-sorted candidates; index slices are in
                    # KEY order (cursor-masked sets lose contiguity)
                    rowid_sorted = (
                        cmask is None
                        and plan.plan in ("tableScan", "indexUnion")
                    )
                    rows = self._sort_rows(
                        store, rows, order, pk_name, want,
                        rowid_sorted=rowid_sorted,
                    )
                page_rows = rows[page_lo : page_lo + limit]
                # projection pushdown: a 2-field select over a 30-column
                # table must not gather 30 columns
                fields = self._page_fields(spec, order, pk_name)
                page = store.read_rows(page_rows, fields)
                if fields is None:
                    for rec in page:
                        rec.pop("_system_ingest_ts_ms", None)
                has_more = (
                    back_has_more
                    if (cmask is not None or kpos is not None)
                    and spec.cursor_backward
                    else start + limit < total
                )
                return self._finish(
                    space, table_name, spec, cache_key, page, order, pk_name,
                    total, has_more, start,
                )

        # 3. materialize (+ overlay merge) + joins
        records = store.read_rows(rows)
        for rec in records:
            rec.pop("_system_ingest_ts_ms", None)
        if overlay is not None:
            records = [r for r in records if r.get(pk_name) not in overlay]
            for opk, orec in overlay.items():
                if orec is None:
                    continue
                if (
                    spec.condition is None
                    or spec.condition.is_empty
                    or spec.condition.matches(orec)
                ):
                    full = dict(orec)
                    full.pop("_system_ingest_ts_ms", None)
                    records.append(full)
        for j in self._order_joins(space, table, spec.joins):
            records = self._join(space, records, j)
        if post_cond is not None:
            # joined-field predicates re-apply against merged records
            # (the pre-join scan was a superset)
            records = [r for r in records if post_cond.matches(r)]

        # 4. aggregates / grouping
        if spec.aggregates or spec.group_by:
            return self._aggregate(records, spec)

        # 5. ordering (pk-ASC final tie-break: the same (order, pk) total
        # order as the row-id paths — cursor walks must agree across them)
        records.sort(
            key=lambda r: tuple(
                _sort_key(r.get(f)) if not desc else _NegKey(_sort_key(r.get(f)))
                for f, desc in order
            )
            + (_sort_key(r.get(pk_name)),)
        )

        if spec.distinct:
            seen = set()
            uniq = []
            sel = spec.select or None
            for r in records:
                key = json.dumps(
                    {k: str(v) for k, v in sorted(r.items()) if sel is None or k in sel},
                    default=str,
                )
                if key not in seen:
                    seen.add(key)
                    uniq.append(r)
            records = uniq

        total = len(records)

        # 6. pagination: cursor beats offset
        limit = spec.limit if spec.limit is not None else self.db.config.default_query_limit
        start = 0
        if spec.cursor:
            vals, last_pk = _decode_cursor(spec.cursor)
            ckey = tuple(
                _sort_key(v) if not desc else _NegKey(_sort_key(v))
                for v, (f, desc) in zip(vals, order)
            ) + (_sort_key(last_pk),)
            pos = len(records)
            strict = not spec.cursor_backward
            for i, r in enumerate(records):
                rk = tuple(
                    _sort_key(r.get(f)) if not desc else _NegKey(_sort_key(r.get(f)))
                    for f, desc in order
                ) + (_sort_key(r.get(pk_name)),)
                # forward: first record strictly after the cursor row;
                # backward: first at-or-after — the prev page ends there
                if (rk > ckey) if strict else (rk >= ckey):
                    pos = i
                    break
            if spec.cursor_backward:
                start = max(0, pos - limit)
                page = records[start:pos]
                has_more = pos < total
                return self._finish(
                    space, table_name, spec, cache_key, page, order,
                    pk_name, total, has_more, start,
                )
            start = pos
        elif spec.offset:
            start = min(spec.offset, self.db.config.max_query_offset)

        page = records[start : start + limit]
        has_more = start + limit < total
        return self._finish(
            space, table_name, spec, cache_key, page, order, pk_name,
            total, has_more, start,
        )

    def _finish(
        self, space, table_name, spec, cache_key, page, order, pk_name,
        total, has_more, start,
    ):
        """Shared tail: cursors, projection, result + cache store."""
        from ..models.results import QueryResult

        next_cursor = None
        if page and has_more:
            last = page[-1]
            next_cursor = _encode_cursor([last.get(f) for f, _ in order], last.get(pk_name))
        prev_cursor = None
        if page and start > 0:
            first = page[0]
            prev_cursor = _encode_cursor([first.get(f) for f, _ in order], first.get(pk_name))

        # projection
        if spec.select:
            page = [
                {spec.aliases.get(k, k): r.get(k) for k in spec.select} for r in page
            ]
        elif spec.aliases:
            page = [
                {spec.aliases.get(k, k): v for k, v in r.items()} for r in page
            ]

        result = QueryResult(
            records=page,
            next_cursor=next_cursor,
            prev_cursor=prev_cursor,
            has_more=has_more,
            total=total,
        )
        if cache_key is not None and self.db.resources.level() != "critical":
            with self._cache_lock:
                self._cache_insert(cache_key, space, table_name, spec, page,
                                   next_cursor, prev_cursor, has_more, total)
        return result

    def _cache_insert(self, cache_key, space, table_name, spec, page,
                      next_cursor, prev_cursor, has_more, total):
        from ..models.results import QueryResult

        if len(self._cache) >= self.CACHE_CAP:
            self._cache.pop(next(iter(self._cache)))
        self._cache[cache_key] = (
                self._gen_signature(space, table_name, spec),
                QueryResult(
                    records=[_copy_record(r) for r in page],
                    next_cursor=next_cursor,
                    prev_cursor=prev_cursor,
                    has_more=has_more,
                    total=total,
                ),
                time.time(),  # stored-at, for cache_expiry_s staleness
            )

    def shrink_under_pressure(self, level: str) -> int:
        """Memory-pressure eviction (reference cache_manager.dart:226 +
        resource budget split resource_manager.dart:34-39): `warning` drops
        the coldest half — lowest-access-weight tables first within LRU
        order — `critical` clears the cache. Returns evicted count."""
        if level not in ("warning", "critical") or not self._cache:
            return 0
        with self._cache_lock:
            return self._shrink_locked(level)

    def _shrink_locked(self, level: str) -> int:
        if level == "critical":
            n = len(self._cache)
            self._cache.clear()
            return n
        target = len(self._cache) // 2
        wm = self.db.weights
        tw = {name: wm.table_weight(name) for name in {k[1] for k in self._cache}}
        victims = sorted(self._cache, key=lambda k: tw[k[1]])[:target]
        for k in victims:
            del self._cache[k]
        return len(victims)

    # --- row-level ordering ---------------------------------------------------

    def _sort_rows(
        self, store, rows: np.ndarray, order: list, pk_name: str, want: int,
        rowid_sorted: bool = False,
    ) -> np.ndarray:
        """Stable sort of candidate rowids by the order spec, entirely on
        typed column arrays (np.lexsort); object columns fall back to a
        Python key sort of rowids (still no record materialization). When
        one field orders a large candidate set and only `want` rows matter,
        an argpartition pass prunes before the exact stable sort."""
        if len(rows) <= 1:
            return rows
        keys = self._lex_keys(store, rows, order, pk_name, rowid_sorted)
        if keys is None:
            views = {f: store.column_view(f) for f, _ in order}
            pkc = store.pk_col
            return np.asarray(
                sorted(
                    rows.tolist(),
                    key=lambda r: tuple(
                        _sort_key(views[f][r])
                        if not d
                        else _NegKey(_sort_key(views[f][r]))
                        for f, d in order
                    )
                    + (_sort_key(pkc.get(int(r))),),
                ),
                np.int64,
            )
        if len(order) == 1 and want >= 0 and want * 4 < len(rows) and len(rows) >= 8192:
            res = _partial_first(rows, keys[-2], keys[-1], keys[0], want)
            if res is not None:
                return res
        return rows[np.lexsort(keys)]

    def _lex_keys(self, store, rows, order, pk_name, rowid_sorted=False):
        """np.lexsort keys (last = most significant) for typed columns —
        plus str object columns, which sort vectorized: ascending as
        numpy 'U' keys (code-point order == UTF-8 byte order == the
        memcomparable text order), descending as complemented np.unique
        rank codes (one vectorized 'U' sort; byte order itself has no
        elementwise inverse). Returns None for mixed-type object fields
        (python key sort handles them). Each
        field contributes (null-rank, value): nulls sort first ascending
        and last descending, matching _sort_key/_NegKey semantics;
        descending inverts exactly via ~int / -float."""
        keys = []
        # tombstone-free rowid-sorted candidate sets are contiguous:
        # slice instead of fancy-index (8ms -> ~0 on a 1M-row scan). Index
        # slices are in key order, where the range test can accidentally
        # pass on a permutation — hence the rowid_sorted gate.
        lo = int(rows[0])
        contiguous = rowid_sorted and int(rows[-1]) - lo + 1 == len(rows)
        # pk-ASC final tie-break, least significant (appended first):
        # every sort path must emit the same (order fields, pk) total
        # order or cursor pagination skips/duplicates tied rows
        pkc = store.pk_col
        pkc._grow(store.high)
        pk_raw = pkc.data[lo : lo + len(rows)] if contiguous else pkc.data[rows]
        if pkc.np_type is None:
            pk_lst = pk_raw.tolist()
            if not all(isinstance(x, str) for x in pk_lst):
                return None
            pk_raw = np.asarray(pk_lst, dtype="U")
        keys.append(pk_raw)
        for f, desc in reversed(order):
            col = store.pk_col if f == pk_name else store.columns.get(f)
            if col is None:
                return None
            col._grow(store.high)
            if col.np_type is None:
                v = (
                    col.data[lo : lo + len(rows)]
                    if contiguous
                    else col.data[rows]
                )
                ks = self._field_keys(v, None, desc)
            elif contiguous:
                ks = self._field_keys(
                    col.data[lo : lo + len(rows)],
                    col.null[lo : lo + len(rows)],
                    desc,
                )
            else:
                ks = self._field_keys(col.data[rows], col.null[rows], desc)
            if ks is None:
                return None
            keys.extend(ks)
        return keys

    @staticmethod
    def _field_keys(vals, nulls, desc):
        """One order field's (value key, null-rank key) lexsort
        contribution. `nulls` is a mask for typed arrays, None for object
        arrays (None sentinels inline — str-only, or bail). Descending
        numerics invert exactly via ~int / -float; descending text uses
        np.unique rank codes (byte order has no elementwise inverse; the
        nk key dominates for nulls, whose ""-placeholder rank is
        harmless). Returns None for mixed-type object fields — the
        python _sort_key path ranks those."""
        if nulls is None:
            lst = vals.tolist()
            if not all(x is None or isinstance(x, str) for x in lst):
                return None  # mixed types rank via _sort_key
            nulls = np.fromiter(
                (x is None for x in lst), np.bool_, count=len(lst)
            )
            try:
                vk = np.asarray(
                    ["" if x is None else x for x in lst], dtype="U"
                )
            except (TypeError, ValueError):
                return None
            if desc:
                _, inv = np.unique(vk, return_inverse=True)
                return [~inv.astype(np.int64), nulls.astype(np.int8)]
            return [vk, (~nulls).astype(np.int8)]
        if vals.dtype == np.bool_:
            vals = vals.astype(np.int8)
        if nulls.any():
            # the value key still participates below the null-rank key:
            # null rows must carry ONE canonical value or they order by
            # residual storage values (clipped join-tail rows read row 0,
            # not the store's zero fill) instead of the next order field
            vals = np.where(nulls, vals.dtype.type(0), vals)
        if desc:
            vk = -vals if vals.dtype.kind == "f" else ~vals
            nk = nulls.astype(np.int8)
        else:
            vk = vals
            nk = (~nulls).astype(np.int8)
        return [vk, nk]

    def _keyset_bisect(
        self, store, rows: np.ndarray, order: list, pk_name: str,
        vals: list, last_pk, inclusive: bool,
    ) -> int | None:
        """O(log n) keyset cursor boundary over a PRE-SORTED rowid array
        (reference index_manager.dart:3299 keyset cursor scans): index of
        the first row whose (order values, pk-ASC) total-order key is
        strictly after (or at-or-after, when `inclusive` — backward
        prev() pages) the cursor's. The comparator is byte-for-byte the
        record path's (_sort_key / _NegKey per desc field, pk-ASC final
        tie) so navigation agrees across all paths; ~20 row probes
        replace the O(n) strictly-after mask a 1M-row cursor walk paid
        per page. Returns None when an order field has no column (caller
        falls back to the masked path)."""
        m = int(len(rows))
        if len(vals) != len(order):
            return None
        cols = []
        for f, desc in list(order) + [(pk_name, False)]:
            col = store.pk_col if f == pk_name else store.columns.get(f)
            if col is None:
                return None
            col._grow(store.high)
            cols.append((col, desc))
        ckey = tuple(
            _NegKey(_sort_key(v)) if desc else _sort_key(v)
            for v, (_, desc) in zip(list(vals) + [last_pk], cols)
        )

        def rkey(i: int):
            rid = int(rows[i])
            return tuple(
                _NegKey(_sort_key(col.get(rid))) if desc
                else _sort_key(col.get(rid))
                for col, desc in cols
            )

        lo, hi = 0, m
        while lo < hi:
            mid = (lo + hi) // 2
            k = rkey(mid)
            if (k >= ckey) if inclusive else (k > ckey):
                hi = mid
            else:
                lo = mid + 1
        return lo

    def _after_cursor_mask(
        self, store, rows: np.ndarray, order: list, pk_name: str,
        vals: list, last_pk,
    ):
        """(after, equal) boolean masks over candidate `rows` vs the
        cursor position (order values, then pk ascending as the final
        tie-break — the same lexicographic rule as the record-compare
        path): `after` = strictly greater, `equal` = the cursor row
        itself; strictly-before (backward pages) = ~(after | equal).
        Null ranks match _sort_key/_NegKey: nulls first ascending, last
        descending. str object columns compare vectorized (python str
        comparison is code-point order, exactly numpy 'U' order); mixed
        object fields return None — caller falls back to the exact
        path."""
        m = len(rows)
        if m == 0:
            z = np.zeros(0, np.bool_)
            return z, z
        if len(vals) != len(order):
            return None
        levels = []
        for (f, desc), cval in zip(
            list(order) + [(pk_name, False)], list(vals) + [last_pk]
        ):
            col = store.pk_col if f == pk_name else store.columns.get(f)
            if col is None:
                return None
            col._grow(store.high)
            v = col.data[rows]
            if col.np_type is None:
                nl = None  # object: None sentinels ride the values
            elif col.null is not None:
                nl = col.null[rows]
            else:
                nl = np.zeros(m, np.bool_)
            levels.append((v, nl, desc, cval))
        return self._cursor_masks_from_arrays(levels)

    def _order_joins(self, space: str, table, joins: list) -> list:
        """Join ordering: run INNER joins most-selective-first (smallest
        right table) so later joins probe a shrunken record set; LEFT joins
        follow in declared order (they never remove records, so moving them
        after inners is sound when every join keys off a base-table field).
        Any RIGHT join, or a join keyed off a joined-in field, keeps the
        declared order (reordering could change semantics)."""
        if len(joins) < 2:
            return joins
        base_fields = set(table.schema.field_map) | {table.schema.primary_key.name}
        if any(j.kind == "right" for j in joins) or not all(
            j.left_field in base_fields for j in joins
        ):
            return joins
        # _join merges with setdefault (first writer wins an unqualified
        # shared field name), so reordering is only sound when the joined
        # tables' field names are pairwise disjoint
        seen: set = set()
        for j in joins:
            fields = set(self.db._table(j.table, space).schema.field_map)
            if seen & fields:
                return joins
            seen |= fields
        inner = [j for j in joins if j.kind == "inner"]
        rest = [j for j in joins if j.kind != "inner"]
        inner.sort(key=lambda j: len(self.db._table(j.table, space).store))
        return inner + rest

    def _rows_from_arms(
        self, table, arms: list[tuple], ordered=False, desc=False
    ) -> np.ndarray:
        """Candidate rows for resolved bisect arms; unions dedupe.
        `ordered` (single-arm plans only) asks the index to merge pending
        delta-log rows at their key position — required by the ordered-slice
        fast path, which pages the span without re-sorting; `desc` serves
        the group-reversed key-DESC view."""
        store = table.store
        if len(arms) == 1:
            name, sp = arms[0]
            return table.sorted_indexes[name].span_rows(
                store, sp, ordered=ordered, desc=desc
            )
        parts = [
            table.sorted_indexes[name].span_rows(store, sp)
            for name, sp in arms
        ]
        cat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        return np.unique(cat)

    def _join(self, space: str, records: list[dict], j: JoinSpec) -> list[dict]:
        right = self.db._table(j.table, space)
        rstore = right.store
        rrows = np.flatnonzero(rstore.valid_view())
        rvals = rstore.column_view(j.right_field)[rrows]
        rmap: dict = {}
        for rr, rv in zip(rrows, rvals):
            if rv is not None:
                rmap.setdefault(rv, []).append(rr)

        out = []
        matched_right = set()
        rcache: dict[int, dict] = {}  # right rows materialize once

        def rrec_of(rr):
            rrec = rcache.get(rr)
            if rrec is None:
                rrec = rstore.read_row(int(rr))
                rrec.pop("_system_ingest_ts_ms", None)
                rcache[rr] = rrec
            return rrec

        for rec in records:
            lv = rec.get(j.left_field)
            hits = rmap.get(lv, []) if lv is not None else []
            if hits:
                for rr in hits:
                    matched_right.add(rr)
                    rrec = rrec_of(rr)
                    merged = dict(rec)
                    for k, v in rrec.items():
                        merged.setdefault(k, v)
                        merged[f"{j.table}.{k}"] = v
                    out.append(merged)
            elif j.kind == "left":
                out.append(dict(rec))
        if j.kind == "right":
            for rr in rrows:
                if rr not in matched_right:
                    rrec = rrec_of(rr)
                    merged = dict(rrec)
                    for k, v in rrec.items():
                        merged[f"{j.table}.{k}"] = v
                    out.append(merged)
        return out

    def _aggregate(self, records: list[dict], spec: QuerySpec):
        groups: dict[tuple, list[dict]] = {}
        for r in records:
            key = tuple(r.get(g) for g in spec.group_by) if spec.group_by else ()
            groups.setdefault(key, []).append(r)

        aggs = spec.aggregates or [Agg.count()]
        out = []
        for key, recs in groups.items():
            row = dict(zip(spec.group_by, key))
            for a in aggs:
                vals = [r.get(a.field) for r in recs] if a.field else [1] * len(recs)
                row[a.name] = a.apply(vals)
            out.append(row)
        return self._agg_tail(out, spec)

    def _agg_tail(self, out: list[dict], spec: QuerySpec):
        """Shared aggregate finish: having, ordering, offset/limit."""
        from ..models.results import QueryResult

        if spec.having is not None:
            out = [r for r in out if spec.having.matches(r)]
        if spec.order_by:
            out.sort(
                key=lambda r: tuple(
                    _sort_key(r.get(f)) if not desc else _NegKey(_sort_key(r.get(f)))
                    for f, desc in spec.order_by
                )
            )
        total = len(out)
        if spec.offset or spec.limit:
            end = spec.offset + spec.limit if spec.limit else None
            out = out[spec.offset : end]
        return QueryResult(records=out, total=total)

    @staticmethod
    def _factorize(
        rows: np.ndarray, cols: list, str_objects: bool = False
    ) -> np.ndarray:
        """Dense int64 codes for the value combinations of `cols` over
        `rows` (codes may include empty buckets; bucket 0 = null). Typed
        columns factorize with one np.unique sort; object (text) columns
        use dict factorization — ~10x cheaper than an object-compare sort
        at 1M rows. Multi-column combines by mixed radix, re-densified
        per step. `str_objects` keys object cells on str(value) — the
        record path's DISTINCT identity (which also makes unhashable
        json/array cells factorizable); group_by keeps raw-value identity
        (the record path groups on raw tuples)."""
        pairs = [
            (
                c.data[rows],
                c.null[rows] if c.np_type is not None else None,
            )
            for c in cols
        ]
        return QueryExecutor._factorize_arrays(pairs, len(rows), str_objects)

    @staticmethod
    def _factorize_arrays(
        pairs: list, m: int, str_objects: bool = False
    ) -> np.ndarray:
        """_factorize over explicit (values, nulls) arrays — nulls is a
        bool mask for typed arrays, None for object arrays (which carry
        None sentinels inline). Join-pair aggregation resolves its
        columns across two stores and feeds them here."""
        codes = None
        for v, nulls in pairs:
            if nulls is not None:
                nn = ~nulls
                f = np.zeros(m, np.int64)
                if nn.any():
                    _, inv = np.unique(v[nn], return_inverse=True)
                    f[nn] = inv + 1
            elif str_objects:
                tbl: dict = {}
                get = tbl.setdefault
                # record-path key is str(v) with NO null special-case
                # (None collapses with the string "None" there too)
                f = np.asarray(
                    [get(str(x), len(tbl) + 1) for x in v.tolist()],
                    np.int64,
                )
            else:
                tbl = {}
                get = tbl.setdefault
                f = np.asarray(
                    [
                        0 if x is None else get(x, len(tbl) + 1)
                        for x in v.tolist()
                    ],
                    np.int64,
                )
            if codes is None:
                codes = f
            else:
                codes = codes * (int(f.max(initial=0)) + 1) + f
                _, codes = np.unique(codes, return_inverse=True)
        return codes

    @staticmethod
    def _join_sortable(col, rr: np.ndarray):
        """(values, null mask) of a join-key column as a numpy-comparable
        array; None for mixed-type object columns."""
        col._grow(int(rr.max()) + 1 if len(rr) else 0)
        v = col.data[rr]
        if col.np_type is None:
            lst = v.tolist()
            if not all(x is None or isinstance(x, str) for x in lst):
                return None, None
            nl = np.fromiter((x is None for x in lst), np.bool_, count=len(lst))
            return np.asarray(["" if x is None else x for x in lst], "U"), nl
        nl = col.null[rr]
        if v.dtype == np.bool_:
            v = v.astype(np.int64)
        return v, nl

    def _expand_pairs(self, space, table, store, rows: np.ndarray, j):
        """Vectorized pair expansion for ONE equality join: argsort the
        right key column + searchsorted the left keys (ties keep
        right-rowid order, same as the record path's rmap insertion
        order). Returns (right_table, exp_left, exp_right, total) with
        exp_right = -1 for a left join's unmatched rows; a right join
        appends its unmatched right rows as (exp_left = -1) entries
        AFTER the matched pairs in right-rowid order, exactly the record
        path's append order (stable sorts preserve it through ties).
        None for shapes the record path must handle (mixed key dtypes,
        exotic columns, unknown kinds — builders validate, but a
        hand-built spec must not silently take left semantics here while
        the record path treats it as inner)."""
        if j.kind not in ("inner", "left", "right"):
            return None
        pk_name = table.schema.primary_key.name
        right = self.db._table(j.table, space)
        rstore = right.store
        lcol = (
            store.pk_col if j.left_field == pk_name
            else store.columns.get(j.left_field)
        )
        rpk = right.schema.primary_key.name
        rcol = (
            rstore.pk_col if j.right_field == rpk
            else rstore.columns.get(j.right_field)
        )
        if lcol is None or rcol is None:
            return None
        lv, lnl = self._join_sortable(lcol, rows)
        if lv is None:
            return None
        rrows = np.flatnonzero(rstore.valid_view())
        rv, rnl = self._join_sortable(rcol, rrows)
        if rv is None:
            return None
        if lv.dtype.kind != rv.dtype.kind:
            return None  # int-vs-float equality differs from numpy casts
        rgood = ~rnl
        rr2, rv2 = rrows[rgood], rv[rgood]
        order_r = np.argsort(rv2, kind="stable")  # ties: right rowid ASC
        rv_sorted, rr_sorted = rv2[order_r], rr2[order_r]
        lo = np.searchsorted(rv_sorted, lv, side="left")
        hi = np.searchsorted(rv_sorted, lv, side="right")
        counts = (hi - lo).astype(np.int64)
        counts[lnl] = 0  # null keys never join (record-path semantics)
        if j.kind in ("inner", "right"):
            sel = counts > 0
            rows_m, lo_m, cnt_m = rows[sel], lo[sel], counts[sel]
            total = int(cnt_m.sum())
            exp_left = np.repeat(rows_m, cnt_m)
            base = np.repeat(np.cumsum(cnt_m) - cnt_m, cnt_m)
            within = np.arange(total, dtype=np.int64) - base
            exp_right = (
                rr_sorted[np.repeat(lo_m, cnt_m) + within]
                if total
                else np.zeros(0, np.int64)
            )
            if j.kind == "right":
                # unmatched rights (incl. null-keyed ones dropped from
                # rr_sorted) append once each, right-rowid ASC — the
                # record path's `for rr in rrows` tail order. Range
                # coverage marks matched sorted positions.
                if total:
                    marks = np.zeros(len(rr_sorted) + 1, np.int64)
                    np.add.at(marks, lo_m, 1)
                    np.add.at(marks, lo_m + cnt_m, -1)
                    matched_rr = rr_sorted[np.cumsum(marks[:-1]) > 0]
                else:
                    matched_rr = np.zeros(0, np.int64)
                tail = np.setdiff1d(rrows, matched_rr)
                if len(tail):
                    exp_left = np.concatenate(
                        [exp_left, np.full(len(tail), -1, np.int64)]
                    )
                    exp_right = np.concatenate([exp_right, tail])
                    total += len(tail)
        else:  # left join: unmatched rows emit once with no right fields
            cnt2 = np.maximum(counts, 1)
            total = int(cnt2.sum())
            exp_left = np.repeat(rows, cnt2)
            base = np.repeat(np.cumsum(cnt2) - cnt2, cnt2)
            within = np.arange(total, dtype=np.int64) - base
            matched = np.repeat(counts > 0, cnt2)
            if len(rr_sorted):
                rpos = np.minimum(
                    np.repeat(lo, cnt2) + within, len(rr_sorted) - 1
                )
                exp_right = np.where(matched, rr_sorted[rpos], -1)
            else:
                exp_right = np.full(total, -1, np.int64)
        return right, exp_left, exp_right, total

    def _base_pk_key(self, store, exp_left, m):
        """(initial lexsort key list, pk_vals, pk_nulls) for the base-pk
        tie over pair arrays without base-side sentinels; None for
        mixed-type object pks (record path ranks them)."""
        pkc = store.pk_col
        pkc._grow(store.high)
        pk_raw = pkc.data[exp_left]
        if pkc.np_type is None:
            lst = pk_raw.tolist()
            if not all(isinstance(x, str) for x in lst):
                return None
            pk_raw = np.asarray(lst, dtype="U")
            return [pk_raw], pk_raw, None
        pk_nulls = (
            pkc.null[exp_left]
            if pkc.null is not None
            else np.zeros(m, np.bool_)
        )
        return [pk_raw], pk_raw, pk_nulls

    def _order_keys_levels(
        self, order, pk_name, pk_vals, pk_nulls, keys, resolve,
    ):
        """Extend lexsort `keys` with each order field's _field_keys and
        build the aligned cursor `levels` (order-spec order + the pk
        level last). `resolve(field) -> (vals, nulls) | None`. The
        levels MUST rank identically to the keys — cursor positions are
        counted assuming the after-set is a contiguous sorted suffix."""
        levels = []
        for f, desc in reversed(order):
            if f == pk_name:
                vals, nulls = pk_vals, pk_nulls
            else:
                r = resolve(f)
                if r is None:
                    return None
                vals, nulls = r
            ks = self._field_keys(vals, nulls, desc)
            if ks is None:
                return None
            keys.extend(ks)
            levels.append((vals, nulls, desc))
        levels.reverse()
        levels.append((pk_vals, pk_nulls, False))
        return keys, levels

    def _pair_lex_keys(
        self, store, right, j, pk_name, exp_left, exp_right, order,
    ):
        """np.lexsort keys over join PAIRS: each order field resolves
        against the correct side via _pair_field (base wins, right
        fills, qualified names address the right), so ordering by a
        joined-in field stays on the rowid fast path. The final
        tie-break is the pk-named value ascending — the base pk for
        matched pairs (it survives the setdefault merge), and for a
        right join's unmatched tail the right table's pk-named value
        (its records are right-only dicts), null when the right has no
        such name. Returns None when a field resolves on neither side
        or carries mixed object types. Returns (keys, levels) where
        `levels` = [(vals, nulls, desc)] in order-spec order + the pk
        level last — the cursor-mask inputs for cursor pages over
        joins."""
        rstore = right.store
        lunm = exp_left < 0
        if not lunm.any():
            lunm = None
        lclip = np.maximum(exp_left, 0)
        runm = exp_right < 0
        if not runm.any():
            runm = None
        rclip = np.maximum(exp_right, 0)
        m = len(exp_left)
        pkc = store.pk_col
        pkc._grow(store.high)
        if lunm is None:
            bk = self._base_pk_key(store, exp_left, m)
            if bk is None:
                return None
            keys, pk_vals, pk_nulls = bk
        else:
            # right-join tail present: per-row pk source — keep it to
            # same-typed NUMERIC pks (string/mixed shapes record-path)
            if pkc.np_type is None or store.high == 0:
                return None
            pk_vals = pkc.data[lclip].copy()
            pk_nulls = lunm.copy()
            rpk = right.schema.primary_key.name
            rpc = (
                rstore.pk_col if rpk == pk_name
                else rstore.columns.get(pk_name)
            )
            if rpc is not None and rstore.high > 0:
                if rpc.np_type is None:
                    return None
                rpc._grow(rstore.high)
                rv = rpc.data[rclip]
                if rv.dtype.kind != pk_vals.dtype.kind:
                    return None
                np.copyto(pk_vals, rv.astype(pk_vals.dtype), where=lunm)
                rn = (
                    rpc.null[rclip]
                    if rpc.null is not None
                    else np.zeros(m, np.bool_)
                )
                pk_nulls = np.where(lunm, rn, np.zeros(m, np.bool_))
            keys = list(self._field_keys(pk_vals, pk_nulls, False))

        def resolve(f):
            r = self._pair_field(
                store, rstore, j.table, pk_name, lclip, lunm, rclip,
                runm, f, j.kind,
            )
            return None if r is None else (r[3], r[4])

        return self._order_keys_levels(
            order, pk_name, pk_vals, pk_nulls, keys, resolve,
        )

    def _join_rows(
        self, space, table, store, rows: np.ndarray, spec: QuerySpec,
        order, pk_name, cache_key, table_name, post_cond=None,
    ):
        """Row-id fast path for ONE equality join (inner, left, or
        right): expand (left, right) rowid pairs, sort them by the order
        spec (fields resolve against either side, pk-named tie-break),
        and materialize + merge only the page. Returns None for shapes
        the record path must handle (mixed key dtypes, unresolvable
        order fields). 2+ joins route to the mixed-radix multi path."""
        if len(spec.joins) > 1:
            return self._join_rows_multi(
                space, table, store, rows, spec, order, pk_name,
                cache_key, table_name, post_cond,
            )
        j = spec.joins[0]
        # order-field resolvability is a name lookup — check before the
        # O(pairs) expansion so unresolvable shapes don't pay for a
        # discarded expansion on top of the record path's own join
        rstore0 = self.db._table(j.table, space).store
        for f, _ in order:
            if f != pk_name and (
                self._pair_col(store, rstore0, j.table, pk_name, f, j.kind)
                is None
            ):
                return None
        if self._cursor_precheck(spec, order) is None:
            return None
        exp = self._expand_pairs(space, table, store, rows, j)
        if exp is None:
            return None
        right, exp_left, exp_right, total = exp
        rstore = right.store
        if post_cond is not None and total:
            pm = self._pair_cond_mask(
                post_cond, store, rstore, j.table, pk_name, exp_left,
                exp_right, j.kind, table.schema.name,
            )
            if pm is None:
                return None
            exp_left, exp_right = exp_left[pm], exp_right[pm]
            total = int(pm.sum())
        levels = None
        if total:
            kl = self._pair_lex_keys(
                store, right, j, pk_name, exp_left, exp_right, order,
            )
            if kl is None:
                return None  # order fields resolve on neither side
            keys, levels = kl
            perm = np.lexsort(keys)  # stable: pair order survives pk ties
            exp_left, exp_right = exp_left[perm], exp_right[perm]
        sl = self._pair_page_slice(spec, order, levels, total)
        if sl is None:
            return None
        start, stop, has_more = sl
        page = self._materialize_pairs(
            store, rstore, j, exp_left[start:stop], exp_right[start:stop],
            self._page_fields(spec, order, pk_name),
        )
        return self._finish(
            space, table_name, spec, cache_key, page, order, pk_name,
            total, has_more, start,
        )

    @staticmethod
    def _page_fields(spec, order, pk_name):
        """Projection-pushdown field set for a SELECTed page (select +
        order fields + pk for cursors; the internal ingest-ts field
        stays invisible), or None = gather everything."""
        if not spec.select:
            return None
        return (
            set(spec.select) | {f for f, _ in order} | {pk_name}
        ) - {"_system_ingest_ts_ms"}

    @staticmethod
    def _materialize_pairs(store, rstore, j, pl, pr, fields=None):
        """Materialize + merge one PAGE of (left, right) rowid pairs:
        setdefault merge + qualified duplicates; a right join's
        unmatched tail (left = -1) becomes a right-only record — the
        record path's dict(rrec) merge. `fields` (must cover select +
        order + pk) limits the BASE gather; unselected right fills then
        differ from full materialization only in keys the projection
        drops anyway."""
        page = store.read_rows(np.maximum(pl, 0), fields)
        for i, (ll, rr_) in enumerate(zip(pl.tolist(), pr.tolist())):
            if ll < 0:
                rrec = rstore.read_row(int(rr_))
                rrec.pop("_system_ingest_ts_ms", None)
                merged = dict(rrec)
                for k, v in rrec.items():
                    merged[f"{j.table}.{k}"] = v
                page[i] = merged
                continue
            rec = page[i]
            rec.pop("_system_ingest_ts_ms", None)
            if rr_ < 0:
                continue
            rrec = rstore.read_row(int(rr_))
            rrec.pop("_system_ingest_ts_ms", None)
            for k, v in rrec.items():
                rec.setdefault(k, v)
                rec[f"{j.table}.{k}"] = v
        return page

    @staticmethod
    def _cond_pair_col(store, rights, pk_name, main_name, base_unm, field):
        """Resolution for the post-join MATCHER views — which follows
        QueryCondition._field_value's merged-record lookup, NOT r.get:
        '<main>.<field>' suffix-falls-back to the plain name, and a
        qualified '<join>.<field>' on an unmatched row falls back to a
        same-named base column. `rights` = [(jtable, rstore, has_unm)];
        `base_unm` = right-join tail rows exist (right-only dicts).
        Returns 'pk', (col, side), or None = record path (per-row value
        sources the arrays can't express)."""
        if field.startswith(main_name + ".") and all(
            j != main_name for j, _, _ in rights
        ):
            field = field[len(main_name) + 1:]
        for k, (jt, rstore, has_unm) in enumerate(rights):
            if field.startswith(jt + "."):
                x = field[len(jt) + 1:]
                col = rstore.columns.get(x)
                if col is None:
                    return None  # suffix-resolves elsewhere: record path
                if has_unm and (
                    x == pk_name or store.columns.get(x) is not None
                ):
                    # unmatched rows suffix-fall-back to the base column
                    return None
                return col, k
        if field == pk_name:
            # a right-join tail record's pk-named key holds the RIGHT pk
            return None if base_unm else "pk"
        col = store.columns.get(field)
        if col is not None:
            if base_unm and any(
                rs.columns.get(field) is not None for _, rs, _ in rights
            ):
                return None  # tail rows read the right-only dict's value
            return col, -1
        for k, (jt, rstore, _) in enumerate(rights):
            col = rstore.columns.get(field)
            if col is not None:
                return col, k
        return None

    def _pair_cond_mask(
        self, post_cond, store, rstore, jtable, pk_name, exp_left,
        exp_right, kind, main_name,
    ):
        """Vectorized post-join filter over pair arrays: resolve each
        predicate field per the record MATCHER's merged-record lookup
        (_cond_pair_col) and evaluate the FULL condition with
        QueryCondition.mask. Returns a bool mask, or None for shapes the
        record matcher must rank (unresolvable fields, per-row value
        sources, pk predicates over a right-join tail)."""
        lunm = exp_left < 0
        if not lunm.any():
            lunm = None
        lclip = np.maximum(exp_left, 0)
        runm = exp_right < 0
        if not runm.any():
            runm = None
        rclip = np.maximum(exp_right, 0)
        total = len(exp_left)
        rights = [(jtable, rstore, runm is not None)]
        resolved = {}
        for f in post_cond.referenced_fields():
            rc = self._cond_pair_col(
                store, rights, pk_name, main_name, lunm is not None, f,
            )
            if rc is None:
                return None
            resolved[f] = rc

        def view(f):
            rc = resolved[f]
            if rc == "pk":
                pkc = store.pk_col
                pkc._grow(store.high)
                return pkc.data[lclip]
            col, side = rc
            if side < 0:
                rows_, unm, high = lclip, lunm, store.high
            else:
                rows_, unm, high = rclip, runm, rstore.high
            _, _, vals, nulls = self._side_arrays(col, high, rows_, unm)
            if nulls is None or not nulls.any():
                return vals
            out = vals.astype(object)
            out[nulls] = None
            return out

        return post_cond.mask(view, total)

    def _multi_cond_mask(
        self, post_cond, store, joins, rights, pk_name, exp_left,
        exp_rights, main_name,
    ):
        """_pair_cond_mask for the multi-join expansion (no base-side
        sentinels: inner/left only)."""
        rclips = [np.maximum(er, 0) for er in exp_rights]
        runms = []
        for er in exp_rights:
            u = er < 0
            runms.append(u if u.any() else None)
        total = len(exp_left)
        rinfo = [
            (j.table, rt.store, runms[k] is not None)
            for k, (j, rt) in enumerate(zip(joins, rights))
        ]
        resolved = {}
        for f in post_cond.referenced_fields():
            rc = self._cond_pair_col(
                store, rinfo, pk_name, main_name, False, f,
            )
            if rc is None:
                return None
            resolved[f] = rc

        def view(f):
            rc = resolved[f]
            if rc == "pk":
                pkc = store.pk_col
                pkc._grow(store.high)
                return pkc.data[exp_left]
            col, side = rc
            if side < 0:
                rows_, unm, high = exp_left, None, store.high
            else:
                rows_, unm, high = (
                    rclips[side], runms[side], rights[side].store.high,
                )
            _, _, vals, nulls = self._side_arrays(col, high, rows_, unm)
            if nulls is None or not nulls.any():
                return vals
            out = vals.astype(object)
            out[nulls] = None
            return out

        return post_cond.mask(view, total)

    @staticmethod
    def _cursor_precheck(spec, order):
        """True when the spec has no cursor or a decodable one of the
        right arity; None = undecodable/mismatched, record path — a
        name/shape check cheap enough to run before the O(pairs)
        expansion (the value-vs-dtype checks still need the arrays)."""
        if spec.cursor is None:
            return True
        try:
            cvals, _ = _decode_cursor(spec.cursor)
        except Exception:
            return None
        if len(cvals) != len(order):
            return None
        return True

    def _pair_page_slice(self, spec, order, levels, total):
        """(start, stop, has_more) for a join page over `total` sorted
        pairs: offset/limit normally; with a cursor, count the
        strictly-after (forward) or strictly-before (backward) pairs via
        _cursor_masks_from_arrays over the sort-key `levels` — counts
        equal positions because the mask rules and the sort keys rank
        identically, so the after-set is a contiguous suffix. None =
        record path (undecodable cursor, mismatched arity, mixed
        types)."""
        limit = (
            spec.limit
            if spec.limit is not None
            else self.db.config.default_query_limit
        )
        if spec.cursor is not None:
            if total == 0:
                return 0, 0, False
            try:
                cvals, last_pk = _decode_cursor(spec.cursor)
            except Exception:
                return None
            if levels is None or len(cvals) != len(order):
                return None
            marr = self._cursor_masks_from_arrays([
                (v, nl, d, cv)
                for (v, nl, d), cv in zip(levels, list(cvals) + [last_pk])
            ])
            if marr is None:
                return None
            after, eq = marr
            if spec.cursor_backward:
                pos = int((~(after | eq)).sum())
                return max(0, pos - limit), pos, pos < total
            start = total - int(after.sum())
            return start, start + limit, start + limit < total
        start = (
            min(spec.offset, self.db.config.max_query_offset)
            if spec.offset
            else 0
        )
        return start, start + limit, start + limit < total

    def _distinct_pairs(
        self, space, table, store, rows, spec, order, pk_name,
        cache_key, table_name, post_cond,
    ):
        """Vectorized DISTINCT over ONE equality join: sort the pairs,
        factorize the selected pair-resolved columns on the record
        path's str(value) identity, keep each combination's first
        occurrence, materialize only the page. Bails (None) when any
        unmatched sentinel exists — the record path's distinct key
        distinguishes a MISSING field (the json omits it) from a stored
        null (str(None)), so only fully-matched pair sets share the
        plain identity — or when a selected field is unresolvable."""
        j = spec.joins[0]
        sel = spec.select or []
        rstore0 = self.db._table(j.table, space).store
        for f in sel + [f_ for f_, _ in order]:
            if f != pk_name and (
                self._pair_col(store, rstore0, j.table, pk_name, f, j.kind)
                is None
            ):
                return None
        exp = self._expand_pairs(space, table, store, rows, j)
        if exp is None:
            return None
        right, exp_left, exp_right, total = exp
        rstore = right.store
        if post_cond is not None and total:
            pm = self._pair_cond_mask(
                post_cond, store, rstore, j.table, pk_name, exp_left,
                exp_right, j.kind, table.schema.name,
            )
            if pm is None:
                return None
            exp_left, exp_right = exp_left[pm], exp_right[pm]
            total = int(pm.sum())
        limit = (
            spec.limit
            if spec.limit is not None
            else self.db.config.default_query_limit
        )
        start = (
            min(spec.offset, self.db.config.max_query_offset)
            if spec.offset
            else 0
        )
        if total == 0:
            return self._finish(
                space, table_name, spec, cache_key, [], order, pk_name,
                0, False, start,
            )
        if (exp_left < 0).any() or (exp_right < 0).any():
            return None  # missing-field identity differs from null
        kl = self._pair_lex_keys(
            store, right, j, pk_name, exp_left, exp_right, order,
        )
        if kl is None:
            return None
        keys, _ = kl
        perm = np.lexsort(keys)
        exp_left, exp_right = exp_left[perm], exp_right[perm]
        lclip = exp_left
        rclip = exp_right
        pairs = []
        for f in sel:
            if f == pk_name:
                pkc = store.pk_col
                pkc._grow(store.high)
                vals = pkc.data[exp_left]
                nulls = (
                    pkc.null[exp_left]
                    if pkc.np_type is not None and pkc.null is not None
                    else (
                        np.zeros(total, np.bool_)
                        if pkc.np_type is not None
                        else None
                    )
                )
            else:
                r = self._pair_field(
                    store, rstore, j.table, pk_name, lclip, None, rclip,
                    None, f, j.kind,
                )
                if r is None:
                    return None
                _, _, _, vals, nulls = r
            pairs.append((vals, nulls))
        codes = self._factorize_arrays(pairs, total, str_objects=True)
        g0 = int(codes.max()) + 1
        first_idx = np.full(g0, total, np.int64)
        np.minimum.at(first_idx, codes, np.arange(total))
        live = np.flatnonzero(first_idx < total)
        reps = np.sort(first_idx[live])  # result order = sort order
        total_d = len(reps)
        page_idx = reps[start : start + limit]
        page = self._materialize_pairs(
            store, rstore, j, exp_left[page_idx], exp_right[page_idx],
            self._page_fields(spec, order, pk_name),
        )
        return self._finish(
            space, table_name, spec, cache_key, page, order, pk_name,
            total_d, start + limit < total_d, start,
        )

    def _distinct_rows(
        self, store, rows: np.ndarray, spec: QuerySpec, order, pk_name,
        pre_sorted: bool, space, table_name, cache_key,
    ):
        """Vectorized DISTINCT over candidate rowids: sort by the order
        spec, factorize the SELECTED columns, keep each combination's
        first occurrence (= the record path's keep-first-after-sort), and
        materialize only the page. Only reachable with a projection — a
        distinct without select dedups on the pk and is a no-op the plain
        fast path already serves. Returns None when a selected field has
        no column (record path handles it)."""
        sel = spec.select or []
        cols = []
        for f in sel:
            c = store.pk_col if f == pk_name else store.columns.get(f)
            if c is None:
                return None
            cols.append(c)
        m = len(rows)
        limit = (
            spec.limit
            if spec.limit is not None
            else self.db.config.default_query_limit
        )
        start = (
            min(spec.offset, self.db.config.max_query_offset)
            if spec.offset
            else 0
        )
        if m == 0:
            return self._finish(
                space, table_name, spec, cache_key, [], order, pk_name,
                0, False, start,
            )
        for c in cols:
            c._grow(store.high)
        typed_order = pre_sorted or (
            self._lex_keys(store, rows[:1], order, pk_name) is not None
        )
        if typed_order:
            # typed order fields: lexsort ALL rows, then each value
            # combination's first occurrence is its keep-first-after-sort
            # representative and result position
            if not pre_sorted:
                rows = self._sort_rows(store, rows, order, pk_name, -1)
            codes = self._factorize(rows, cols, str_objects=True)
            g0 = int(codes.max()) + 1
            first_idx = np.full(g0, m, np.int64)
            np.minimum.at(first_idx, codes, np.arange(m))
            firsts = np.sort(first_idx[first_idx < m])
            total = int(len(firsts))
            page_rows = rows[firsts[start : start + limit]]
            page = store.read_rows(
                page_rows, self._page_fields(spec, order, pk_name),
            )
        elif {f for f, _ in order} <= set(sel):
            # object order fields, but all of them are PROJECTED: every
            # row of a combination shares the sort key, so a
            # representative projects identically — factorize WITHOUT
            # sorting (a python key-sort of 1M rowids costs seconds) and
            # sort only the G representatives as records. Rows pre-order
            # by pk so each combination's representative is its min-pk
            # row, and the rep sort appends the pk tie-break — both match
            # the record path's keep-first after the (order, pk) sort.
            pkc = store.pk_col
            pkv = pkc.data[rows]
            if pkc.np_type is not None:
                perm = np.argsort(pkv, kind="stable")
            else:
                perm = np.argsort(
                    np.asarray([str(x) for x in pkv.tolist()], "U"),
                    kind="stable",
                )
            rows = rows[perm]
            codes = self._factorize(rows, cols, str_objects=True)
            g0 = int(codes.max()) + 1
            first_idx = np.full(g0, m, np.int64)
            np.minimum.at(first_idx, codes, np.arange(m))
            reps = rows[first_idx[first_idx < m]]
            recs = store.read_rows(reps)
            recs.sort(
                key=lambda r: tuple(
                    _sort_key(r.get(f)) if not d else _NegKey(_sort_key(r.get(f)))
                    for f, d in order
                )
                + (_sort_key(r.get(pk_name)),)
            )
            total = len(recs)
            page = recs[start : start + limit]
        else:
            return None  # unprojected object order field: record path
        for rec in page:
            rec.pop("_system_ingest_ts_ms", None)
        has_more = start + limit < total
        return self._finish(
            space, table_name, spec, cache_key, page, order, pk_name,
            total, has_more, start,
        )

    def _aggregate_rows(self, store, rows: np.ndarray, spec: QuerySpec):
        """Vectorized _aggregate over candidate ROWIDS: factorize group
        keys into dense codes (np.unique; encounter-order-remapped so
        group order matches the dict-insertion record path), then reduce
        each aggregate with bincount / add.at / minimum.at on typed
        column arrays. Returns None when a referenced column is missing
        or an aggregate field is non-numeric (record path handles it).
        Result values match Agg.apply exactly: count(*) counts all rows,
        count(f)/sum/avg/min/max skip nulls, empty -> None, int columns
        stay int (add.at on int64 — no float53 loss), bool min/max stay
        bool, datetime reduces as its epoch-ms int (= Column.get)."""
        m = len(rows)
        aggs = spec.aggregates or [Agg.count()]
        acols = {}
        for a in aggs:
            if a.field:
                c = store.columns.get(a.field)
                # object columns can COUNT (non-None sentinels) but not
                # reduce numerically
                if c is None or (c.np_type is None and a.op != "count"):
                    return None
                acols[a.field] = c
        gcols = []
        for g in spec.group_by:
            c = store.columns.get(g)
            if c is None:
                return None
            gcols.append((g, c))
        if m == 0:
            return self._agg_tail([], spec)
        for c in list(acols.values()) + [c for _, c in gcols]:
            c._grow(store.high)

        if gcols:
            codes = self._factorize(rows, [c for _, c in gcols])
            codes, rep_idx, G = self._encounter_codes(codes, m)
            reps = rows[rep_idx]  # representative rowid per group
        else:
            codes = np.zeros(m, np.int64)
            reps = rows[:1]
            G = 1

        out = [
            {g: c.get(int(rp)) for g, c in gcols}
            for rp in reps
        ]
        aarrs = {}
        for f, c in acols.items():
            v = c.data[rows]
            if c.np_type is None:  # count-only: null mask from sentinels
                nl = np.fromiter(
                    (x is None for x in v.tolist()), np.bool_, count=m
                )
            else:
                nl = c.null[rows]
            aarrs[f] = (v, nl, c.np_type is np.float64)
        if not self._reduce_aggs(aggs, aarrs, codes, G, out):
            return None
        return self._agg_tail(out, spec)

    @staticmethod
    def _encounter_codes(codes, m):
        """Drop empty buckets and renumber group codes by FIRST
        ENCOUNTER so output groups match the record path's
        dict-insertion order; minimum.at finds first occurrences without
        another sort. Returns (renumbered codes, first-occurrence index
        per group, group count)."""
        g0 = int(codes.max()) + 1
        first_idx = np.full(g0, m, np.int64)
        np.minimum.at(first_idx, codes, np.arange(m))
        live = np.flatnonzero(first_idx < m)
        enc = live[np.argsort(first_idx[live], kind="stable")]
        remap = np.empty(g0, np.int64)
        remap[enc] = np.arange(len(enc))
        return remap[codes], first_idx[enc], len(enc)

    @staticmethod
    def _reduce_aggs(aggs, aarrs, codes, G, out) -> bool:
        """Shared vectorized reducers (bincount / add.at / minimum.at)
        writing each aggregate's per-group values into `out`. `aarrs`
        maps field -> (values, null mask, is_float) aligned with `codes`.
        Returns False when an int sum could overflow int64 — the record
        path's arbitrary-precision accumulation must handle it."""
        counts_all = np.bincount(codes, minlength=G)
        for a in aggs:
            if not a.field:
                for gi in range(G):
                    out[gi][a.name] = int(counts_all[gi])
                continue
            v, nl, is_float = aarrs[a.field]
            nn = ~nl
            cnt = np.bincount(codes[nn], minlength=G)
            is_bool = v.dtype == np.bool_
            vv = v[nn]
            if is_bool:
                vv = vv.astype(np.int64)
            ck = codes[nn]
            if a.op == "count":
                vals = [int(x) for x in cnt]
            elif a.op in ("sum", "avg"):
                if not is_float and len(vv):
                    # int64 accumulation wraps silently; the record path
                    # sums in arbitrary-precision Python ints — bail to it
                    # when the worst-case magnitude could overflow
                    # python-int abs: np.abs(int64 min) wraps negative
                    peak = max(abs(int(vv.min())), abs(int(vv.max())))
                    if peak * len(vv) >= 2**62:
                        return False
                acc = np.zeros(G, np.float64 if is_float else np.int64)
                np.add.at(acc, ck, vv)
                if a.op == "sum":
                    vals = [
                        None if cnt[gi] == 0
                        else (float(acc[gi]) if is_float else int(acc[gi]))
                        for gi in range(G)
                    ]
                else:
                    vals = [
                        None if cnt[gi] == 0 else float(acc[gi]) / int(cnt[gi])
                        for gi in range(G)
                    ]
            else:  # min / max
                if is_float:
                    init = np.inf if a.op == "min" else -np.inf
                    acc = np.full(G, init, np.float64)
                else:
                    ii = np.iinfo(np.int64)
                    acc = np.full(
                        G, ii.max if a.op == "min" else ii.min, np.int64
                    )
                (np.minimum if a.op == "min" else np.maximum).at(acc, ck, vv)
                def conv(x):
                    if is_float:
                        return float(x)
                    return bool(x) if is_bool else int(x)
                vals = [
                    None if cnt[gi] == 0 else conv(acc[gi]) for gi in range(G)
                ]
            for gi in range(G):
                out[gi][a.name] = vals[gi]
        return True

    @staticmethod
    def _split_join_condition(cond, table_name):
        """(pre_join_condition_or_None, changed) for join queries —
        the reference's main-table extraction (query_executor.dart:
        190-240 + 456-466): unprefixed leaves and '<main>.<field>'
        leaves stay in the pre-join scan (prefix stripped); leaves
        addressing any other table drop, and an OR whose dropped branch
        could be TRUE makes the whole disjunct TRUE — the pre-filter is
        a SUPERSET, never narrower. pre=None means every base row
        passes. `changed` True => the FULL condition must re-apply
        post-join against merged records."""
        changed = [False]
        prefix = table_name + "."

        def extract(c):
            # returns the superset condition, or None meaning TRUE
            kept = []
            for f, op, v in c._clauses:
                if "." in f:
                    changed[0] = True
                    if f.startswith(prefix):
                        kept.append((f[len(prefix):], op, v))
                    continue  # other-table leaf: dropped (superset)
                kept.append((f, op, v))
            kept_and = []
            for ch in c._and:
                e = extract(ch)
                if e is not None:  # TRUE children leave the AND
                    kept_and.append(e)
            # node semantics: (leaves AND and-children) OR or-children
            if (c._clauses or c._and) and not kept and not kept_and:
                return None  # the AND part became vacuously TRUE
            ors = []
            for ch in c._or:
                e = extract(ch)
                if e is None:
                    return None  # some disjunct is always TRUE
                ors.append(e)
            if not kept and not kept_and and not ors:
                return None
            out = QueryCondition()
            out._clauses = kept
            out._and = kept_and
            out._or = ors
            return out

        pre = extract(cond)
        return pre, changed[0]

    @staticmethod
    def _cursor_masks_from_arrays(levels):
        """(after, equal) cursor masks over pre-gathered key arrays —
        the array-level core of _after_cursor_mask, reused by the join
        fast paths where order fields resolve across tables. `levels` =
        [(vals, nulls_or_None, desc, cursor_value)] most-significant
        first, INCLUDING the pk level last (desc=False). Null ranks and
        compare rules match _sort_key/_NegKey; returns None for shapes
        the record compare must rank (mixed object types, str cursor vs
        numeric column)."""
        m = len(levels[0][0])
        after = np.zeros(m, np.bool_)
        all_eq = np.ones(m, np.bool_)
        for vals, nulls, desc, cval in levels:
            if nulls is None or vals.dtype.kind in ("O", "U"):
                if cval is not None and not isinstance(cval, str):
                    return None
                lst = vals.tolist()
                if not all(x is None or isinstance(x, str) for x in lst):
                    return None
                nl = np.fromiter(
                    (x is None for x in lst), np.bool_, count=m
                )
                if nulls is not None:
                    nl = nl | nulls
                v = np.asarray(
                    ["" if x is None else x for x in lst], dtype="U"
                )
            else:
                v, nl = vals, nulls
                if v.dtype == np.bool_:
                    v = v.astype(np.int8)
                if isinstance(cval, bool):
                    cval = int(cval)
                elif isinstance(cval, str):
                    return None
            nn = ~nl
            if cval is None:
                gt_asc = nn
                lt_asc = np.zeros(m, np.bool_)
                eq = nl
            else:
                gt_asc = nn & (v > cval)
                lt_asc = nl | (nn & (v < cval))
                eq = nn & (v == cval)
            after |= all_eq & (lt_asc if desc else gt_asc)
            all_eq = all_eq & eq
        return after, all_eq

    @staticmethod
    def _pair_col(store, rstore, jtable, pk_name, field, kind="inner"):
        """(column, from_right) per the record-merge resolution rule:
        the '<table>.<field>' qualified form is assigned from the RIGHT
        side unconditionally (the merge loop overwrites even a
        same-named base column); unqualified base fields win (setdefault
        keeps them); right fields fill absent base names. None when the
        field resolves to neither side, or is the base pk — which must
        NOT fall through to a same-named right column (the record merge
        keeps the base value) and bails like the single-table fast
        path. A RIGHT join's unqualified shared names also bail: its
        unmatched tail records are right-only dicts, so the value source
        switches per row (base for matched, right for tail). Cheap: name
        lookups only, safe to call before the O(pairs) expansion."""
        if field == pk_name:
            return None
        if field.startswith(jtable + "."):
            col = rstore.columns.get(field[len(jtable) + 1:])
            if col is not None:
                return col, True
        col = store.columns.get(field)
        if col is not None:
            if kind == "right" and rstore.columns.get(field) is not None:
                return None
            return col, False
        col = rstore.columns.get(field)
        if col is None:
            return None
        return col, True

    def _pair_field(
        self, store, rstore, jtable, pk_name, lclip, lunm, rclip, runm,
        field, kind,
    ):
        """Resolve `field` over join pairs (_pair_col rule) and gather
        its per-pair arrays. Returns (col, side_rows, side_unmatched,
        values, nulls) — nulls is a mask for typed columns, None for
        object columns (None sentinels inline); rows unmatched on the
        resolving side (a left join's right-side misses, a right join's
        tail on base fields) are nulled either way. None when the field
        resolves to neither side (record path)."""
        pc = self._pair_col(store, rstore, jtable, pk_name, field, kind)
        if pc is None:
            return None
        col, from_right = pc
        if from_right:
            owner_high, rows_, unm = rstore.high, rclip, runm
        else:
            owner_high, rows_, unm = store.high, lclip, lunm
        return (col,) + self._side_arrays(col, owner_high, rows_, unm)

    @staticmethod
    def _side_arrays(col, owner_high, rows_, unm):
        """(side_rows, side_unmatched, values, nulls) for one resolved
        join-side column — the shared gather behind _pair_field and
        _multi_field. An empty owning side (0 rows) nulls every entry;
        clipped sentinel rows are nulled via `unm`."""
        m = len(rows_)
        if owner_high == 0:
            unm = np.ones(m, np.bool_)
            if col.np_type is None:
                return rows_, unm, np.full(m, None, object), None
            return (
                rows_, unm, np.zeros(m, col.np_type), np.ones(m, np.bool_),
            )
        col._grow(owner_high)
        vals = col.data[rows_]
        if col.np_type is None:
            if unm is not None and unm.any():
                vals = vals.copy()
                vals[unm] = None
            return rows_, unm, vals, None
        nulls = col.null[rows_]
        if unm is not None:
            nulls = nulls | unm
        return rows_, unm, vals, nulls

    # -- multi-join (2+ inner/left equality joins keyed off base fields) --

    def _multi_plan(self, space, table, spec):
        """Cheap eligibility for the multi-join fast path, mirroring the
        shapes _order_joins can soundly reorder: every join inner/left
        and keyed off a base field, right tables' field names pairwise
        disjoint (the record merge's first-writer-wins makes shared
        names order-dependent). Returns (ordered joins, right tables) —
        the SAME reordered sequence the record path applies, so pair
        enumeration order matches — or None."""
        base_fields = set(table.schema.field_map) | {
            table.schema.primary_key.name
        }
        seen: set = set()
        for j in spec.joins:
            if j.kind not in ("inner", "left"):
                return None
            if j.left_field not in base_fields:
                return None
            fields = set(
                self.db._table(j.table, space).schema.field_map
            )
            if seen & fields:
                return None
            seen |= fields
        joins = self._order_joins(space, table, spec.joins)
        rights = [self.db._table(j.table, space) for j in joins]
        return joins, rights

    def _multi_col(self, store, joins, rights, pk_name, field):
        """(column, side) resolving `field` across base + N right
        tables per the sequential record merge: qualified
        '<table>.<field>' from that join's right side, unqualified base
        fields win, right fields fill absent names (unique among rights
        by the disjointness precondition). side = -1 for base, else the
        join index. None when unresolvable or the base pk."""
        if field == pk_name:
            return None
        for k, j in enumerate(joins):
            if field.startswith(j.table + "."):
                col = rights[k].store.columns.get(
                    field[len(j.table) + 1:]
                )
                if col is not None:
                    return col, k
        col = store.columns.get(field)
        if col is not None:
            return col, -1
        for k in range(len(joins)):
            col = rights[k].store.columns.get(field)
            if col is not None:
                return col, k
        return None

    def _expand_multi(self, store, rows, joins, rights, pk_name):
        """Mixed-radix pair expansion for N inner/left joins keyed off
        base fields: per base row, the record path's sequential joins
        enumerate the cartesian product of each join's match list with
        the LAST join varying fastest — suffix-stride indexing
        reproduces that order exactly. Returns (exp_left, [exp_right_k],
        total); left-join misses hold -1. None for mixed key dtypes."""
        R = len(rows)
        slots, los, rsorted, raw_counts = [], [], [], []
        for j, rt in zip(joins, rights):
            rstore = rt.store
            lcol = (
                store.pk_col if j.left_field == pk_name
                else store.columns.get(j.left_field)
            )
            rpk = rt.schema.primary_key.name
            rcol = (
                rstore.pk_col if j.right_field == rpk
                else rstore.columns.get(j.right_field)
            )
            if lcol is None or rcol is None:
                return None
            lv, lnl = self._join_sortable(lcol, rows)
            if lv is None:
                return None
            rrows = np.flatnonzero(rstore.valid_view())
            rv, rnl = self._join_sortable(rcol, rrows)
            if rv is None:
                return None
            if lv.dtype.kind != rv.dtype.kind:
                return None
            rgood = ~rnl
            rr2, rv2 = rrows[rgood], rv[rgood]
            order_r = np.argsort(rv2, kind="stable")
            rv_s, rr_s = rv2[order_r], rr2[order_r]
            lo = np.searchsorted(rv_s, lv, side="left")
            hi = np.searchsorted(rv_s, lv, side="right")
            cnt = (hi - lo).astype(np.int64)
            cnt[lnl] = 0
            slots.append(cnt if j.kind == "inner" else np.maximum(cnt, 1))
            los.append(lo)
            rsorted.append(rr_s)
            raw_counts.append(cnt)
        P = slots[0].copy()
        for s in slots[1:]:
            P = P * s
        total = int(P.sum())
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, [z for _ in joins], 0
        base_idx = np.repeat(np.arange(R), P)
        w = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(P) - P, P
        )
        exp_left = rows[base_idx]
        exp_rights: list = []
        suf = np.ones(R, np.int64)
        for k in range(len(joins) - 1, -1, -1):
            idx = (w // suf[base_idx]) % slots[k][base_idx]
            pos = los[k][base_idx] + idx
            if len(rsorted[k]):
                er = rsorted[k][np.minimum(pos, len(rsorted[k]) - 1)]
            else:
                er = np.zeros(total, np.int64)
            if joins[k].kind == "left":
                er = np.where(raw_counts[k][base_idx] > 0, er, -1)
            exp_rights.append(er)
            suf = suf * slots[k]
        exp_rights.reverse()
        return exp_left, exp_rights, total

    def _multi_field(
        self, store, joins, rights, pk_name, exp_left, rclips, runms,
        field,
    ):
        """_pair_field generalized over N joins (exp_left never holds
        sentinels: right joins are single-join only)."""
        mc = self._multi_col(store, joins, rights, pk_name, field)
        if mc is None:
            return None
        col, side = mc
        if side < 0:
            owner_high, rows_, unm = store.high, exp_left, None
        else:
            owner_high, rows_, unm = (
                rights[side].store.high, rclips[side], runms[side],
            )
        return (col,) + self._side_arrays(col, owner_high, rows_, unm)

    def _join_rows_multi(
        self, space, table, store, rows, spec, order, pk_name,
        cache_key, table_name, post_cond=None,
    ):
        """_join_rows for 2+ inner/left joins: mixed-radix expansion,
        lexsort by order fields resolved across all tables (base pk
        tie-break — it survives every setdefault merge), materialize +
        merge only the page in the record path's reordered join
        sequence."""
        plan = self._multi_plan(space, table, spec)
        if plan is None:
            return None
        joins, rights = plan
        for f, _ in order:
            if f != pk_name and (
                self._multi_col(store, joins, rights, pk_name, f) is None
            ):
                return None
        if self._cursor_precheck(spec, order) is None:
            return None
        exp = self._expand_multi(store, rows, joins, rights, pk_name)
        if exp is None:
            return None
        exp_left, exp_rights, total = exp
        if post_cond is not None and total:
            pm = self._multi_cond_mask(
                post_cond, store, joins, rights, pk_name, exp_left,
                exp_rights, table.schema.name,
            )
            if pm is None:
                return None
            exp_left = exp_left[pm]
            exp_rights = [er[pm] for er in exp_rights]
            total = int(pm.sum())
        levels = None
        if total:
            rclips = [np.maximum(er, 0) for er in exp_rights]
            runms = []
            for er in exp_rights:
                u = er < 0
                runms.append(u if u.any() else None)
            bk = self._base_pk_key(store, exp_left, total)
            if bk is None:
                return None
            keys, pk_vals, pk_nulls = bk

            def resolve(f):
                r = self._multi_field(
                    store, joins, rights, pk_name, exp_left, rclips,
                    runms, f,
                )
                return None if r is None else (r[3], r[4])

            kl = self._order_keys_levels(
                order, pk_name, pk_vals, pk_nulls, keys, resolve,
            )
            if kl is None:
                return None
            keys, levels = kl
            perm = np.lexsort(keys)
            exp_left = exp_left[perm]
            exp_rights = [er[perm] for er in exp_rights]
        sl = self._pair_page_slice(spec, order, levels, total)
        if sl is None:
            return None
        start, stop, has_more = sl
        pl = exp_left[start:stop]
        prs = [er[start:stop] for er in exp_rights]
        fields = self._page_fields(spec, order, pk_name)
        page = store.read_rows(pl, fields)
        if fields is None:
            for rec in page:
                rec.pop("_system_ingest_ts_ms", None)
        for j, rt, pr in zip(joins, rights, prs):
            rstore = rt.store
            for i, rr_ in enumerate(pr.tolist()):
                if rr_ < 0:
                    continue
                rrec = rstore.read_row(int(rr_))
                rrec.pop("_system_ingest_ts_ms", None)
                rec = page[i]
                for k, v in rrec.items():
                    rec.setdefault(k, v)
                    rec[f"{j.table}.{k}"] = v
        return self._finish(
            space, table_name, spec, cache_key, page, order, pk_name,
            total, has_more, start,
        )

    def _aggregate_multi(self, space, table, store, rows, spec,
                         post_cond=None):
        """_aggregate_pairs for 2+ inner/left joins: group/aggregate
        directly over the mixed-radix expansion."""
        plan = self._multi_plan(space, table, spec)
        if plan is None:
            return None
        joins, rights = plan
        aggs = spec.aggregates or [Agg.count()]
        pk_name = table.schema.primary_key.name
        for g in spec.group_by:
            if self._multi_col(store, joins, rights, pk_name, g) is None:
                return None
        for a in aggs:
            if not a.field:
                continue
            mc = self._multi_col(store, joins, rights, pk_name, a.field)
            if mc is None or (mc[0].np_type is None and a.op != "count"):
                return None
        exp = self._expand_multi(store, rows, joins, rights, pk_name)
        if exp is None:
            return None
        exp_left, exp_rights, total = exp
        if post_cond is not None and total:
            pm = self._multi_cond_mask(
                post_cond, store, joins, rights, pk_name, exp_left,
                exp_rights, table.schema.name,
            )
            if pm is None:
                return None
            exp_left = exp_left[pm]
            exp_rights = [er[pm] for er in exp_rights]
            total = int(pm.sum())
        rclips = [np.maximum(er, 0) for er in exp_rights]
        runms = []
        for er in exp_rights:
            u = er < 0
            runms.append(u if u.any() else None)

        gfields = []
        for g in spec.group_by:
            r = self._multi_field(
                store, joins, rights, pk_name, exp_left, rclips, runms, g,
            )
            if r is None:
                return None
            gfields.append((g,) + r)
        aarrs = {}
        for a in aggs:
            if not a.field:
                continue
            r = self._multi_field(
                store, joins, rights, pk_name, exp_left, rclips, runms,
                a.field,
            )
            if r is None:
                return None
            col, _, _, vals, nulls = r
            if col.np_type is None:
                nulls = np.fromiter(
                    (x is None for x in vals.tolist()), np.bool_,
                    count=total,
                )
            aarrs[a.field] = (vals, nulls, col.np_type is np.float64)

        if total == 0:
            return self._agg_tail([], spec)
        if gfields:
            codes = self._factorize_arrays(
                [(vals, nulls) for _, _, _, _, vals, nulls in gfields],
                total,
            )
            codes, rep_idx, G = self._encounter_codes(codes, total)
            out = []
            for ri in rep_idx:
                rec = {}
                for g, col, rows_, unm, _, _ in gfields:
                    if unm is not None and unm[ri]:
                        rec[g] = None
                    else:
                        rec[g] = col.get(int(rows_[ri]))
                out.append(rec)
        else:
            codes = np.zeros(total, np.int64)
            out = [{}]
            G = 1
        if not self._reduce_aggs(aggs, aarrs, codes, G, out):
            return None
        return self._agg_tail(out, spec)

    def _aggregate_pairs(self, space, table, store, rows, spec,
                         post_cond=None):
        """Vectorized _aggregate over ONE equality join (inner, left, or
        right): expand (left, right) rowid pairs, resolve group/aggregate
        fields against the correct side, then run the shared
        factorize+reduce machinery — a count-per-group over 500k join
        pairs must not merge 500k record dicts first. Returns None for
        shapes the record path must handle (unresolvable fields, object
        aggregate columns, mixed join-key dtypes, pk fields). 2+ joins
        route to the mixed-radix multi path."""
        if len(spec.joins) > 1:
            return self._aggregate_multi(
                space, table, store, rows, spec, post_cond,
            )
        j = spec.joins[0]
        aggs = spec.aggregates or [Agg.count()]
        # resolvability pre-checks run BEFORE the O(pairs) expansion so
        # ineligible shapes don't pay for a discarded expansion on top
        # of the record path's own join
        rstore = self.db._table(j.table, space).store
        pk_name = table.schema.primary_key.name
        for g in spec.group_by:
            if (
                self._pair_col(store, rstore, j.table, pk_name, g, j.kind)
                is None
            ):
                return None
        for a in aggs:
            if not a.field:
                continue
            pc = self._pair_col(
                store, rstore, j.table, pk_name, a.field, j.kind,
            )
            if pc is None or (pc[0].np_type is None and a.op != "count"):
                return None  # numeric reducers need typed columns
        exp = self._expand_pairs(space, table, store, rows, j)
        if exp is None:
            return None
        right, exp_left, exp_right, total = exp
        rstore = right.store
        if post_cond is not None and total:
            pm = self._pair_cond_mask(
                post_cond, store, rstore, j.table, pk_name, exp_left,
                exp_right, j.kind, table.schema.name,
            )
            if pm is None:
                return None
            exp_left, exp_right = exp_left[pm], exp_right[pm]
            total = int(pm.sum())
        lunm = exp_left < 0
        if not lunm.any():
            lunm = None
        lclip = np.maximum(exp_left, 0)
        runm = exp_right < 0
        if not runm.any():
            runm = None
        rclip = np.maximum(exp_right, 0)

        gfields = []
        for g in spec.group_by:
            r = self._pair_field(
                store, rstore, j.table, pk_name, lclip, lunm, rclip,
                runm, g, j.kind,
            )
            if r is None:
                return None
            gfields.append((g,) + r)
        aarrs = {}
        for a in aggs:
            if not a.field:
                continue
            r = self._pair_field(
                store, rstore, j.table, pk_name, lclip, lunm, rclip,
                runm, a.field, j.kind,
            )
            if r is None:
                return None
            col, _, _, vals, nulls = r
            if col.np_type is None:
                # count-only (pre-checked): null mask from the None
                # sentinels (side-unmatched rows already nulled)
                nulls = np.fromiter(
                    (x is None for x in vals.tolist()), np.bool_,
                    count=total,
                )
            aarrs[a.field] = (vals, nulls, col.np_type is np.float64)

        if total == 0:
            return self._agg_tail([], spec)
        if gfields:
            codes = self._factorize_arrays(
                [(vals, nulls) for _, _, _, _, vals, nulls in gfields],
                total,
            )
            codes, rep_idx, G = self._encounter_codes(codes, total)
            out = []
            for ri in rep_idx:
                rec = {}
                for g, col, rows_, unm, _, _ in gfields:
                    if unm is not None and unm[ri]:
                        rec[g] = None
                    else:
                        rec[g] = col.get(int(rows_[ri]))
                out.append(rec)
        else:
            codes = np.zeros(total, np.int64)
            out = [{}]
            G = 1
        if not self._reduce_aggs(aggs, aarrs, codes, G, out):
            return None
        return self._agg_tail(out, spec)


class _NegKey:
    """Inverts comparison for descending sort of heterogeneous keys."""

    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k

    def __lt__(self, other):
        return other.k < self.k

    def __eq__(self, other):
        return self.k == other.k

    def __le__(self, other):
        return other.k <= self.k

    def __gt__(self, other):
        return other.k > self.k

    def __ge__(self, other):
        return other.k >= self.k
