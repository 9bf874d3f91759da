"""Schema migration.

Reference: core/migration_manager.dart (5,567 LoC) — auto schema-change
detection at open with field/table rename similarity scoring
(compute_tasks.dart:179-595 name LCS + type/constraint weights), record
transforms, resumable task queue. Here migrations are synchronous (the
columnar store transforms in vectorized passes), with the same detection
semantics: explicit rename ops from the SchemaBuilder, plus automatic
rename inference when an updated schema drops one field and adds another of
compatible type with a similar name.
"""

from __future__ import annotations

import difflib

from ..models.schema import DataType, TableSchema

# numeric widening / safe casts
_SAFE_CASTS = {
    (DataType.integer, DataType.bigInt),
    (DataType.bigInt, DataType.integer),
    (DataType.integer, DataType.double),
    (DataType.bigInt, DataType.double),
    (DataType.integer, DataType.text),
    (DataType.bigInt, DataType.text),
    (DataType.double, DataType.text),
    (DataType.boolean, DataType.text),
    (DataType.text, DataType.json),
}

RENAME_SIMILARITY = 0.55  # name-similarity floor for auto rename detection
PROGRESS_CHUNK = 50_000  # rows between progress ticks in backfill/cast loops


def _name_similarity(a: str, b: str) -> float:
    return difflib.SequenceMatcher(None, a.lower(), b.lower()).ratio()


def detect_renames(old: TableSchema, new: TableSchema) -> dict[str, str]:
    """Map old-field-name -> new-field-name for pairs that look like renames
    (same/compatible type + similar name), mirroring the reference's
    similarity scoring (compute_tasks.dart:179-595)."""
    old_fields = {f.name: f for f in old.fields}
    new_fields = {f.name: f for f in new.fields}
    removed = [f for n, f in old_fields.items() if n not in new_fields]
    added = [f for n, f in new_fields.items() if n not in old_fields]
    renames: dict[str, str] = {}
    used = set()
    for of in removed:
        best, best_score = None, 0.0
        for nf in added:
            if nf.name in used:
                continue
            if nf.type != of.type and (of.type, nf.type) not in _SAFE_CASTS:
                continue
            score = _name_similarity(of.name, nf.name)
            # same type bumps confidence (reference type/constraint weights)
            if nf.type == of.type:
                score += 0.15
            if score > best_score:
                best, best_score = nf, score
        if best is not None and best_score >= RENAME_SIMILARITY:
            renames[of.name] = best.name
            used.add(best.name)
    return renames


def cast_value(v, src: DataType, dst: DataType):
    if v is None or src == dst:
        return v
    try:
        if dst in (DataType.integer, DataType.bigInt):
            return int(float(v)) if not isinstance(v, bool) else None
        if dst == DataType.double:
            return float(v)
        if dst == DataType.text:
            return str(v)
        if dst == DataType.boolean:
            return str(v).lower() in ("true", "1", "yes")
        if dst == DataType.json:
            return v
    except (TypeError, ValueError):
        return None
    return None


def _precheck_unique(table, new_schema: TableSchema, renames: dict[str, str]):
    """Evaluate the new schema's unique constraints against the CURRENT
    data (renames + casts applied virtually) and raise before anything
    mutates. The reference fails such migrations; last-write-wins unique
    map rebuilds left the constraint unenforced for existing rows."""
    from .table import ValidationError

    store = table.store
    old_fields = {f.name: f for f in table.schema.fields}
    specs = [(f, (f,)) for f in new_schema.unique_fields()]
    specs += [
        (idx.index_name, tuple(idx.fields))
        for idx in new_schema.btree_indexes()
        if idx.unique
    ]
    if not specs or len(store) == 0:
        return
    rev = {v: k for k, v in renames.items()}
    new_map = new_schema.field_map
    seen: dict[str, dict] = {name: {} for name, _ in specs}
    for pk in store.pks():
        row = store.rowid(pk)
        for name, fields in specs:
            key = []
            for fn in fields:
                src = rev.get(fn, fn)
                col = store.columns.get(src)
                f_new = new_map.get(fn)
                if col is None:
                    v = f_new.default_value if f_new is not None else None
                else:
                    v = col.get(row)
                    f_old = old_fields.get(src)
                    if (
                        v is not None
                        and f_old is not None
                        and f_new is not None
                        and f_old.type != f_new.type
                    ):
                        v = cast_value(v, f_old.type, f_new.type)
                key.append(v)
            if any(v is None for v in key):
                continue
            tkey = tuple(key)
            holder = seen[name].get(tkey)
            if holder is not None and holder != pk:
                raise ValidationError(
                    f"unique constraint {name!r} violated by existing data: "
                    f"value {tkey!r} held by pks {holder!r} and {pk!r}"
                )
            seen[name][tkey] = pk


def migrate_table(
    table,
    new_schema: TableSchema,
    renames: dict[str, str] | None = None,
    on_progress=None,
):
    """Transform a Table in place to `new_schema`. Returns a report dict.
    `on_progress(pct, phase)` fires at phase boundaries and every
    PROGRESS_CHUNK rows inside the heavy backfill/cast loops (persisted by
    the engine's migration task records)."""
    progress = on_progress or (lambda pct, phase: None)
    old_schema = table.schema
    if old_schema.primary_key.to_json() != new_schema.primary_key.to_json():
        from .table import ValidationError

        raise ValidationError(
            "primary key configuration cannot change in a migration"
        )
    renames = dict(renames or {})
    renames.update(
        {k: v for k, v in detect_renames(old_schema, new_schema).items() if k not in renames}
    )

    old_fields = {f.name: f for f in old_schema.fields}
    new_fields = {f.name: f for f in new_schema.fields}
    report = {"renamed": renames, "added": [], "removed": [], "retyped": []}

    # 0. pre-check unique constraints over existing data BEFORE any store
    # mutation — a new unique constraint over duplicate values must fail
    # the migration atomically, not silently rebuild last-write-wins
    progress(5, "precheck")
    _precheck_unique(table, new_schema, renames)

    store = table.store
    progress(15, "renames")
    # 1. renames: move column object under the new name
    for old_name, new_name in renames.items():
        col = store.columns.pop(old_name, None)
        if col is not None:
            store.columns[new_name] = col

    # 2. removed fields
    for name in old_fields:
        if name not in new_fields and name not in renames:
            store.drop_column(name)
            report["removed"].append(name)

    # 3. added fields (backfill defaults)
    progress(25, "backfill")
    n_fields = max(1, len(new_fields))
    for fi, (name, f) in enumerate(new_fields.items()):
        src = next((o for o, n in renames.items() if n == name), None)
        if name not in store.columns:
            store.ensure_column(name, f.type)
            report["added"].append(name)
            if f.default_value is not None:
                col = store.columns[name]
                for r in range(store.high):
                    if store.valid[r]:
                        col.set(r, f.default_value)
                    if r % PROGRESS_CHUNK == 0:
                        progress(
                            25 + int(45 * (fi + r / max(1, store.high)) / n_fields),
                            f"backfill:{name}",
                        )
        else:
            old_f = old_fields.get(src or name)
            if old_f is not None and old_f.type != f.type:
                # retype: cast every value
                old_col = store.columns[name]
                store.columns.pop(name)
                store.ensure_column(name, f.type)
                new_col = store.columns[name]
                for r in range(store.high):
                    if store.valid[r]:
                        new_col.set(r, cast_value(old_col.get(r), old_f.type, f.type))
                    if r % PROGRESS_CHUNK == 0:
                        progress(
                            25 + int(45 * (fi + r / max(1, store.high)) / n_fields),
                            f"cast:{name}",
                        )
                report["retyped"].append(name)

    # 4. swap schema + rebuild derived structures
    progress(70, "indexes")
    table.schema = new_schema
    table.unique_maps = {f: {} for f in new_schema.unique_fields()}
    for idx in new_schema.btree_indexes():
        if idx.unique:
            table.unique_maps[idx.index_name] = {}
    table._unique_field_names = tuple(new_schema.unique_fields())
    table._unique_index_specs = tuple(
        (idx.index_name, idx.fields) for idx in new_schema.btree_indexes() if idx.unique
    )
    table._known_fields = frozenset(f.name for f in new_schema.fields) | {
        new_schema.primary_key.name
    }
    from .table import SortedIndex, _make_vector_index

    table.sorted_indexes = {
        idx.index_name: SortedIndex(idx.fields) for idx in new_schema.btree_indexes()
    }
    # vector indexes: keep compatible ones, build new ones
    new_vi = {}
    for idx in new_schema.vector_indexes():
        field = idx.fields[0]
        fs = new_schema.field_map[field]
        old_idx = table.vector_indexes.get(field)
        if old_idx is not None and old_idx.dims == fs.vector_config.dimensions:
            new_vi[field] = old_idx
        else:
            new_vi[field] = _make_vector_index(
                fs.vector_config.dimensions, fs.vector_config.precision.value, idx,
                getattr(table, "mesh", None), device=table.device,
            )
            # re-ingest vectors from the column store
            col = store.columns.get(field)
            if col is not None:
                pend = {}
                for pk in store.pks():
                    row = store.rowid(pk)
                    v = col.get(row)
                    if v is not None:
                        import numpy as np

                        pend[pk] = np.asarray(v, np.float32)
                table._vec_pending[field] = pend
    table.vector_indexes = new_vi
    for f in new_vi:
        table._vec_pending.setdefault(f, {})

    # refresh the device-filterable field set AND backfill device columns
    # for fields whose column doesn't exist yet (renamed/added/retyped) —
    # enabling the device path without backfilling would silently exclude
    # every pre-migration row from hybrid search (NaN/null never matches)
    if table.vector_indexes:
        from .table import filterable_fields

        table.filter_fields = filterable_fields(new_schema)
        for vf, vi in table.vector_indexes.items():
            have = vi.corpus.filter_columns.names()
            missing = [f for f in table.filter_fields if f not in have]
            if not missing:
                continue
            pend = table._filter_pending.setdefault(vf, {})
            for pk in store.pks():
                row = store.rowid(pk)
                vals = {f: store.columns[f].get(row) for f in missing if f in store.columns}
                if vals:
                    pend.setdefault(pk, {}).update(vals)

    # rebuild unique maps from data
    progress(90, "unique")
    for pk in store.pks():
        rec = store.get(pk)
        table._unique_apply(pk, rec, None)
    store.generation += 1
    return report
