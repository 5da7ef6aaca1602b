"""Columnar trace storage — struct-of-arrays over numpy.

The per-event dataclass list is the right *construction* format for small
traces, but the wrong *aggregation* format: every Table II rollup,
comm-matrix assembly, and detector scan walks Python objects attribute by
attribute.  INAM-style cross-layer profilers solve this with columnar
stores; we do the same.  `TraceStore` holds one numpy array per numeric
field and interned categorical codes for the string fields (kind, link
class, semantic, op_name, ...), so aggregations become `np.bincount` over
composite codes instead of Python loops — 1-2 orders of magnitude faster
at the 100k-event scale the paper's experiments produce.

The irregular per-row payloads are *deduplicated*: replica groups, permute
pairs, and mesh-axes tuples repeat heavily (unrolled loops stamp the same
`replica_groups=[G,S]<=[dims]` attr thousands of times), so the store keeps
one table of unique values per payload plus an int32 code per row.  This is
what makes whole-pipeline batching possible: the cost model resolves
topology once per unique group table (`costmodel.annotate_store`) and
attribution runs its regex cascade once per unique op_name
(`attribution.attribute_store`), both broadcasting results through codes.

`CollectiveEvent` remains the row view: `store.row(i)` / `store.rows()`
materialize dataclass rows, and `Trace` keeps exposing `.events` so every
existing consumer (detectors, renderers, diffing) is unaffected.
"""
from __future__ import annotations

import fnmatch
import json
import os
import sys
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import CollectiveEvent

SCHEMA_VERSION = 2

# numeric columns: (name, dtype)
_NUM_COLS: Tuple[Tuple[str, object], ...] = (
    ("operand_bytes", np.int64),
    ("result_bytes", np.int64),
    ("multiplicity", np.int64),
    ("group_size", np.int64),
    ("num_groups", np.int64),
    ("channel_id", np.int64),          # -1 encodes None
    ("async_start", np.bool_),
    ("wire_bytes_per_device", np.float64),
    ("est_time_s", np.float64),
)

# interned string columns
_CAT_COLS: Tuple[str, ...] = (
    "kind", "link_class", "semantic", "protocol", "jax_prim", "scope",
    "dtype", "computation", "op_name",
)


def _grow(buf: Optional[np.ndarray], cur: np.ndarray,
          add: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Append `add` after logical column `cur`, reusing the amortized
    capacity buffer `buf` while `cur` is still a live view of it.

    Returns `(buf, view)` with `view = buf[:len(cur) + len(add)]`.  A
    column that was replaced wholesale since the last append (e.g.
    `annotate_store` swapping in computed `est_time_s`) no longer aliases
    `buf`, so a fresh buffer is seeded from the current values; doubling
    growth keeps N appends at O(total rows) amortized copies.
    """
    n, k = len(cur), len(add)
    if buf is None or cur.base is not buf or len(buf) < n + k \
            or buf.dtype != cur.dtype:
        cap = 1 << max(n + k, 4).bit_length()
        nbuf = np.empty(cap, dtype=cur.dtype)
        nbuf[:n] = cur
        buf = nbuf
    buf[n:n + k] = add
    return buf, buf[:n + k]


class Categorical:
    """An interned string column: int32 codes into a first-seen vocab."""

    __slots__ = ("codes", "vocab", "_index", "_buf")

    def __init__(self, codes: np.ndarray, vocab: List[str]):
        self.codes = np.asarray(codes, dtype=np.int32)
        self.vocab = list(vocab)
        self._index: Optional[Dict[str, int]] = None
        self._buf: Optional[np.ndarray] = None

    @classmethod
    def from_values(cls, values: Sequence[str]) -> "Categorical":
        index: Dict[str, int] = {}
        codes = np.empty(len(values), dtype=np.int32)
        for i, v in enumerate(values):
            code = index.get(v)
            if code is None:
                code = index[v] = len(index)
            codes[i] = code
        return cls(codes, list(index))

    @classmethod
    def constant(cls, n: int, value: str = "") -> "Categorical":
        """A column of `n` identical values (the un-annotated placeholder)."""
        if n == 0:
            return cls(np.empty(0, dtype=np.int32), [])
        return cls(np.zeros(n, dtype=np.int32), [value])

    def __len__(self) -> int:
        return len(self.codes)

    def value(self, i: int) -> str:
        return self.vocab[self.codes[i]]

    def values(self) -> List[str]:
        return [self.vocab[c] for c in self.codes]

    def mask_of(self, *labels: str) -> np.ndarray:
        """Boolean mask of rows whose value is one of `labels`."""
        want = {i for i, v in enumerate(self.vocab) if v in labels}
        if not want:
            return np.zeros(len(self.codes), dtype=bool)
        return np.isin(self.codes, np.fromiter(want, dtype=np.int32))

    def mask_prefix(self, prefixes: Tuple[str, ...]) -> np.ndarray:
        want = {i for i, v in enumerate(self.vocab) if v.startswith(prefixes)}
        if not want:
            return np.zeros(len(self.codes), dtype=bool)
        return np.isin(self.codes, np.fromiter(want, dtype=np.int32))

    def mask_glob(self, pattern: str) -> np.ndarray:
        """Boolean mask of rows whose value matches a shell-style glob.

        The match runs once per *vocab entry*, so filtering a million-row
        column by `op=transformer*attention*` costs O(vocab) string work
        plus one vectorized `isin` — the query layer's row filter.
        A pattern without wildcards degenerates to an exact match.
        """
        want = {i for i, v in enumerate(self.vocab)
                if fnmatch.fnmatchcase(v, pattern)}
        if not want:
            return np.zeros(len(self.codes), dtype=bool)
        return np.isin(self.codes, np.fromiter(want, dtype=np.int32))

    def remap(self, fn) -> "Categorical":
        """New categorical applying `fn` once per *vocab entry* (not per row),
        merging entries that map to the same output string."""
        return self.remap_table([fn(v) for v in self.vocab])

    def remap_table(self, table: Sequence[str]) -> "Categorical":
        """New categorical with vocab entry i replaced by `table[i]`
        (entries mapping to the same output are merged)."""
        remap, merged = build_remap(table)
        codes = remap[self.codes] if len(table) else \
            np.empty(0, dtype=np.int32)
        return Categorical(codes, merged)

    def extend(self, other: "Categorical") -> None:
        """In-place append of `other`'s rows, interning its vocab
        first-seen into ours — the streaming equivalent of the
        `build_remap` union in `TraceStore.merge`, with the vocab index
        cached across calls and codes kept in an amortized buffer."""
        index = self._index
        if index is None or len(index) != len(self.vocab):
            index = self._index = {v: i for i, v in enumerate(self.vocab)}
        remap = np.empty(len(other.vocab), dtype=np.int32)
        for i, v in enumerate(other.vocab):
            j = index.get(v)
            if j is None:
                j = index[v] = len(self.vocab)
                self.vocab.append(v)
            remap[i] = j
        add = remap[other.codes] if len(other.codes) \
            else np.empty(0, dtype=np.int32)
        self._buf, self.codes = _grow(self._buf, self.codes, add)


class LazyNames:
    """List-like view of the packed per-row name member, decoded on demand.

    The npz layout stores row names as one newline-joined utf-8 blob
    (`{prefix}names`, a uint8 column) so an mmap-mode open does not pay
    O(rows) Python-string materialization up front.  Rollups, detectors,
    and diff never touch names; only `row()`/report rendering do — this
    decodes once on first access and behaves like the list afterwards.
    """

    __slots__ = ("_packed", "_n", "_list")

    def __init__(self, packed: np.ndarray, n: int):
        self._packed = packed
        self._n = n
        self._list: Optional[List[str]] = None

    def _materialize(self) -> List[str]:
        if self._list is None:
            if self._n == 0:
                self._list = []
            else:
                # n==1 with an empty name packs to b"", which still
                # decodes correctly: "".split("\n") == [""]
                self._list = bytes(self._packed).decode("utf-8").split("\n")
                if len(self._list) != self._n:
                    raise ValueError(
                        f"packed names decode to {len(self._list)} rows, "
                        f"expected {self._n}")
        return self._list

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (list, LazyNames)):
            return self._materialize() == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"LazyNames(n={self._n})"


def pack_names(names: Sequence[str]) -> np.ndarray:
    """Pack row names into the uint8 npz column `LazyNames` decodes."""
    blob = "\n".join(names).encode("utf-8")
    return np.frombuffer(blob, dtype=np.uint8)


def _intern(index: Dict, key, table: List, value_fn) -> int:
    code = index.get(key)
    if code is None:
        code = index[key] = len(table)
        table.append(value_fn())
    return code


def build_remap(entries: Sequence) -> Tuple[np.ndarray, List]:
    """Intern `entries` in first-seen order: returns (int32 map of
    len(entries), merged vocab) with `vocab[map[i]] == entries[i]`.

    The shared core of every vocab-level broadcast (Categorical.remap,
    the batched cost model's link classes, attribution's semantic labels).
    """
    index: Dict = {}
    vocab: List = []
    table = np.empty(max(len(entries), 1), dtype=np.int32)
    for i, v in enumerate(entries):
        j = index.get(v)
        if j is None:
            j = index[v] = len(vocab)
            vocab.append(v)
        table[i] = j
    return table, vocab


class TraceStore:
    """Struct-of-arrays event store backing a `Trace`.

    Numeric fields are numpy columns; string fields are `Categorical`
    (codes + vocab); the irregular per-row payloads are deduplicated into
    unique-value tables addressed by int32 codes:

      * `group_tables[group_code[i]]`  — replica groups of row i,
      * `stp_tables[stp_code[i]]`      — permute pairs (code -1 = none),
      * `axes_tables[axes_code[i]]`    — mesh-axes tuple of row i.

    The per-row list views (`replica_groups`, `source_target_pairs`,
    `axes`, `op_names`) are materialized lazily for compatibility.
    """

    def __init__(self, n: int, num: Dict[str, np.ndarray],
                 cat: Dict[str, Categorical],
                 names: List[str],
                 group_tables: List[List[List[int]]], group_code: np.ndarray,
                 stp_tables: List[List[Tuple[int, int]]], stp_code: np.ndarray,
                 axes_tables: List[Tuple[str, ...]], axes_code: np.ndarray):
        self.n = n
        for col, _dt in _NUM_COLS:
            setattr(self, col, num[col])
        for col in _CAT_COLS:
            setattr(self, col, cat[col])
        self.names = names
        self.group_tables = group_tables
        self.group_code = np.asarray(group_code, dtype=np.int32)
        self.stp_tables = stp_tables
        self.stp_code = np.asarray(stp_code, dtype=np.int32)
        self.axes_tables = axes_tables
        self.axes_code = np.asarray(axes_code, dtype=np.int32)
        self._edges: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._gexp: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._rg_rows: Optional[List[List[List[int]]]] = None
        self._stp_rows: Optional[List] = None
        self._axes_rows: Optional[List[Tuple[str, ...]]] = None
        # append-mode state: amortized column buffers + cached payload
        # table indices (value-keyed), see `append`
        self._bufs: Dict[str, np.ndarray] = {}
        self._tbl_idx: Dict[str, Dict] = {}

    # ---- construction ------------------------------------------------------

    @classmethod
    def from_events(cls, events: Iterable[CollectiveEvent]) -> "TraceStore":
        evs = list(events)
        n = len(evs)
        num = {col: np.fromiter(
            ((-1 if e.channel_id is None else e.channel_id) if col == "channel_id"
             else getattr(e, col) for e in evs),
            dtype=dt, count=n) for col, dt in _NUM_COLS}
        cat = {col: Categorical.from_values([getattr(e, col) for e in evs])
               for col in _CAT_COLS}

        # intern the irregular payloads (id() front-cache: parsers and synth
        # reuse the same group-list objects across many events)
        g_idx: Dict = {}
        g_ids: Dict[int, int] = {}
        group_tables: List[List[List[int]]] = []
        group_code = np.empty(n, dtype=np.int32)
        s_idx: Dict = {}
        stp_tables: List[List[Tuple[int, int]]] = []
        stp_code = np.empty(n, dtype=np.int32)
        a_idx: Dict = {}
        axes_tables: List[Tuple[str, ...]] = []
        axes_code = np.empty(n, dtype=np.int32)
        for i, e in enumerate(evs):
            gc = g_ids.get(id(e.replica_groups))
            if gc is None:
                key = tuple(tuple(g) for g in e.replica_groups)
                gc = _intern(g_idx, key, group_tables, lambda: e.replica_groups)
                g_ids[id(e.replica_groups)] = gc
            group_code[i] = gc
            if e.source_target_pairs:
                key = tuple(e.source_target_pairs)
                stp_code[i] = _intern(s_idx, key, stp_tables,
                                      lambda: e.source_target_pairs)
            else:
                stp_code[i] = -1
            axes_code[i] = _intern(a_idx, tuple(e.axes), axes_tables,
                                   lambda: tuple(e.axes))
        return cls(n, num, cat, names=[e.name for e in evs],
                   group_tables=group_tables, group_code=group_code,
                   stp_tables=stp_tables, stp_code=stp_code,
                   axes_tables=axes_tables, axes_code=axes_code)

    @classmethod
    def empty(cls) -> "TraceStore":
        """A zero-row store (identity element of `merge`)."""
        return cls(
            0, {col: np.empty(0, dtype=dt) for col, dt in _NUM_COLS},
            {col: Categorical(np.empty(0, dtype=np.int32), [])
             for col in _CAT_COLS},
            names=[], group_tables=[],
            group_code=np.empty(0, dtype=np.int32),
            stp_tables=[], stp_code=np.empty(0, dtype=np.int32),
            axes_tables=[], axes_code=np.empty(0, dtype=np.int32))

    @classmethod
    def merge(cls, stores: Sequence["TraceStore"]) -> "TraceStore":
        """Concatenate shard stores into one (sharded single-module ingest).

        Rows keep shard order; every interned vocabulary (categorical
        columns, replica-group / permute / axes tables) is re-interned
        across shards in first-seen order via `build_remap`, and the
        shard codes are remapped through the resulting tables.  Because a
        serial parse also interns in first-seen row order (and keys the
        payload tables by *value*), merging the chunk parses of
        `split_hlo_module` is byte-identical to parsing the whole module
        serially — pinned by tests/test_shard.py and the `--shard-only`
        bench gate.
        """
        stores = list(stores)
        if not stores:
            return cls.empty()
        if len(stores) == 1:
            return stores[0]
        n = sum(s.n for s in stores)
        num = {col: np.concatenate([getattr(s, col) for s in stores])
               for col, _dt in _NUM_COLS}

        cat: Dict[str, Categorical] = {}
        for col in _CAT_COLS:
            entries: List[str] = []
            for s in stores:
                entries.extend(getattr(s, col).vocab)
            remap, union = build_remap(entries)
            parts = []
            off = 0
            for s in stores:
                c = getattr(s, col)
                k = len(c.vocab)
                parts.append(remap[off:off + k][c.codes] if len(c.codes)
                             else np.empty(0, dtype=np.int32))
                off += k
            cat[col] = Categorical(np.concatenate(parts), union)

        def intern_tables(tables_of, key_fn):
            index: Dict = {}
            tables: List = []
            maps: List[np.ndarray] = []
            for s in stores:
                ts = tables_of(s)
                m = np.empty(len(ts), dtype=np.int32)
                for i, t in enumerate(ts):
                    key = key_fn(t)
                    j = index.get(key)
                    if j is None:
                        j = index[key] = len(tables)
                        tables.append(t)
                    m[i] = j
                maps.append(m)
            return tables, maps

        group_tables, g_maps = intern_tables(
            lambda s: s.group_tables,
            lambda t: tuple(tuple(int(x) for x in g) for g in t))
        group_code = np.concatenate(
            [m[s.group_code] if len(s.group_code)
             else np.empty(0, dtype=np.int32)
             for s, m in zip(stores, g_maps)])
        stp_tables, s_maps = intern_tables(
            lambda s: s.stp_tables,
            lambda t: tuple((int(a), int(b)) for a, b in t))
        stp_parts = []
        for s, m in zip(stores, s_maps):
            c = s.stp_code
            if not len(c):
                stp_parts.append(np.empty(0, dtype=np.int32))
            elif len(m):
                stp_parts.append(np.where(
                    c >= 0, m[np.clip(c, 0, None)], np.int32(-1)))
            else:
                stp_parts.append(c)
        stp_code = np.concatenate(stp_parts)
        axes_tables, a_maps = intern_tables(
            lambda s: s.axes_tables, lambda t: tuple(t))
        axes_code = np.concatenate(
            [m[s.axes_code] if len(s.axes_code)
             else np.empty(0, dtype=np.int32)
             for s, m in zip(stores, a_maps)])

        names: List[str] = []
        for s in stores:
            names.extend(s.names)
        return cls(n, num, cat, names=names,
                   group_tables=group_tables, group_code=group_code,
                   stp_tables=stp_tables, stp_code=stp_code,
                   axes_tables=axes_tables, axes_code=axes_code)

    @classmethod
    def merge_tree(cls, stores: Sequence["TraceStore"], arity: int = 8,
                   workers: int = 1) -> "TraceStore":
        """`merge(stores)` as a k-ary reduction tree: O(log n) depth.

        A serial fold over n per-host stores copies the accumulated rows
        at every step — O(n²·m) row traffic for a fleet of n stores of m
        rows; even the single flat `merge` call walks every vocab in one
        process.  The tree reduces `arity` stores at a time, level by
        level, so total row traffic is O(n·m·log_k n) and each level's
        chunk merges are independent — with `workers > 1` they run on a
        process pool (fork preferred: the store list is inherited
        copy-on-write and only (lo, hi) spans ride the pipe).

        Result is `TraceStore.identical` to `merge(stores)` for *any*
        arity and worker count: `merge` interns every vocabulary in
        first-seen order over the concatenation of its inputs' vocabs,
        and first-seen interning is associative over concatenation — so
        any ordered bracketing yields the same vocab order, codes, and
        payload tables (pinned by tests/test_warehouse.py).
        `workers <= 1` reduces in-process.
        """
        if arity < 2:
            raise ValueError(f"merge_tree arity must be >= 2, got {arity}")
        stores = list(stores)
        if not stores:
            return cls.empty()
        while len(stores) > 1:
            chunks = [stores[i:i + arity]
                      for i in range(0, len(stores), arity)]
            merged = None
            if workers and workers > 1 and len(chunks) > 1:
                merged = _pooled_merge_level(chunks, workers)
            if merged is None:
                merged = [cls.merge(c) for c in chunks]
            stores = merged
        return stores[0]

    def append(self, other: "TraceStore") -> "TraceStore":
        """In-place streaming variant of `merge`: extend self with `other`.

        `s = TraceStore.empty()` followed by `s.append(c)` per chunk
        leaves `s` `identical` to `TraceStore.merge(chunks)` — and
        therefore, when the chunks are `split_hlo_module` parses, to the
        batch `parse_hlo_store` of the concatenated input (pinned by
        tests/test_append.py and `bench_overhead --append-only`).
        Interning state (categorical vocab indices, payload-table value
        indices) is cached between calls and every numeric/code column
        lives in a doubling capacity buffer, so N appends cost O(total
        rows) amortized — this is what keeps the watch daemon's rolling
        store fresh without per-poll recomputation.

        Returns `self`.  `other` is unmodified; its payload tables are
        adopted by reference, exactly as `merge` shares them.
        """
        if other is self:
            raise ValueError("cannot append a TraceStore to itself")
        bufs = self._bufs
        for col, _dt in _NUM_COLS:
            bufs[col], view = _grow(bufs.get(col), getattr(self, col),
                                    getattr(other, col))
            setattr(self, col, view)
        for col in _CAT_COLS:
            getattr(self, col).extend(getattr(other, col))

        def extend_tables(name, tables, other_tables, key_fn):
            idx = self._tbl_idx.get(name)
            if idx is None or len(idx) != len(tables):
                idx = self._tbl_idx[name] = {key_fn(t): i
                                             for i, t in enumerate(tables)}
            m = np.empty(len(other_tables), dtype=np.int32)
            for i, t in enumerate(other_tables):
                key = key_fn(t)
                j = idx.get(key)
                if j is None:
                    j = idx[key] = len(tables)
                    tables.append(t)
                m[i] = j
            return m

        g_map = extend_tables(
            "group", self.group_tables, other.group_tables,
            lambda t: tuple(tuple(int(x) for x in g) for g in t))
        add = g_map[other.group_code] if len(other.group_code) \
            else np.empty(0, dtype=np.int32)
        bufs["group_code"], self.group_code = _grow(
            bufs.get("group_code"), self.group_code, add)

        s_map = extend_tables(
            "stp", self.stp_tables, other.stp_tables,
            lambda t: tuple((int(a), int(b)) for a, b in t))
        c = other.stp_code
        if not len(c):
            add = np.empty(0, dtype=np.int32)
        elif len(s_map):
            add = np.where(c >= 0, s_map[np.clip(c, 0, None)], np.int32(-1))
        else:
            add = c
        bufs["stp_code"], self.stp_code = _grow(
            bufs.get("stp_code"), self.stp_code, add)

        a_map = extend_tables("axes", self.axes_tables, other.axes_tables,
                              lambda t: tuple(t))
        add = a_map[other.axes_code] if len(other.axes_code) \
            else np.empty(0, dtype=np.int32)
        bufs["axes_code"], self.axes_code = _grow(
            bufs.get("axes_code"), self.axes_code, add)

        if not isinstance(self.names, list):
            self.names = list(self.names)    # adopt a lazy (mmap) name view
        self.names.extend(other.names)
        self.n += other.n
        self._edges = self._gexp = None
        self._rg_rows = self._stp_rows = self._axes_rows = None
        return self

    def identical(self, other: "TraceStore") -> bool:
        """Field-for-field equality, codes and vocabs included.

        Stricter than row-wise equality: two stores whose rows match but
        whose interned vocab/table *order* differs are not `identical`.
        This is the shard-equivalence pin (merge(shards) vs serial parse).
        """
        if self.n != other.n or self.names != other.names:
            return False
        for col, _dt in _NUM_COLS:
            if not np.array_equal(getattr(self, col), getattr(other, col)):
                return False
        for col in _CAT_COLS:
            a, b = getattr(self, col), getattr(other, col)
            if a.vocab != b.vocab or not np.array_equal(a.codes, b.codes):
                return False
        def norm_groups(tables):
            return [tuple(tuple(int(x) for x in g) for g in t)
                    for t in tables]
        def norm_stp(tables):
            return [tuple((int(a), int(b)) for a, b in t) for t in tables]
        return (norm_groups(self.group_tables) == norm_groups(other.group_tables)
                and np.array_equal(self.group_code, other.group_code)
                and norm_stp(self.stp_tables) == norm_stp(other.stp_tables)
                and np.array_equal(self.stp_code, other.stp_code)
                and [tuple(a) for a in self.axes_tables]
                == [tuple(a) for a in other.axes_tables]
                and np.array_equal(self.axes_code, other.axes_code))

    def annotation_clone(self) -> "TraceStore":
        """A scratch copy sharing this store's row data by reference.

        `costmodel.annotate_store` *rebinds* the annotation columns
        (`link_class`, `protocol`, `wire_bytes_per_device`, `est_time_s`,
        and the axes payload via `set_axes`) — it never writes into the
        existing arrays.  Re-annotating a clone under an alternate
        mesh/hardware therefore leaves this store untouched: that is the
        what-if engine's baseline-never-mutated invariant (pinned by
        tests/test_whatif.py).  The clone must not be appended to or
        edited row-wise — the payload tables and name list are aliased.
        """
        num = {col: getattr(self, col) for col, _dt in _NUM_COLS}
        cat = {col: getattr(self, col) for col in _CAT_COLS}
        return TraceStore(
            self.n, num, cat, names=self.names,
            group_tables=self.group_tables, group_code=self.group_code,
            stp_tables=self.stp_tables, stp_code=self.stp_code,
            axes_tables=self.axes_tables, axes_code=self.axes_code)

    def where(self, mask: np.ndarray) -> "TraceStore":
        """New store holding the rows where `mask` is True.

        Codes are kept as-is against *copies* of the vocab/table
        containers (append/extend mutate those lists in place, so
        sharing them would let a later append to either store corrupt
        the other).  Vocabularies are not compacted: rollups key on
        occurring codes only, so unused entries are invisible to every
        aggregate — and skipping compaction keeps the filter O(rows).
        Works on mmap-backed stores without copying unselected rows'
        strings (the fancy-indexed numeric columns are fresh arrays).
        """
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (self.n,):
            raise ValueError(
                f"mask shape {mask.shape} != ({self.n},)")
        idx = np.flatnonzero(mask)
        num = {col: np.asarray(getattr(self, col))[idx]
               for col, _dt in _NUM_COLS}
        cat = {col: Categorical(getattr(self, col).codes[idx],
                                list(getattr(self, col).vocab))
               for col in _CAT_COLS}
        names = self.names
        return TraceStore(
            int(len(idx)), num, cat,
            names=[names[int(i)] for i in idx],
            group_tables=list(self.group_tables),
            group_code=self.group_code[idx],
            stp_tables=list(self.stp_tables),
            stp_code=self.stp_code[idx],
            axes_tables=list(self.axes_tables),
            axes_code=self.axes_code[idx])

    # ---- per-row compatibility views ---------------------------------------

    @property
    def replica_groups(self) -> List[List[List[int]]]:
        if self._rg_rows is None:
            tables = self.group_tables
            self._rg_rows = [tables[c] for c in self.group_code]
        return self._rg_rows

    @property
    def source_target_pairs(self) -> List[Optional[List[Tuple[int, int]]]]:
        if self._stp_rows is None:
            tables = self.stp_tables
            self._stp_rows = [None if c < 0 else tables[c]
                              for c in self.stp_code]
        return self._stp_rows

    @property
    def axes(self) -> List[Tuple[str, ...]]:
        if self._axes_rows is None:
            tables = self.axes_tables
            self._axes_rows = [tables[c] for c in self.axes_code]
        return self._axes_rows

    @property
    def op_names(self) -> List[str]:
        return self.op_name.values()

    def set_axes(self, axes_tables: List[Tuple[str, ...]],
                 axes_code: np.ndarray) -> None:
        """Replace the axes payload (used by `costmodel.annotate_store`)."""
        self.axes_tables = axes_tables
        self.axes_code = np.asarray(axes_code, dtype=np.int32)
        self._axes_rows = None
        # a same-length replacement would fool append's len-based
        # staleness check on the cached value index — drop it outright
        self._tbl_idx.pop("axes", None)

    # ---- row views ---------------------------------------------------------

    def row(self, i: int) -> CollectiveEvent:
        """Materialize row `i` as the classic dataclass view.

        The mutable payloads (replica groups, permute pairs) are *copied*
        out of the shared dedup tables: `Trace` documents an
        edit-rows-in-place + `invalidate()` workflow, and an edit through
        an aliased table would silently rewrite every sibling row.
        """
        ch = int(self.channel_id[i])
        sc = self.stp_code[i]
        return CollectiveEvent(
            name=self.names[i],
            kind=self.kind.value(i),
            async_start=bool(self.async_start[i]),
            operand_bytes=int(self.operand_bytes[i]),
            result_bytes=int(self.result_bytes[i]),
            dtype=self.dtype.value(i),
            replica_groups=[list(g)
                            for g in self.group_tables[self.group_code[i]]],
            group_size=int(self.group_size[i]),
            num_groups=int(self.num_groups[i]),
            op_name=self.op_name.value(i),
            computation=self.computation.value(i),
            multiplicity=int(self.multiplicity[i]),
            channel_id=None if ch < 0 else ch,
            source_target_pairs=None if sc < 0 else list(self.stp_tables[sc]),
            link_class=self.link_class.value(i),
            axes=self.axes_tables[self.axes_code[i]],
            semantic=self.semantic.value(i),
            jax_prim=self.jax_prim.value(i),
            scope=self.scope.value(i),
            protocol=self.protocol.value(i),
            wire_bytes_per_device=float(self.wire_bytes_per_device[i]),
            est_time_s=float(self.est_time_s[i]))

    def rows(self) -> List[CollectiveEvent]:
        return [self.row(i) for i in range(self.n)]

    # ---- derived columns ---------------------------------------------------

    @property
    def weights(self) -> np.ndarray:
        """Execution multiplicity as float (the x-loop-trip-count weight)."""
        return self.multiplicity.astype(np.float64)

    @property
    def wire_total(self) -> np.ndarray:
        """Per-site total wire bytes (per execution), all participants."""
        return (self.wire_bytes_per_device * self.group_size.astype(np.float64)
                * self.num_groups.astype(np.float64))

    # ---- vectorized aggregates --------------------------------------------

    def total_collective_bytes(self) -> float:
        return float(np.dot(self.operand_bytes.astype(np.float64), self.weights))

    def total_wire_bytes(self) -> float:
        return float(np.dot(self.wire_total, self.weights))

    def total_est_time_s(self) -> float:
        return float(np.dot(self.est_time_s, self.weights))

    def overlapped_est_time_s(self) -> float:
        if self.n == 0:
            return 0.0
        per_class = np.bincount(self.link_class.codes,
                                weights=self.est_time_s * self.weights,
                                minlength=len(self.link_class.vocab))
        return float(per_class.max())

    def _rollup_arrays(self, inv: np.ndarray, nb: int) -> np.ndarray:
        """(4, nb) metric matrix [bytes, wire_bytes, count, time_s].

        Each row is a bincount over `inv`, accumulating in *row order* —
        the same add sequence the per-event dict reference performs per
        key, so the float sums are bit-identical, not merely close.
        """
        w = self.weights
        b = np.bincount(inv, weights=self.operand_bytes * w, minlength=nb)
        wire = np.bincount(inv, weights=self.wire_total * w, minlength=nb)
        c = np.bincount(inv, weights=w, minlength=nb)
        t = np.bincount(inv, weights=self.est_time_s * w, minlength=nb)
        return np.stack([b, wire, c, t])

    def _aggregate(self, inv: np.ndarray, labels: List[str]
                   ) -> Dict[str, Dict[str, float]]:
        """{label: {bytes, wire_bytes, count, time_s}} via bincount."""
        m = self._rollup_arrays(inv, len(labels))
        return {labels[i]: {"bytes": float(m[0, i]),
                            "wire_bytes": float(m[1, i]),
                            "count": float(m[2, i]), "time_s": float(m[3, i])}
                for i in range(len(labels))}

    def _join_codes(self, cats: Sequence[Categorical], sep: str = "|"
                    ) -> Tuple[np.ndarray, List[str]]:
        """Composite key codes over several categoricals (occurring only)."""
        if self.n == 0:
            return np.empty(0, dtype=np.int64), []
        combo = np.zeros(self.n, dtype=np.int64)
        for cat in cats:
            combo = combo * len(cat.vocab) + cat.codes
        uniq, inv = np.unique(combo, return_inverse=True)
        labels = []
        for code in uniq:
            parts = []
            for cat in reversed(cats):
                code, r = divmod(code, len(cat.vocab))
                parts.append(cat.vocab[r])
            labels.append(sep.join(reversed(parts)))
        return inv, labels

    def axes_labels(self) -> Categorical:
        """The axes payload as a categorical of joined labels ("data,model").

        Distinct tuples joining to the same string are merged, so the codes
        key on the *label* exactly like the per-event dict reference.
        """
        raw = [",".join(t) for t in self.axes_tables]
        return Categorical(self.axes_code, raw).remap_table(raw)

    def _codes_for(self, by: str) -> Tuple[np.ndarray, List[str]]:
        """(inverse codes, labels) for a named rollup key."""
        if by == "semantic":
            # empty semantic rolls up as "other" (matches per-event path)
            merged = self.semantic.remap(lambda v: v or "other")
            uniq, inv = np.unique(merged.codes, return_inverse=True)
            return inv, [merged.vocab[c] for c in uniq]
        if by == "kind_link":
            return self._join_codes((self.kind, self.link_class))
        if by == "site":
            # per-callsite key: interned op_name x kind x axes codes
            return self._join_codes((self.op_name, self.kind,
                                     self.axes_labels()))
        return self._join_codes((self.semantic, self.kind, self.link_class))

    def rollup(self, by: str) -> Tuple[List[str], np.ndarray]:
        """(labels, (4, n_labels) matrix [bytes, wire_bytes, count, time_s]).

        The array-shaped sibling of the dict rollups below — what the
        columnar renderers and the code-aligned diff consume directly.
        """
        if self.n == 0:
            return [], np.zeros((4, 0))
        inv, labels = self._codes_for(by)
        return labels, self._rollup_arrays(inv, len(labels))

    def by_kind_and_link(self) -> Dict[str, Dict[str, float]]:
        return self._aggregate(*self._codes_for("kind_link"))

    def by_semantic(self) -> Dict[str, Dict[str, float]]:
        if self.n == 0:
            return {}
        return self._aggregate(*self._codes_for("semantic"))

    def by_sem_kind_link(self) -> Dict[str, Dict[str, float]]:
        return self._aggregate(*self._codes_for("sem_kind_link"))

    def by_site(self) -> Dict[str, Dict[str, float]]:
        return self._aggregate(*self._codes_for("site"))

    def serial_est_time_s(self) -> float:
        """Total modeled time accumulated in strict row order.

        `total_est_time_s` uses `np.dot` (pairwise summation); the
        renderers need the *sequential* sum so the columnar and per-event
        paths print bit-identical totals.
        """
        if self.n == 0:
            return 0.0
        return float(np.add.accumulate(self.est_time_s * self.weights)[-1])

    # ---- replica-group expansion (static analysis support) -----------------

    def expand_groups(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flattened expansion of the *unique* replica-group tables.

        Returns `(table_code, group_idx, device)` int64 arrays with one
        entry per device slot of every unique table — the scatter-ready
        form the static analyzer (`commcheck`) consumes.  Sized by the
        deduplicated tables, not by rows: a 100k-site trace stamping the
        same handful of `replica_groups` attrs expands each table once.
        Cached on the store.
        """
        if self._gexp is None:
            tcodes: List[np.ndarray] = []
            gidxs: List[np.ndarray] = []
            devs: List[np.ndarray] = []
            for c, table in enumerate(self.group_tables):
                for gi, group in enumerate(table):
                    k = len(group)
                    if not k:
                        continue
                    tcodes.append(np.full(k, c, dtype=np.int64))
                    gidxs.append(np.full(k, gi, dtype=np.int64))
                    devs.append(np.asarray(group, dtype=np.int64))
            if tcodes:
                self._gexp = (np.concatenate(tcodes), np.concatenate(gidxs),
                              np.concatenate(devs))
            else:
                z = np.empty(0, dtype=np.int64)
                self._gexp = (z, z.copy(), z.copy())
        return self._gexp

    def table_device_counts(self, num_devices: int) -> np.ndarray:
        """`(n_tables, num_devices)` appearance counts per unique table.

        Entry `[t, d]` is how many group slots of table `t` name device
        `d` — 0 = not a participant, >1 = listed twice (overlap).  Devices
        outside `[0, num_devices)` are dropped here; out-of-range lint
        reads the raw expansion instead.
        """
        counts = np.zeros((len(self.group_tables), num_devices),
                          dtype=np.int64)
        if counts.size == 0:
            return counts
        tcode, _gi, dev = self.expand_groups()
        ok = (dev >= 0) & (dev < num_devices)
        np.add.at(counts, (tcode[ok], dev[ok]), 1)
        return counts

    # ---- comm-matrix edges -------------------------------------------------

    def ring_edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Directed (src, dst, bytes) edge arrays for the comm matrix.

        Ring collectives contribute neighbor edges within each replica
        group; permutes follow their explicit source->target pairs.  Rows
        sharing a group/pair table are folded first (their per-row weights
        are bincount-summed per table code), so each unique topology emits
        its edges once.  Built once per store and cached — `np.add.at`
        scatters the whole edge list in one call.
        """
        if self._edges is None:
            srcs: List[np.ndarray] = []
            dsts: List[np.ndarray] = []
            ws: List[np.ndarray] = []
            stp_mask = self.stp_code >= 0
            ring_mask = ~stp_mask
            # ring rows: weight = wire_bytes_per_device x multiplicity,
            # summed over rows sharing the same group table
            if ring_mask.any():
                w_ring = np.bincount(
                    self.group_code[ring_mask],
                    weights=(self.wire_bytes_per_device
                             * self.weights)[ring_mask],
                    minlength=len(self.group_tables))
                for gc in np.flatnonzero(w_ring):
                    per_link = float(w_ring[gc])
                    for group in self.group_tables[gc]:
                        if len(group) <= 1:
                            continue
                        arr = np.asarray(group, dtype=np.int64)
                        srcs.append(arr)
                        dsts.append(np.roll(arr, -1))
                        ws.append(np.full(len(arr), per_link))
            # permute rows: weight = operand_bytes x multiplicity per pair
            if stp_mask.any():
                w_stp = np.bincount(
                    self.stp_code[stp_mask],
                    weights=(self.operand_bytes.astype(np.float64)
                             * self.weights)[stp_mask],
                    minlength=len(self.stp_tables))
                for sc in np.flatnonzero(w_stp):
                    pairs = np.asarray(self.stp_tables[sc], dtype=np.int64)
                    srcs.append(pairs[:, 0])
                    dsts.append(pairs[:, 1])
                    ws.append(np.full(len(pairs), float(w_stp[sc])))
            if srcs:
                self._edges = (np.concatenate(srcs), np.concatenate(dsts),
                               np.concatenate(ws))
            else:
                z = np.empty(0, dtype=np.int64)
                self._edges = (z, z.copy(), np.empty(0, dtype=np.float64))
        return self._edges

    # ---- serialization -----------------------------------------------------

    def _payload_dict(self) -> Dict[str, object]:
        return {
            "names": list(self.names),
            "group_tables": self.group_tables,
            "group_code": self.group_code.tolist(),
            "stp_tables": [[list(p) for p in t] for t in self.stp_tables],
            "stp_code": self.stp_code.tolist(),
            "axes_tables": [list(a) for a in self.axes_tables],
            "axes_code": self.axes_code.tolist(),
        }

    def to_dict(self) -> Dict[str, object]:
        """Compact JSON-able dict (exact integer round-trip)."""
        return {
            "version": SCHEMA_VERSION,
            "n": self.n,
            "num": {col: getattr(self, col).tolist() for col, _ in _NUM_COLS},
            "cat": {col: {"vocab": getattr(self, col).vocab,
                          "codes": getattr(self, col).codes.tolist()}
                    for col in _CAT_COLS},
            **self._payload_dict(),
        }

    @classmethod
    def _payload_from(cls, d: Dict[str, object]):
        return dict(
            names=list(d["names"]),
            group_tables=[[list(map(int, g)) for g in t]
                          for t in d["group_tables"]],
            group_code=np.asarray(d["group_code"], dtype=np.int32),
            stp_tables=[[(int(a), int(b)) for a, b in t]
                        for t in d["stp_tables"]],
            stp_code=np.asarray(d["stp_code"], dtype=np.int32),
            axes_tables=[tuple(a) for a in d["axes_tables"]],
            axes_code=np.asarray(d["axes_code"], dtype=np.int32))

    @staticmethod
    def _payload_from_v1(d: Dict[str, object]):
        """Intern the per-row payloads of a schema-1 file."""
        g_idx: Dict = {}
        group_tables: List[List[List[int]]] = []
        s_idx: Dict = {}
        stp_tables: List[List[Tuple[int, int]]] = []
        a_idx: Dict = {}
        axes_tables: List[Tuple[str, ...]] = []
        group_code, stp_code, axes_code = [], [], []
        for rgs in d["replica_groups"]:
            groups = [list(map(int, g)) for g in rgs]
            key = tuple(tuple(g) for g in groups)
            group_code.append(_intern(g_idx, key, group_tables, lambda: groups))
        for p in d["source_target_pairs"]:
            if not p:
                stp_code.append(-1)
                continue
            pairs = [(int(a), int(b)) for a, b in p]
            stp_code.append(_intern(s_idx, tuple(pairs), stp_tables,
                                    lambda: pairs))
        for a in d["axes"]:
            t = tuple(a)
            axes_code.append(_intern(a_idx, t, axes_tables, lambda: t))
        return dict(
            names=list(d["names"]),
            group_tables=group_tables,
            group_code=np.asarray(group_code, dtype=np.int32),
            stp_tables=stp_tables,
            stp_code=np.asarray(stp_code, dtype=np.int32),
            axes_tables=axes_tables,
            axes_code=np.asarray(axes_code, dtype=np.int32))

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "TraceStore":
        version = d.get("version")
        if version not in (1, SCHEMA_VERSION):
            raise ValueError(f"unknown TraceStore schema: {version!r}")
        n = int(d["n"])
        num = {col: np.asarray(d["num"][col], dtype=dt).reshape(n)
               for col, dt in _NUM_COLS}
        cat = {}
        for col in _CAT_COLS:
            if col == "op_name" and col not in d["cat"]:
                # v1 kept op_name as a per-row list, not a categorical
                cat[col] = Categorical.from_values(list(d["op_names"]))
                continue
            cat[col] = Categorical(
                np.asarray(d["cat"][col]["codes"], dtype=np.int32).reshape(n),
                list(d["cat"][col]["vocab"]))
        payload = cls._payload_from(d) if version == SCHEMA_VERSION \
            else cls._payload_from_v1(d)
        return cls(n, num, cat, **payload)

    def npz_arrays(self, prefix: str = "") -> Dict[str, np.ndarray]:
        """Flat array dict for the npz container (no object arrays).

        Numeric and code columns go in natively; per-row names pack into
        one newline-joined uint8 blob (`{prefix}names`, see `LazyNames`)
        so the side-car stays O(vocab) not O(rows); the remaining
        irregular payloads (unique tables, vocabs) ride in one JSON
        side-car string — small relative to the columns.
        """
        arrs: Dict[str, np.ndarray] = {}
        for col, _dt in _NUM_COLS:
            arrs[f"{prefix}{col}"] = getattr(self, col)
        for col in _CAT_COLS:
            arrs[f"{prefix}cat_{col}"] = getattr(self, col).codes
        arrs[f"{prefix}group_code"] = self.group_code
        arrs[f"{prefix}stp_code"] = self.stp_code
        arrs[f"{prefix}axes_code"] = self.axes_code
        arrs[f"{prefix}names"] = pack_names(self.names)
        side = {
            "version": SCHEMA_VERSION,
            "n": self.n,
            "vocab": {col: getattr(self, col).vocab for col in _CAT_COLS},
            "group_tables": self.group_tables,
            "stp_tables": [[list(p) for p in t] for t in self.stp_tables],
            "axes_tables": [list(a) for a in self.axes_tables],
        }
        arrs[f"{prefix}meta"] = np.array(json.dumps(side))
        return arrs

    @classmethod
    def from_npz_arrays(cls, arrs, prefix: str = "",
                        lazy: bool = False) -> "TraceStore":
        """Rebuild a store from `npz_arrays` output (or an mmap view).

        `np.asarray` adopts matching-dtype members without copying, so
        handing this an `MmapNpz` mapping builds a store whose columns
        are read-only memory maps — `lazy=True` additionally defers the
        packed-name decode (`LazyNames`), the only O(rows) Python work
        left on the load path.  Older archives that kept names in the
        JSON side-car still load.
        """
        side = json.loads(str(arrs[f"{prefix}meta"]))
        version = side.get("version")
        if version not in (1, SCHEMA_VERSION):
            raise ValueError(f"unknown TraceStore schema: {version!r}")
        n = int(side["n"])
        num = {col: np.asarray(arrs[f"{prefix}{col}"], dtype=dt).reshape(n)
               for col, dt in _NUM_COLS}
        cat = {}
        for col in _CAT_COLS:
            if col == "op_name" and col not in side["vocab"]:
                cat[col] = Categorical.from_values(list(side["op_names"]))
                continue
            cat[col] = Categorical(
                np.asarray(arrs[f"{prefix}cat_{col}"],
                           dtype=np.int32).reshape(n),
                list(side["vocab"][col]))
        if f"{prefix}names" in arrs:
            lazy_names = LazyNames(arrs[f"{prefix}names"], n)
            names = lazy_names if lazy else lazy_names._materialize()
        else:
            names = list(side["names"])    # pre-warehouse archives
        if version == SCHEMA_VERSION:
            payload = dict(
                names=names,
                group_tables=[[list(map(int, g)) for g in t]
                              for t in side["group_tables"]],
                group_code=np.asarray(arrs[f"{prefix}group_code"],
                                      dtype=np.int32).reshape(n),
                stp_tables=[[(int(a), int(b)) for a, b in t]
                            for t in side["stp_tables"]],
                stp_code=np.asarray(arrs[f"{prefix}stp_code"],
                                    dtype=np.int32).reshape(n),
                axes_tables=[tuple(a) for a in side["axes_tables"]],
                axes_code=np.asarray(arrs[f"{prefix}axes_code"],
                                     dtype=np.int32).reshape(n))
        else:
            payload = cls._payload_from_v1(side)
        return cls(n, num, cat, **payload)


# --------------------------------------------------------------------------
# pooled tree-merge level (merge_tree workers)
# --------------------------------------------------------------------------

# fork workers inherit the level's store list copy-on-write, so only
# (lo, hi) spans ride the job pipe; the lock serializes concurrent
# pooled merges: a spawned pool must bootstrap within this bound, or the
# merge runs in-process (embedded interpreters and stdin scripts can kill
# every worker before it reads the call queue, and `ex.map` then blocks)
_SPAWN_PROBE_TIMEOUT_S = 30.0

_FORK_MERGE_STATE = None
_FORK_MERGE_LOCK = threading.Lock()


def _merge_span(span):
    """Fork worker: merge one chunk of the inherited store list."""
    lo, hi = span
    return TraceStore.merge(_FORK_MERGE_STATE[lo:hi])


def _merge_job(stores):
    """Spawn worker: merge one pickled chunk of stores."""
    return TraceStore.merge(stores)


def _pooled_merge_level(chunks, workers):
    """One merge_tree level on a process pool; None -> caller runs serial.

    Fork when safe (a torch-loaded parent is multithreaded: its intra-op
    pool and the CUDA runtime start native threads, and forking it can
    deadlock), else
    spawn behind a no-op probe so a pool that cannot bootstrap degrades
    to the in-process path instead of hanging `ex.map` forever.
    """
    import multiprocessing
    import pickle
    from concurrent.futures import ProcessPoolExecutor
    from concurrent.futures.process import BrokenProcessPool
    global _FORK_MERGE_STATE

    workers = min(workers, len(chunks), os.cpu_count() or 1)
    if workers <= 1:
        return None
    method = "fork" if (
        "fork" in multiprocessing.get_all_start_methods()
        and "torch" not in sys.modules) else "spawn"
    try:
        mp_ctx = multiprocessing.get_context(method)
        if method == "fork":
            spans, off = [], 0
            for c in chunks:
                spans.append((off, off + len(c)))
                off += len(c)
            with _FORK_MERGE_LOCK:
                _FORK_MERGE_STATE = [s for c in chunks for s in c]
                try:
                    with ProcessPoolExecutor(max_workers=workers,
                                             mp_context=mp_ctx) as ex:
                        return list(ex.map(_merge_span, spans))
                finally:
                    _FORK_MERGE_STATE = None
        else:
            ex = ProcessPoolExecutor(max_workers=workers, mp_context=mp_ctx)
            try:
                ex.submit(int).result(timeout=_SPAWN_PROBE_TIMEOUT_S)
                results = list(ex.map(_merge_job, chunks))
                ex.shutdown()
                return results
            except Exception:
                ex.shutdown(wait=False, cancel_futures=True)
                raise OSError("spawn pool unusable")
    except (BrokenProcessPool, pickle.PicklingError, ImportError, OSError):
        return None


# --------------------------------------------------------------------------
# cross-store alignment (the code-aligned N-way diff core)
# --------------------------------------------------------------------------

def union_rollup(stores: Sequence[TraceStore], by: str
                 ) -> Tuple[List[str], np.ndarray]:
    """Shared-vocabulary rollup across N stores.

    Each store rolls up once to (labels, metrics); the label lists are
    interned into one union vocabulary (first-seen order across stores)
    and every store's metric columns scatter into its slice of a
    `(4, n_keys, n_stores)` tensor ([bytes, wire_bytes, count, time_s]).
    Keys absent from a store stay zero — exactly the `dict.get(key, zero)`
    semantics of the per-event alignment, without any string-keyed dicts
    on the N-trace hot path.
    """
    per = [s.rollup(by) for s in stores]
    all_labels: List[str] = []
    for labels, _ in per:
        all_labels.extend(labels)
    remap, union = build_remap(all_labels)
    out = np.zeros((4, len(union), len(stores)))
    off = 0
    for t, (labels, mat) in enumerate(per):
        k = len(labels)
        out[:, remap[off:off + k], t] = mat
        off += k
    return union, out


class IncrementalRollup:
    """Streaming sibling of `union_rollup`: fold per-chunk rollups into
    one (labels, matrix) accumulator without keeping the chunks.

    `update(store)` rolls the chunk up once and scatter-adds its metric
    columns into a union-vocabulary `(4, n_labels)` matrix, interning
    labels first-seen across chunks.  State is O(unique labels), not
    O(rows) — how the watch daemon keeps Table II aggregates fresh per
    poll without re-rolling the whole rolling store.
    """

    def __init__(self, by: str):
        self.by = by
        self.labels: List[str] = []
        self._index: Dict[str, int] = {}
        self.matrix = np.zeros((4, 0))

    def update(self, store: TraceStore) -> None:
        labels, mat = store.rollup(self.by)
        if not labels:
            return
        cols = np.empty(len(labels), dtype=np.int64)
        for i, lbl in enumerate(labels):
            j = self._index.get(lbl)
            if j is None:
                j = self._index[lbl] = len(self.labels)
                self.labels.append(lbl)
            cols[i] = j
        if len(self.labels) > self.matrix.shape[1]:
            grown = np.zeros((4, len(self.labels)))
            grown[:, :self.matrix.shape[1]] = self.matrix
            self.matrix = grown
        # chunk labels are unique, so fancy-index += is a safe scatter
        self.matrix[:, cols] += mat

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        m = self.matrix
        return {lbl: {"bytes": float(m[0, i]), "wire_bytes": float(m[1, i]),
                      "count": float(m[2, i]), "time_s": float(m[3, i])}
                for i, lbl in enumerate(self.labels)}
