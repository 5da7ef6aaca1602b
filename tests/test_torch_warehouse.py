"""The trace warehouse in the port: tree-reduction merge, deterministic saves,
memory-mapped load and the `session query` slice CLI (the reference's
`tests/test_warehouse.py`, one counterpart a case, on fleets of capture
dumps where it ingests HLO).

  * `TraceStore.merge_tree` is `identical` to the flat `merge` for any tree
    shape, serially and through the process pool.
  * `save` is byte-deterministic: the same session saved twice gives the
    same bytes.
  * `load(mmap=True)` is read-only and copy-on-write: columns are maps of the
    file that cannot be written, mutation copies, the file never changes,
    and query/diff answers equal an eager load's byte for byte.
  * `session query` exits 0 on success (an empty slice is a valid empty
    answer) and 2 on input errors.
"""
import json

import numpy as np
import pytest

from repro_torch.core.diff import diff_json
from repro_torch.core.persist import open_npz_mmap, write_npz
from repro_torch.core.session import TraceSession, _main, label_meta, parse_slice
from repro_torch.core.store import LazyNames, TraceStore, pack_names
from repro_torch.core.synth import synthetic_trace, write_fleet_dump
from repro_torch.core.topology import MeshSpec

MESH = MeshSpec((2, 4), ("data", "model"))


def host_trace(h: int, step: int = 0, n: int = 80):
    return synthetic_trace(f"host{h:03d}_step{step:03d}", MESH, n_sites=n, seed=h * 7 + step)


def fleet_session(n_hosts: int = 4, steps: int = 1, n: int = 80):
    return TraceSession("fleet", [host_trace(h, s, n) for h in range(n_hosts)
                                  for s in range(steps)])


# -- tree-reduction merge ----------------------------------------------------

@pytest.mark.parametrize("n,arity", [(1, 2), (2, 2), (5, 3), (8, 2), (9, 4), (13, 5)])
def test_merge_tree_identical_to_flat_merge(n, arity):
    stores = [host_trace(h, n=30).store for h in range(n)]
    flat = TraceStore.merge(stores)
    assert TraceStore.merge_tree(stores, arity=arity).identical(flat)
    # through the process pool (serial where the host cannot start one)
    assert TraceStore.merge_tree(stores, arity=arity, workers=2).identical(flat)


def test_merge_tree_matches_any_manual_bracketing():
    stores = [host_trace(h, n=25).store for h in range(6)]
    flat = TraceStore.merge(stores)
    # a lopsided shape: ((0, 1), 2, ((3, 4), 5))
    left = TraceStore.merge([TraceStore.merge(stores[:2]), stores[2]])
    right = TraceStore.merge([TraceStore.merge(stores[3:5]), stores[5]])
    assert TraceStore.merge([left, right]).identical(flat)
    acc = stores[0]                # the serial left fold is a bracketing too
    for s in stores[1:]:
        acc = TraceStore.merge([acc, s])
    assert acc.identical(flat)


def test_merge_tree_edges():
    with pytest.raises(ValueError):
        TraceStore.merge_tree([TraceStore.empty()], arity=1)
    assert TraceStore.merge_tree([]).n == 0
    solo = host_trace(0, n=20).store
    assert TraceStore.merge_tree([solo]) is solo      # a single input passes through


# -- deterministic persistence -----------------------------------------------

@pytest.mark.parametrize("ext", ["npz", "json"])
def test_save_twice_is_byte_identical(tmp_path, ext):
    sess = fleet_session(n_hosts=2, n=60)
    p1 = sess.save(str(tmp_path / f"a.{ext}"))
    p2 = sess.save(str(tmp_path / f"b.{ext}"))
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


def test_write_npz_is_np_load_compatible_and_maps(tmp_path):
    arrs = {"floats": np.linspace(0.0, 1.0, 17), "codes": np.arange(5, dtype=np.int32),
            "empty": np.zeros(0, dtype=np.int64),
            "fortran": np.asfortranarray(np.arange(6.0).reshape(2, 3)),
            "meta": np.array(json.dumps({"n": 17}))}
    for compress in (True, False):
        path = str(tmp_path / f"c{compress}.npz")
        with open(path, "wb") as f:
            write_npz(f, arrs, compress=compress, workers=4)
        with np.load(path) as loaded:
            assert sorted(loaded.files) == sorted(arrs)
            for k, v in arrs.items():
                assert loaded[k].shape == np.asarray(v).shape
                assert np.array_equal(loaded[k], v)
        if compress:
            with pytest.raises(ValueError, match="no-compress"):
                open_npz_mmap(path)
            continue
        mapped = open_npz_mmap(path)
        assert sorted(mapped) == sorted(arrs) and len(mapped) == len(arrs)
        for k, v in arrs.items():
            assert np.array_equal(mapped[k], v), k
        assert isinstance(mapped["floats"], np.memmap)
        assert mapped["floats"] is mapped["floats"]           # mapped once, cached
        with pytest.raises(ValueError):
            mapped["codes"][0] = 9


# -- mmap load: read-only, copy-on-write, byte-identical answers -------------

def test_mmap_load_is_zero_copy_and_cow(tmp_path):
    sess = fleet_session(n_hosts=3, n=70)
    path = sess.save(str(tmp_path / "fleet.npz"), compress=False)
    with open(path, "rb") as f:
        before = f.read()
    lazy = TraceSession.load(path, mmap=True)
    eager = TraceSession.load(path)
    store = lazy.get(lazy.labels()[0]).store
    col = store.operand_bytes
    assert not col.flags.writeable and not col.flags.owndata
    assert isinstance(col.base, np.memmap) or isinstance(getattr(col.base, "base", None),
                                                         np.memmap)
    with pytest.raises((ValueError, RuntimeError)):
        store.operand_bytes[0] = 1.0
    assert isinstance(store.names, LazyNames)         # names decode on first use
    assert list(store.names) == list(eager.get(lazy.labels()[0]).store.names)

    assert (json.dumps(lazy.query(host="00*"), sort_keys=True)
            == json.dumps(eager.query(host="00*"), sort_keys=True))
    assert (lazy.diff("host=001", "host=002", as_json=True)
            == eager.diff("host=001", "host=002", as_json=True))

    # mutation copies: append grows a private buffer, never the file
    extra = host_trace(9, n=15).store
    n0 = store.n
    store.append(extra)
    assert store.n == n0 + extra.n
    with open(path, "rb") as f:
        assert f.read() == before


def test_mmap_rejects_compressed_and_json(tmp_path):
    sess = fleet_session(n_hosts=2, n=40)
    with pytest.raises(ValueError, match="no-compress"):
        TraceSession.load(sess.save(str(tmp_path / "fleet.npz")), mmap=True)
    with pytest.raises(ValueError, match="uncompressed"):
        TraceSession.load(sess.save(str(tmp_path / "fleet.json")), mmap=True)


# -- packed names ------------------------------------------------------------

def test_lazy_names_semantics():
    names = ["ar.1", "", "rs.2", "ag.3"]
    lazy = LazyNames(pack_names(names), len(names))
    assert len(lazy) == 4 and list(lazy) == names
    assert lazy[2] == "rs.2"
    assert lazy == names and names == list(lazy)
    assert LazyNames(pack_names([]), 0) == []
    assert LazyNames(pack_names([""]), 1) == [""]
    with pytest.raises(ValueError):
        LazyNames(pack_names(["a", "b"]), 3)._materialize()


def test_pre_warehouse_sidecar_names_still_load():
    store = host_trace(0, n=30).store
    arrs = store.npz_arrays()
    # names in the JSON side-car, no packed member: how older sessions stored them
    side = json.loads(str(arrs.pop("meta")))
    side["names"] = list(store.names)
    del arrs["names"]
    arrs["meta"] = np.array(json.dumps(side))
    assert TraceStore.from_npz_arrays(arrs).identical(store)


# -- slice specs and the query layer -----------------------------------------

def test_label_meta_and_parse_slice():
    assert label_meta("host012_step003") == {"host": "012", "step": 3}
    assert label_meta("run5-host7") == {"host": "7"}
    assert label_meta("dp8-baseline") == {}
    assert parse_slice("host=00*,step=1") == {"host": "00*", "step": "1"}
    for bad in ("host=1,port=2", "justaword", "op="):
        with pytest.raises(ValueError):
            parse_slice(bad)


def test_select_rows_match_per_event_reference():
    sess = fleet_session(n_hosts=3, steps=2, n=90)
    sel = sess.select(host="00[01]", step="1", kind="all-reduce*")
    assert sel.labels() == ["host000_step001", "host001_step001"]
    for label in sel.labels():
        want = [e for e in sess.get(label).events if e.kind.startswith("all-reduce")]
        got = sel.get(label).store
        assert got.n == len(want)
        assert all(got.kind.vocab[c].startswith("all-reduce") for c in np.asarray(got.kind.codes))
    # unfiltered traces are shared, not copied
    assert sess.select(host="*").get("host000_step000").store \
        is sess.get("host000_step000").store


def test_query_totals_match_merged_trace():
    sess = fleet_session(n_hosts=4, n=60)
    payload = sess.query(host="00*", by="kind_link")
    assert payload["traces"] == [f"host{h:03d}_step000" for h in range(4)]
    merged = sess.merged()
    assert payload["sites"] == merged.store.n
    assert payload["totals"]["bytes"] == pytest.approx(
        float(np.sum(merged.store.operand_bytes * merged.store.multiplicity)))
    assert payload["totals"]["time_s"] == pytest.approx(merged.total_est_time_s())
    empty = sess.query(host="zzz*")         # a valid, empty answer: not an error
    assert empty["traces"] == [] and empty["sites"] == 0
    assert empty["totals"]["bytes"] == 0.0


def test_fleet_diff_slice_equals_manual_merge():
    sess = fleet_session(n_hosts=4, steps=2, n=70)
    out = json.loads(sess.diff("host=00[01]", "host=00[23]", as_json=True))
    a = TraceSession("a", [sess.get(f"host{h:03d}_step{s:03d}")
                           for h in (0, 1) for s in (0, 1)]).merged()
    b = TraceSession("b", [sess.get(f"host{h:03d}_step{s:03d}")
                           for h in (2, 3) for s in (0, 1)]).merged()
    assert out["rows"] == diff_json(a, b)["rows"]
    assert out["slice"] == {"a": {"spec": "host=00[01]", "traces": 4},
                            "b": {"spec": "host=00[23]", "traces": 4}}


# -- CLI: exit codes and schema ----------------------------------------------

@pytest.fixture()
def fleet_npz(tmp_path):
    """A 3-host fleet of capture dumps ingested uncompressed."""
    dump = write_fleet_dump(str(tmp_path / "dump"), n_hosts=3, steps=1, sites_per_file=30,
                            seed=0)
    out = str(tmp_path / "fleet.npz")
    assert _main(["ingest", out, *dump, "--mesh", "2,4", "--axes", "data,model",
                  "--no-compress"]) == 0
    return out


def test_query_cli_json_schema_and_exit_codes(fleet_npz, tmp_path, capsys):
    assert _main(["query", fleet_npz, "--host", "00*", "--json", "--mmap"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert set(payload) >= {"session", "slice", "traces", "sites", "totals", "rollup"}
    assert payload["slice"]["host"] == "00*"
    assert payload["rollup"]["by"] == "kind_link"
    assert payload["ingest"]["records"] == 3 and payload["ingest"]["degraded"] == 0
    assert _main(["query", fleet_npz, "--host", "00*"]) == 0          # text renders too
    txt = capsys.readouterr().out
    assert "slice host=00*" in txt and "3 trace(s)" in txt
    assert _main(["query", fleet_npz, "--host", "zzz*", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["traces"] == []
    assert _main(["query", str(tmp_path / "nope.npz"), "--json"]) == 2
    compressed = str(tmp_path / "c.npz")
    TraceSession.load(fleet_npz).save(compressed)
    assert _main(["query", compressed, "--mmap"]) == 2
    assert "no-compress" in capsys.readouterr().err


def test_query_and_diff_cli_identical_eager_vs_mmap(fleet_npz, capsys):
    outs = {}
    for flag in ([], ["--mmap"]):
        assert _main(["query", fleet_npz, "--kind", "all-*", "--json", *flag]) == 0
        q = capsys.readouterr().out
        assert _main(["diff", fleet_npz, "host=000", "host=001", "--json", *flag]) == 0
        outs["mmap" if flag else "eager"] = (q, capsys.readouterr().out)
    assert outs["eager"] == outs["mmap"]


def test_report_accepts_slice_spec(fleet_npz, capsys):
    assert _main(["report", fleet_npz, "host=00*", "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["label"] == "host=00*"
    assert _main(["report", fleet_npz, "host=zzz"]) == 2
    assert "matches no traces" in capsys.readouterr().err


def test_ingest_records_carry_host_and_step(fleet_npz):
    recs = TraceSession.load(fleet_npz).ingest_report.records
    assert [(r.host, r.step) for r in recs] == [(f"{h:03d}", 0) for h in range(3)]
    back = [type(recs[0]).from_dict(r.to_dict()) for r in recs]
    assert [(r.host, r.step) for r in back] == [(r.host, r.step) for r in recs]
