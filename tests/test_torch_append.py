"""Append-mode TraceStore in the port: incremental growth equals batch, byte
for byte (the reference's `tests/test_append.py`, one counterpart a case, on
capture dumps where it parses HLO).

A store grown by `TraceStore.append` over the chunks of a capture is
`identical` (codes, vocab order, payload tables) to the one
`trace_from_capture` reads from the whole capture, and to `merge` of the
chunks in any order they arrive in.  The streaming aggregates
(`IncrementalRollup`, `detect.DetectorState`, `commcheck.CommcheckState`)
fed chunk by chunk reproduce their batch passes over the union.  A chunk is
what a rank writes for a slice of its step's sites: the capture dump of a
trace of those rows, read back by `trace_from_capture`.
"""
import itertools
import json

import numpy as np
import pytest

from repro_torch.core import attribution, commcheck, costmodel, detect, dump
from repro_torch.core.events import Trace
from repro_torch.core.store import IncrementalRollup, TraceStore, union_rollup
from repro_torch.core.synth import inject_comm_bugs, synthetic_capture, synthetic_trace
from repro_torch.core.topology import H100, MeshSpec

MESH = MeshSpec((2, 4), ("data", "model"))


def _sub(events, label):
    return Trace(label=label, mesh_shape=MESH.shape, mesh_axes=MESH.axes,
                 num_devices=MESH.num_devices, events=events)


def chunk_stores(seed: int, n_sites: int = 400, n_chunks: int = 4):
    """(the stores read from the captures of `n_chunks` consecutive slices of a
    synthetic capture's rows, the store read from the whole capture)."""
    batch = dump.trace_from_capture(synthetic_capture(n_sites=n_sites, seed=seed), MESH)
    evs = batch.events
    step = (len(evs) + n_chunks - 1) // n_chunks
    stores = [dump.trace_from_capture(dump.capture_text(_sub(evs[i:i + step], f"c{i}"), MESH),
                                      MESH).store
              for i in range(0, len(evs), step)]
    return stores, batch.store


# -- the byte-identity invariant ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123, 404, 777, 1000])
def test_append_identical_to_batch_read(seed):
    stores, batch = chunk_stores(seed)
    acc = TraceStore.empty()
    for s in stores:
        assert acc.append(s) is acc
    assert acc.identical(batch)
    # the appended store keeps working as a store: caches rebuilt on demand
    assert acc.rows() == batch.rows()


@pytest.mark.parametrize("order", list(itertools.permutations(range(3))))
def test_append_matches_merge_in_any_order(order):
    """Out-of-order arrival: append in `order` equals merge in the same order."""
    stores, _ = chunk_stores(11, n_sites=300, n_chunks=3)
    acc = TraceStore.empty()
    for i in order:
        acc.append(stores[i])
    assert acc.identical(TraceStore.merge([stores[i] for i in order]))


def test_append_empty_is_noop_both_ways():
    stores, _ = chunk_stores(3, n_sites=120, n_chunks=2)
    acc = TraceStore.empty()
    acc.append(TraceStore.empty())
    assert acc.n == 0
    acc.append(stores[0])
    before = acc.to_dict()
    acc.append(TraceStore.empty())
    assert acc.identical(stores[0])
    assert acc.to_dict() == before


def test_append_single_chunk_identical():
    stores, batch = chunk_stores(5, n_sites=100, n_chunks=1)
    acc = TraceStore.empty()
    acc.append(stores[0])
    assert acc.identical(stores[0]) and acc.identical(batch)


def test_append_self_raises():
    tr = synthetic_trace("s", MESH, n_sites=30, seed=0)
    with pytest.raises(ValueError):
        tr.store.append(tr.store)


def test_append_annotated_chunks_matches_merge():
    """Chunks priced anew (`annotate_store` orders the derived axes tables per
    store): append is pinned against merge of the same priced chunks."""
    stores, _ = chunk_stores(17)
    for s in stores:
        costmodel.annotate_store(s, MESH, H100)
        attribution.attribute_store(s)
    acc = TraceStore.empty()
    for s in stores:
        acc.append(s)
    ref = TraceStore.merge(stores)
    assert acc.identical(ref)
    assert acc.by_kind_and_link() == ref.by_kind_and_link()


def test_append_after_wholesale_column_replacement():
    """`annotate_store` replaces numeric columns with fresh arrays; the next
    append re-adopts them instead of writing into stale buffers."""
    stores, _ = chunk_stores(23, n_sites=200, n_chunks=3)
    acc = TraceStore.empty()
    acc.append(stores[0])
    costmodel.annotate_store(acc, MESH, H100)
    t0 = acc.est_time_s.copy()
    acc.append(stores[1])
    np.testing.assert_array_equal(acc.est_time_s[:len(t0)], t0)
    assert acc.n == stores[0].n + stores[1].n


# -- persistence of appended stores ------------------------------------------

def test_appended_store_v2_roundtrip(tmp_path):
    stores, batch = chunk_stores(29, n_sites=150, n_chunks=3)
    acc = TraceStore.empty()
    for s in stores:
        acc.append(s)
    d = json.loads(json.dumps(acc.to_dict()))
    assert d["version"] == 2
    assert TraceStore.from_dict(d).identical(batch)
    path = tmp_path / "acc.npz"
    np.savez_compressed(path, **dict(acc.npz_arrays(prefix="a_")))
    with np.load(path) as loaded:
        assert TraceStore.from_npz_arrays(loaded, prefix="a_").identical(batch)


def test_appended_store_v1_dict_roundtrip():
    acc = TraceStore.empty()
    acc.append(synthetic_trace("a", MESH, n_sites=40, seed=1).store)
    acc.append(synthetic_trace("b", MESH, n_sites=40, seed=2).store)
    d = acc.to_dict()
    v1 = {"version": 1, "n": d["n"], "num": d["num"],
          "cat": {k: v for k, v in d["cat"].items() if k != "op_name"},
          "names": acc.names, "op_names": acc.op_names,
          "axes": [list(x) for x in acc.axes],
          "replica_groups": acc.replica_groups,
          "source_target_pairs": [None if p is None else [list(pair) for pair in p]
                                  for p in acc.source_target_pairs]}
    assert TraceStore.from_dict(v1).rows() == acc.rows()


# -- streaming aggregates equal the batch pass over the union ----------------

def test_incremental_rollup_matches_union_and_batch():
    """Label for label and in order against the union; against the batch read
    label for label: its site keys follow the capture's axes-table order,
    which the chunks' first-seen order need not (the reference's batch is a
    raw parse, whose keys come in row order)."""
    stores, batch = chunk_stores(31)
    for by in ("kind_link", "semantic", "site"):
        inc = IncrementalRollup(by)
        for s in stores:
            inc.update(s)
        labels, mat = union_rollup(stores, by)
        assert inc.labels == labels
        np.testing.assert_allclose(inc.matrix, mat.sum(axis=2), rtol=1e-12)
        blabels, bmat = batch.rollup(by)
        assert sorted(inc.labels) == sorted(blabels)
        at = {lab: i for i, lab in enumerate(blabels)}
        np.testing.assert_allclose(inc.matrix, bmat[:, [at[lab] for lab in inc.labels]],
                                   rtol=1e-12)


def finding_key(f):
    return (f.detector, f.severity, f.site, f.message)


def _in_fifths(events):
    step = (len(events) + 4) // 5
    return [events[i:i + step] for i in range(0, len(events), step)]


def test_detector_state_matches_run_all():
    full = synthetic_trace("full", MESH, n_sites=3000, seed=4)
    expected = {"grad_sync": "data"}
    batch = detect.run_all(full, expected_axes=expected)
    state = detect.DetectorState(expected_axes=expected)
    for i, evs in enumerate(_in_fifths(full.events)):
        state.update(_sub(evs, f"c{i}"))
    assert sorted(map(finding_key, state.findings())) == sorted(map(finding_key, batch))


@pytest.mark.parametrize("seed", [0, 3, 42, 99, 150, 200])
def test_commcheck_state_matches_batch_on_buggy_traces(seed):
    trace, _labels = inject_comm_bugs(MESH, n_sites=120, seed=seed)
    batch = commcheck.check_trace(trace, MESH)
    state = commcheck.CommcheckState(MESH)
    for evs in _in_fifths(trace.events):
        state.update(TraceStore.from_events(evs))
    assert list(map(finding_key, state.findings())) == list(map(finding_key, batch))


def test_commcheck_state_clean_chunked_capture_quiet():
    """A clean capture read whole and in chunks (each priced and attributed as
    ingest does) gives the same findings."""
    stores, batch = chunk_stores(9, n_sites=400, n_chunks=3)
    whole = commcheck.check_trace(dump.trace_from_capture(
        synthetic_capture(n_sites=400, seed=9), MESH), MESH)
    state = commcheck.CommcheckState(MESH)
    for s in stores:
        costmodel.annotate_store(s, MESH, H100)
        attribution.attribute_store(s)
        state.update(s)
    assert list(map(finding_key, state.findings())) == list(map(finding_key, whole))
