"""Chaos in the port: fault injection over the capture dump's salvage read,
batch ingest and the watch daemon (the reference's `tests/test_chaos.py`,
one counterpart a case, on capture dumps where it damages HLO text).

The contract: for any damaged input — truncated, spliced with garbage,
line-mangled, binary — no entry point crashes, clean inputs come through
identical, and every degraded input is accounted for in the ingest
provenance.  Where a corrupt mode's status differs from the reference's on
the same mode, `DIFFERENCES` names the cause.
"""
import json
import os

import pytest

from _hypothesis_compat import given, settings, strategies as st
from repro.core import session as jsession
from repro.core import synth as jsynth
from repro.core.topology import MeshSpec as JMesh
from repro_torch.core import dump
from repro_torch.core.dump import SalvageReport, trace_from_capture
from repro_torch.core.session import IngestError, TraceSession, _main
from repro_torch.core.synth import (CORRUPT_MODES, corrupt_capture, synthetic_capture,
                                    write_corrupt_dump)
from repro_torch.core.topology import MeshSpec
from repro_torch.core.watch import WatchConfig, WatchDaemon

MESH = MeshSpec((2, 4), ("data", "model"))
TEXT = synthetic_capture(n_sites=120, seed=11)
CLEAN = trace_from_capture(TEXT, MESH, label="clean")
LINE_ENDS = [i + 1 for i, c in enumerate(TEXT) if c == "\n"]

# each mode's ingest status under `errors="salvage"` where the reference's
# differs on the same mode (its `write_corrupt_dump(seed=4)` through
# `from_hlo`): (reference status, port status, why)
DIFFERENCES = {
    mode: ("ok", "salvaged", (
        "the reference's strict HLO parse reads instruction by instruction and "
        "passes over lines it cannot place, so this damage parses clean; the "
        "capture's strict read counts its rows against the footer and refuses "
        f"any damage ({why}), and the salvage read recovers the intact rows"))
    for mode, why in (("truncate", "the footer is cut off"),
                      ("splice", "garbage lines are not rows"),
                      ("dup_lines", "a repeated row index"),
                      ("drop_lines", "rows missing from the footer's count"))}


# -- the salvage read: the recover=True contract -----------------------------

def test_salvage_of_clean_text_is_lossless():
    tr = trace_from_capture(TEXT, MESH, label="clean", recover=True)
    rep = tr.salvage
    assert isinstance(rep, SalvageReport)
    assert rep.clean and rep.bytes_skipped == 0 and rep.dropped == []
    assert tr.store.identical(CLEAN.store)


def _check_truncation(k):
    """Salvage of TEXT[:k] never raises, keeps only rows of the capture,
    and accounts for every skipped byte; any cut but of the final newline
    is reported, and the whole text is the identity."""
    tr = trace_from_capture(TEXT[:k], MESH, recover=True)
    rep = tr.salvage
    rows = CLEAN.store.rows()
    assert tr.store.n <= CLEAN.store.n
    assert all(r in rows for r in tr.store.rows())
    assert 0 <= rep.bytes_skipped <= rep.total_bytes == len(TEXT[:k].encode())
    assert rep.computations_dropped == len(rep.dropped)
    if rep.computations_dropped or rep.bytes_skipped or k < len(TEXT) - 1:
        assert rep.first_error and not rep.clean
    else:
        assert rep.clean and tr.store.identical(CLEAN.store)


@settings(max_examples=60, deadline=None)
@given(k=st.integers(min_value=0, max_value=len(TEXT)))
def test_salvage_never_raises_for_any_truncation(k):
    _check_truncation(k)


@pytest.mark.parametrize("k", sorted(
    {0, 1, 7, len(TEXT) - 1, len(TEXT)} | {len(TEXT) * i // 37 for i in range(37)}
    | set(LINE_ENDS[:3] + LINE_ENDS[-3:]) | {e - 1 for e in LINE_ENDS[:2]}))
def test_salvage_never_raises_at_sampled_truncations(k):
    """A capped sample of offsets: inside the header, on and beside line
    ends, spread over the rows, the footer."""
    _check_truncation(k)


@pytest.mark.parametrize("mode", CORRUPT_MODES)
def test_salvage_never_raises_for_any_injector(mode, tmp_path):
    data = corrupt_capture(TEXT, mode, seed=7)
    if isinstance(data, bytes):     # undecodable: refused when the file is read
        (tmp_path / "b.jsonl").write_bytes(data)
        with pytest.raises(UnicodeDecodeError):
            dump.read_capture(str(tmp_path / "b.jsonl"))
        return
    with pytest.raises(ValueError):
        trace_from_capture(data, MESH)          # strict refuses every damage
    tr = trace_from_capture(data, MESH, recover=True)
    assert tr.salvage.to_dict()["computations_dropped"] == len(tr.salvage.dropped)
    assert not tr.salvage.clean


def test_salvage_report_round_trips_to_dict():
    data = corrupt_capture(TEXT, "mangle_rg", seed=7)
    with pytest.raises(ValueError, match="bad replica_groups"):
        trace_from_capture(data, MESH)
    tr = trace_from_capture(data, MESH, recover=True)
    rep = tr.salvage
    assert rep.dropped == ["row 0 (line 2)"] and not rep.clean
    d = rep.to_dict()
    assert d["dropped"] == rep.dropped
    assert json.loads(json.dumps(d)) == d


def test_trace_from_capture_recover_carries_salvage_report():
    tr = trace_from_capture(corrupt_capture(TEXT, "mangle_rg", seed=7), MESH, recover=True)
    assert tr.salvage is not None and tr.salvage.dropped
    assert trace_from_capture(TEXT, MESH, recover=True).salvage.clean
    assert trace_from_capture(TEXT, MESH).salvage is None


# -- batch ingest over a corrupt dump directory ------------------------------

@pytest.fixture()
def chaos_dir(tmp_path):
    with open(os.path.join(str(tmp_path), "clean.jsonl"), "w") as f:
        f.write(TEXT)
    write_corrupt_dump(str(tmp_path), seed=4)
    return str(tmp_path)


def _files(root):
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".jsonl"))


def _salvage(files, **kw):
    return TraceSession.from_captures("chaos", files, MESH, errors=kw.pop("errors", "salvage"),
                                      retries=0, retry_backoff_s=0,
                                      **{"max_workers": 1, **kw})


def test_batch_salvage_accounts_for_every_input(chaos_dir):
    files = _files(chaos_dir)
    sess = _salvage(files)
    rep = sess.ingest_report
    assert [r.source for r in rep.records] == files
    by_src = {os.path.basename(r.source): r for r in rep.records}
    assert by_src["clean.jsonl"].status == "ok"
    assert sess.get("clean").store.identical(CLEAN.store)
    for r in rep.degraded:
        assert r.error, r
        assert r.status in ("salvaged", "quarantined")
    for r in rep.records:
        if r.status == "salvaged":
            assert r.salvage is not None and not r.salvage["clean"]
    assert by_src["corrupt_binary.jsonl"].status == "quarantined"
    assert {m: by_src[f"corrupt_{m}.jsonl"].status for m in CORRUPT_MODES} == {
        m: "quarantined" if m == "binary" else "salvaged" for m in CORRUPT_MODES}


def test_every_mode_s_status_is_the_reference_s_but_for_the_named_differences(tmp_path):
    jfiles = jsynth.write_corrupt_dump(str(tmp_path / "hlo"), seed=4)
    ref = jsession.TraceSession.from_hlo("chaos", jfiles, JMesh((2, 4), ("data", "model")),
                                         max_workers=1, errors="salvage", retries=0,
                                         retry_backoff_s=0)
    got = _salvage(write_corrupt_dump(str(tmp_path / "cap"), seed=4))
    mode = lambda r: r.label[len("corrupt_"):]  # noqa: E731
    want = {mode(r): r.status for r in ref.ingest_report.records}
    have = {mode(r): r.status for r in got.ingest_report.records}
    assert set(want) == set(have) == set(CORRUPT_MODES)
    for m in CORRUPT_MODES:
        if m in DIFFERENCES:
            r, p, why = DIFFERENCES[m]
            assert (want[m], have[m]) == (r, p) and why, m
        else:
            assert have[m] == want[m], m


def test_batch_skip_drops_without_salvaging(chaos_dir):
    sess = _salvage(_files(chaos_dir), errors="skip")
    assert not any(r.status == "salvaged" for r in sess.ingest_report.records)
    assert sess.labels() == ["clean"]


def test_batch_raise_mode_rejects_corrupt_dir(chaos_dir):
    with pytest.raises(IngestError):
        TraceSession.from_captures("chaos", _files(chaos_dir), MESH, max_workers=1)


def test_batch_pool_salvage_matches_serial_salvage(chaos_dir, monkeypatch):
    import concurrent.futures as cf

    class FakeFuture:
        def __init__(self, fn, *args):
            self._fn, self._args = fn, args

        def result(self, timeout=None):
            return self._fn(*self._args)

    class FakePool:
        def __init__(self, *a, **k):
            pass

        def submit(self, fn, *args):
            return FakeFuture(fn, *args)

        def shutdown(self, *a, **k):
            pass

    files = _files(chaos_dir)
    serial = _salvage(files)
    monkeypatch.setattr(cf, "ProcessPoolExecutor", FakePool)
    pooled = _salvage(files, max_workers=2)
    assert pooled.labels() == serial.labels()
    for lab in serial.labels():
        assert pooled.get(lab).store.identical(serial.get(lab).store)
    assert [r.to_dict() for r in pooled.ingest_report.records] == \
        [r.to_dict() for r in serial.ingest_report.records]


def test_batch_with_a_real_spawn_pool_matches_serial(chaos_dir):
    files = _files(chaos_dir)
    serial, pooled = _salvage(files), _salvage(files, max_workers=2)
    assert pooled.labels() == serial.labels()
    assert [r.to_dict() for r in pooled.ingest_report.records] == \
        [r.to_dict() for r in serial.ingest_report.records]


def test_pool_timeout_falls_back_serial_then_quarantines(monkeypatch):
    """A hung worker (every pool result times out) kills the pool; inputs
    retry serially — good ones ingest, bad ones are skipped."""
    import concurrent.futures as cf

    class HungFuture:
        def result(self, timeout=None):
            raise cf.TimeoutError()

    class HungPool:
        def __init__(self, *a, **k):
            self._probed = False

        def submit(self, fn, *args):
            if not self._probed:        # let the startup probe pass
                self._probed = True
                f = HungFuture()
                f.result = lambda timeout=None: fn(*args)
                return f
            return HungFuture()

        def shutdown(self, *a, **k):
            pass

    monkeypatch.setattr(cf, "ProcessPoolExecutor", HungPool)
    items = [("good", TEXT), ("bad", corrupt_capture(TEXT, "mangle_rg", seed=3))]
    sess = TraceSession.from_captures("s", items, MESH, max_workers=2, errors="skip",
                                      retries=0, retry_backoff_s=0, timeout_s=0.01)
    assert sess.labels() == ["good"]
    assert {r.source: r.status for r in sess.ingest_report.records} == \
        {"good": "ok", "bad": "skipped"}


# -- the watch daemon over the same chaos directory --------------------------

def drain(daemon, max_polls=40):
    for _ in range(max_polls):
        ready, pending = daemon.poll_once()
        if not ready and not pending:
            return
    raise AssertionError("directory never became quiescent")


def test_daemon_survives_chaos_dir_and_reports_everything(chaos_dir):
    d = WatchDaemon(WatchConfig(root=chaos_dir, mesh=MESH, settle_s=0.0, quiet=True,
                                max_retries=1, retry_backoff_s=0.0))
    drain(d)
    recs = {os.path.basename(p): r for p, r in d._records.items()}
    assert set(recs) == {os.path.basename(p) for p in _files(chaos_dir)}
    assert recs["clean.jsonl"]["status"] == "ok"
    assert d._traces[os.path.join(chaos_dir, "clean.jsonl")].store.identical(CLEAN.store)
    assert recs["corrupt_binary.jsonl"]["status"] == "quarantined"
    summ = d.summary()
    assert summ["ingest"]["quarantined"] == [os.path.join(chaos_dir, "corrupt_binary.jsonl")]
    for rec in summ["ingest"]["records"]:
        if rec["status"] != "ok":
            assert rec["error"]
    batch = _salvage(_files(chaos_dir))
    sess = d.session()
    assert sess.labels() == batch.labels()
    for lab in batch.labels():
        assert sess.get(lab).store.identical(batch.get(lab).store)
    assert [(r.label, r.status, r.salvage) for r in sess.ingest_report.records] == \
        [(r.label, r.status, r.salvage) for r in batch.ingest_report.records]


def test_daemon_raise_mode_still_crashes(chaos_dir):
    d = WatchDaemon(WatchConfig(root=chaos_dir, mesh=MESH, settle_s=0.0, quiet=True,
                                errors="raise"))
    with pytest.raises(Exception):
        drain(d)


# -- CLI: controlled exit codes over corrupt dumps ---------------------------

def test_cli_ingest_salvage_exit_codes(chaos_dir, tmp_path, capsys):
    out = str(tmp_path / "out" / "chaos.json")
    rc = _main(["ingest", out, *_files(chaos_dir), "--workers", "1", "--errors", "salvage",
                "--retries", "0", "--retry-backoff", "0", "--json"])
    assert rc == 3
    rep = json.loads(capsys.readouterr().out)
    assert {r["status"] for r in rep["records"]} == {"ok", "salvaged", "quarantined"}
    loaded = TraceSession.load(out)
    assert loaded.ingest_report is not None
    assert [r["source"] for r in loaded.ingest_report.to_dict()["records"]] == \
        _files(chaos_dir)


def test_cli_watch_once_survives_chaos(chaos_dir, tmp_path, capsys):
    summary = str(tmp_path / "summary.json")
    rc = _main(["watch", chaos_dir, "--once", "--settle", "0", "--interval", "0.01",
                "--retry-backoff", "0", "--summary", summary, "--quiet",
                "--fail-on", "critical"])
    capsys.readouterr()
    assert rc in (1, 3)
    summ = json.load(open(summary))
    assert summ["ingest"]["quarantined"], "binary file must be quarantined"
