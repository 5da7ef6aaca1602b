"""The watch daemon in the port (`core/watch.py`, `session watch`) against the
reference's (`tests/test_watch.py`, one counterpart a case), over capture
dumps where the reference tails HLO dumps; and the streaming
`commcheck.CommcheckState` its per-file lint folds through.

The live-profiling contract: `session watch --once` over a dump directory —
including one that grows mid-run — writes the same session and report
bytes a batch `session ingest` + `session report` over the final directory
writes, while its rolling aggregates stay equal to full recomputation.  A
reference daemon over an HLO directory and a port daemon over the capture
dumps of the same traces, grown in the same schedule, agree on their
summaries.  Polls are driven with `poll_once(now=...)`; the only waits are
the settle windows the reference's tests use.
"""
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _hypothesis_compat import given, settings, strategies as st
from repro.core import commcheck as jcommcheck
from repro.core import session as jsession
from repro.core import synth as jsynth
from repro.core import watch as jwatch
from repro.core.topology import MeshSpec as JMesh
from repro_torch.core import attribution, commcheck, costmodel, dump, synth
from repro_torch.core.events import CollectiveEvent, Trace
from repro_torch.core.session import TraceSession, _main
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import H100, MeshSpec
from repro_torch.core.watch import DirWatcher, WatchConfig, WatchDaemon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = MeshSpec((2, 4), ("data", "model"))


def mk_daemon(root, **kw):
    kw.setdefault("settle_s", 0.0)
    kw.setdefault("quiet", True)
    return WatchDaemon(WatchConfig(root=str(root), mesh=MESH, **kw))


def drain(daemon, max_polls=10):
    """Poll until a round ingests nothing and nothing is pending."""
    for _ in range(max_polls):
        ready, pending = daemon.poll_once()
        if not ready and not pending:
            return
    raise AssertionError("directory never became quiescent")


def batch_session(root):
    paths = sorted(glob.glob(os.path.join(str(root), "*.jsonl")))
    return TraceSession.from_captures(os.path.basename(str(root)), paths, MESH,
                                      max_workers=1)


# -- DirWatcher: stability + settle + re-ingest (reference :47-101) ----------

def test_watcher_needs_two_stable_polls(tmp_path):
    w = DirWatcher(str(tmp_path), settle_s=0.0)
    (tmp_path / "a.jsonl").write_text("x")
    ready, pending = w.poll()
    assert ready == [] and pending == 1        # first sighting: not ready
    ready, pending = w.poll()
    assert [os.path.basename(p) for p in ready] == ["a.jsonl"]
    w.mark_ingested(ready[0])
    assert w.poll() == ([], 0)                 # ingested: quiescent


def test_watcher_holds_while_file_is_growing(tmp_path):
    w = DirWatcher(str(tmp_path), settle_s=0.0)
    p = tmp_path / "a.jsonl"
    p.write_text("x")
    w.poll()
    p.write_text("xy")                         # signature moved between polls
    ready, pending = w.poll()
    assert ready == [] and pending == 1
    ready, _ = w.poll()
    assert len(ready) == 1


def test_watcher_settle_delay_blocks_fresh_files(tmp_path):
    w = DirWatcher(str(tmp_path), settle_s=3600.0)
    (tmp_path / "a.jsonl").write_text("x")
    w.poll()
    ready, pending = w.poll()
    assert ready == [] and pending == 1        # stable but too young


def test_watcher_reingests_changed_files(tmp_path):
    w = DirWatcher(str(tmp_path), settle_s=0.0)
    p = tmp_path / "a.jsonl"
    p.write_text("x")
    w.poll()
    ready, _ = w.poll()
    w.mark_ingested(ready[0])
    p.write_text("different content")          # new size => new signature
    w.poll()
    ready, _ = w.poll()
    assert len(ready) == 1                     # changed after ingest: redo


def test_watcher_respects_pattern(tmp_path):
    """The port's default pattern is `*.jsonl`: HLO text beside it is not
    offered."""
    w = DirWatcher(str(tmp_path), settle_s=0.0)
    (tmp_path / "a.txt").write_text("x")
    (tmp_path / "b.jsonl").write_text("y")
    w.poll()
    ready, pending = w.poll()
    assert [os.path.basename(p) for p in ready] == ["b.jsonl"]
    assert pending == 0
    assert WatchConfig(root="r", mesh=MESH).pattern == "*.jsonl"
    assert WatchConfig(root="r", mesh=MESH).hw is H100


def test_watcher_clamps_future_mtime(tmp_path):
    """Clock skew: a file touched into the future still settles, judged on
    signature stability with the settle clock clamped to the first poll
    that saw the signature."""
    p = tmp_path / "skewed.jsonl"
    p.write_text("x")
    t0 = time.time()
    os.utime(str(p), (t0 + 1e6, t0 + 1e6))
    w = DirWatcher(str(tmp_path), settle_s=10.0)
    assert w.poll(now=t0) == ([], 1)
    ready, pending = w.poll(now=t0 + 5)
    assert ready == [] and pending == 1
    ready, _ = w.poll(now=t0 + 11)
    assert [os.path.basename(x) for x in ready] == ["skewed.jsonl"]


def test_watcher_future_mtime_does_not_settle_early(tmp_path):
    p = tmp_path / "skewed.jsonl"
    p.write_text("x")
    t0 = time.time()
    os.utime(str(p), (t0 + 1e6, t0 + 1e6))
    w = DirWatcher(str(tmp_path), settle_s=10.0)
    w.poll(now=t0)
    assert w.poll(now=t0 + 1) == ([], 1)
    ready, _ = w.poll(now=t0 + 12)
    assert len(ready) == 1


# -- daemon: incremental ingest == batch over the final directory ------------

def test_daemon_matches_batch_after_midrun_growth(tmp_path):
    synth.write_capture_dump(str(tmp_path), n_files=2, sites_per_file=120, seed=3)
    d = mk_daemon(tmp_path)
    drain(d)
    assert len(d._traces) == 2
    synth.write_capture_dump(str(tmp_path), n_files=1, sites_per_file=120, seed=3, start=2)
    drain(d)
    assert len(d._traces) == 3
    ref = batch_session(tmp_path)
    sess = d.session()
    assert sess.labels() == ref.labels()
    for fmt in ("json", "html"):
        assert sess.report(fmt=fmt) == ref.report(fmt=fmt)
    for a, b in zip(sess, ref):
        assert a.store.identical(b.store)
    assert d.rolling.n == sum(t.store.n for t in ref)
    batch_roll = {}
    for t in ref:
        for k, v in t.by_kind_and_link().items():
            acc = batch_roll.setdefault(k, dict.fromkeys(v, 0.0))
            for f in v:
                acc[f] += v[f]
    inc = d.rollups["kind_link"].as_dict()
    assert set(inc) == set(batch_roll)
    for k in inc:
        for f in ("bytes", "wire_bytes", "count", "time_s"):
            assert inc[k][f] == pytest.approx(batch_roll[k][f], rel=1e-9)


def test_daemon_rebuilds_on_changed_file(tmp_path):
    paths = synth.write_capture_dump(str(tmp_path), n_files=2, sites_per_file=80, seed=5)
    d = mk_daemon(tmp_path)
    drain(d)
    n_before = d.rolling.n
    with open(paths[0], "w") as f:
        f.write(synth.synthetic_capture(160, seed=99))
    drain(d)
    assert len(d._traces) == 2
    ref = batch_session(tmp_path)
    assert d.rolling.n == sum(t.store.n for t in ref) != n_before
    assert d.session().report(fmt="json") == ref.report(fmt="json")


def test_daemon_summary_and_emit_atomic(tmp_path):
    root = tmp_path / "dump"
    synth.write_capture_dump(str(root), n_files=2, sites_per_file=60, seed=1)
    out = tmp_path / "out"
    out.mkdir()
    d = mk_daemon(root, out=str(out / "sess.json"), report_json=str(out / "report.json"),
                  report_html=str(out / "report.html"), summary=str(out / "summary.json"))
    drain(d)
    d.emit()
    s = json.loads((out / "summary.json").read_text())
    assert s["files"] == 2 and s["sites"] == d.rolling.n
    assert set(s["by_kind_link"]) == set(d.rollups["kind_link"].as_dict())
    loaded = TraceSession.load(str(out / "sess.json"))
    assert loaded.labels() == d.session().labels()
    assert loaded.ingest_report.to_dict() == d.ingest_report().to_dict()
    assert (out / "report.json").read_text() == d.session().report(fmt="json") + "\n"
    assert (out / "report.html").read_text() == d.session().report(fmt="html") + "\n"
    assert not [p for p in os.listdir(out) if p.endswith(".tmp")]


def test_watch_once_equals_ingest_and_report(tmp_path, capsys):
    """The equivalence contract, through the CLI: `watch --once` writes the
    report bytes `ingest` + `report` write over the final directory."""
    root = tmp_path / "dump"
    files = synth.write_capture_dump(str(root), n_files=3, sites_per_file=70, seed=7)
    rc = _main(["watch", str(root), "--once", "--quiet", "--settle", "0", "--interval",
                "0.01", "--report-json", str(tmp_path / "w.json"),
                "--report-html", str(tmp_path / "w.html"), "--out", str(tmp_path / "w.npz")])
    assert rc == 0
    assert _main(["ingest", str(tmp_path / "b.npz"), *files]) == 0
    for fmt in ("json", "html"):
        assert _main(["report", str(tmp_path / "b.npz"), "--format", fmt,
                      "--out", str(tmp_path / f"b.{fmt}")]) == 0
        assert (tmp_path / f"w.{fmt}").read_bytes() == (tmp_path / f"b.{fmt}").read_bytes()
    capsys.readouterr()


def test_watch_cli_once_with_midrun_writer(tmp_path, capsys):
    root = tmp_path / "dump"
    synth.write_capture_dump(str(root), n_files=2, sites_per_file=70, seed=11)
    report = str(tmp_path / "rolling_report.json")

    def late_writer():
        time.sleep(0.15)
        synth.write_capture_dump(str(root), n_files=1, sites_per_file=70, seed=11, start=2)

    t = threading.Thread(target=late_writer)
    t.start()
    try:
        # settle 0.4s > writer delay: the pre-existing files are still
        # settling when the third lands, so quiescence cannot precede it
        rc = _main(["watch", str(root), "--once", "--quiet", "--settle", "0.4",
                    "--interval", "0.05", "--report-json", report])
    finally:
        t.join()
    assert rc == 0
    ref = batch_session(root)
    assert len(ref) == 3
    with open(report) as f:
        assert f.read() == ref.report(fmt="json") + "\n"


def _collision_trace():
    """Two collectives of different kinds on one channel over all 8 devices:
    the critical `channel_collision` (the reference test's HLO module)."""
    groups = [list(range(8))]
    events = [CollectiveEvent(name="%ar", kind="all-reduce", async_start=False,
                              operand_bytes=32, result_bytes=32, dtype="f32",
                              replica_groups=groups, group_size=8, num_groups=1,
                              op_name="step/ar", computation="main", channel_id=1),
              CollectiveEvent(name="%ag", kind="all-gather", async_start=False,
                              operand_bytes=256, result_bytes=256, dtype="f32",
                              replica_groups=groups, group_size=8, num_groups=1,
                              op_name="step/ag", computation="main", channel_id=1)]
    for ev in events:
        costmodel.annotate_event(ev, MESH, H100)
    attribution.attribute_all(events)
    return Trace("bug", MESH.shape, MESH.axes, MESH.num_devices, events=events)


def test_watch_cli_fail_on_alerts(tmp_path, capsys):
    root = tmp_path / "dump"
    root.mkdir()
    dump.write_capture(_collision_trace(), str(root / "bug.jsonl"))
    rc = _main(["watch", str(root), "--once", "--quiet", "--settle", "0",
                "--interval", "0.01", "--fail-on", "critical"])
    captured = capsys.readouterr()
    assert rc == 1
    assert "channel_collision" in captured.err
    assert _main(["watch", str(root), "--once", "--quiet", "--settle", "0",
                  "--interval", "0.01"]) == 0


def test_watch_cli_rejects_missing_dir_and_bad_mesh(tmp_path, capsys):
    assert _main(["watch", str(tmp_path / "nope"), "--once"]) == 2
    assert "no such directory" in capsys.readouterr().err
    assert _main(["watch", str(tmp_path), "--once", "--mesh", "8"]) == 2
    assert "same rank" in capsys.readouterr().err


# -- fault tolerance: quarantine, backoff, crash-resume ----------------------

def test_daemon_quarantines_bad_file_then_recovers_on_change(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_bytes(b"\xff\xfe not utf-8 \xff")
    d = mk_daemon(tmp_path, max_retries=2, retry_backoff_s=0.0)
    drain(d)
    rec = d._records[str(bad)]
    assert rec["status"] == "quarantined" and rec["error"]
    assert str(bad) in d._quarantine
    assert d.session().labels() == []
    assert d.degraded() == [str(bad)]
    bad.write_text(synth.synthetic_capture(40, seed=8))
    drain(d)
    assert d._records[str(bad)]["status"] == "ok"
    assert str(bad) not in d._quarantine
    assert d.session().labels() == ["bad"]


def test_daemon_quarantines_a_capture_of_another_mesh(tmp_path):
    (tmp_path / "other.jsonl").write_text(
        synth.synthetic_capture(20, seed=1, mesh=MeshSpec((8,), ("data",))))
    d = mk_daemon(tmp_path, max_retries=1, retry_backoff_s=0.0)
    drain(d)
    rec = d._records[str(tmp_path / "other.jsonl")]
    assert rec["status"] == "quarantined" and "is not the mesh given" in rec["error"]


def test_daemon_quarantine_backoff_gates_same_signature_retries(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_bytes(b"\xff\xfe not utf-8 \xff")
    d = mk_daemon(tmp_path, max_retries=3, retry_backoff_s=1e6)
    now = time.time()
    d.poll_once(now=now)
    d.poll_once(now=now + 1)       # first attempt fails -> quarantined, huge backoff
    assert d._quarantine[str(bad)]["failures"] == 1
    for k in range(3):
        ingested, pending = d.poll_once(now=now + 2 + k)
        assert ingested == [] and pending >= 1     # gated, not retried
    assert d._quarantine[str(bad)]["failures"] == 1
    ingested, _ = d.poll_once(now=now + 2e6)       # backoff elapsed: retried
    assert d._quarantine[str(bad)]["failures"] == 2


def test_daemon_checkpoint_resume_reparses_nothing(tmp_path):
    root = tmp_path / "dump"
    synth.write_capture_dump(str(root), n_files=3, sites_per_file=90, seed=21)
    ckpt = str(tmp_path / "watch.npz")
    d1 = mk_daemon(root, checkpoint=ckpt)
    drain(d1)
    assert d1.parse_count == 3 and os.path.exists(ckpt)
    report1 = d1.session().report(fmt="json")

    d2 = mk_daemon(root, checkpoint=ckpt)
    drain(d2)
    assert d2.parse_count == 0                     # zero re-reads
    assert d2.rounds >= d1.rounds
    sess1, sess2 = d1.session(), d2.session()
    assert sess2.labels() == sess1.labels()
    for a, b in zip(sess1, sess2):
        assert a.store.identical(b.store)
    assert sess2.report(fmt="json") == report1
    assert [f.to_dict() for f in d2.findings()] == [f.to_dict() for f in d1.findings()]

    synth.write_capture_dump(str(root), n_files=1, sites_per_file=90, seed=21, start=3)
    drain(d2)
    assert d2.parse_count == 1
    assert d2.session().report(fmt="json") == batch_session(root).report(fmt="json")


def test_daemon_checkpoint_survives_quarantine_state(tmp_path):
    root = tmp_path / "dump"
    synth.write_capture_dump(str(root), n_files=1, sites_per_file=60, seed=2)
    (root / "bad.jsonl").write_bytes(b"\xff\xfe nope \xff")
    ckpt = str(tmp_path / "watch.npz")
    d1 = mk_daemon(root, checkpoint=ckpt, max_retries=1, retry_backoff_s=0.0)
    drain(d1)
    assert d1._records[str(root / "bad.jsonl")]["status"] == "quarantined"
    d2 = mk_daemon(root, checkpoint=ckpt, max_retries=1, retry_backoff_s=0.0)
    drain(d2)
    assert d2.parse_count == 0
    assert d2._records[str(root / "bad.jsonl")]["status"] == "quarantined"
    assert d2.summary()["ingest"]["quarantined"] == [str(root / "bad.jsonl")]


def test_daemon_ignores_unusable_checkpoint(tmp_path):
    import numpy as np
    root = tmp_path / "dump"
    synth.write_capture_dump(str(root), n_files=1, sites_per_file=50, seed=4)
    ckpt = tmp_path / "watch.npz"
    ckpt.write_text("not an npz at all")
    d = mk_daemon(root, checkpoint=str(ckpt))
    drain(d)
    assert d.parse_count == 1
    with np.load(str(ckpt)) as arrs:
        assert "watch" in arrs


def test_daemon_sigkill_resume_matches_batch(tmp_path):
    """SIGKILL the daemon mid-run, restart it on the same checkpoint and drain
    with --once: the report equals batch ingest + report, and the resumed
    process reads only the file that landed after the kill."""
    root = tmp_path / "dump"
    synth.write_capture_dump(str(root), n_files=2, sites_per_file=80, seed=31)
    ckpt = str(tmp_path / "watch.npz")
    summary = str(tmp_path / "summary.json")
    report = str(tmp_path / "report.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.session", "watch", str(root),
         "--settle", "0", "--interval", "0.05", "--quiet",
         "--checkpoint", ckpt, "--summary", summary],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if os.path.exists(summary):
                try:
                    s = json.load(open(summary))
                except ValueError:
                    s = {}
                if s.get("files") == 2 and os.path.exists(ckpt):
                    break
            time.sleep(0.05)
        else:
            raise AssertionError("daemon never ingested the seed files")
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    synth.write_capture_dump(str(root), n_files=1, sites_per_file=80, seed=31, start=2)
    rc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.session", "watch", str(root),
         "--once", "--settle", "0", "--interval", "0.05", "--quiet",
         "--checkpoint", ckpt, "--summary", summary,
         "--report-json", report, "--fail-on", "critical"], env=env).returncode
    assert rc == 0
    s = json.load(open(summary))
    assert s["files"] == 3 and s["ingest"]["parse_count"] == 1
    with open(report) as f:
        assert f.read() == batch_session(root).report(fmt="json") + "\n"


# -- the reference's daemon and the port's, over the same traces -------------

def test_the_two_daemons_agree_over_the_same_traces_grown_alike(tmp_path):
    """A reference daemon over its HLO dump and a port daemon over the
    capture dumps of the traces the reference parses from it, grown in the
    same schedule (2 files, then a third): the same files, sites and
    rollups by (kind, link) and by semantic after each drain."""
    hlo, cap = tmp_path / "hlo", tmp_path / "cap"
    cap.mkdir()
    jmesh = JMesh((2, 4), ("data", "model"))

    def grow(start, n):
        files = jsynth.write_hlo_dump(str(hlo), n_files=n, sites_per_file=100, seed=13,
                                      start=start)
        ref = jsession.TraceSession.from_hlo("x", files, jmesh, max_workers=1)
        path = ref.save(str(tmp_path / f"r{start}.npz"))
        for t in TraceSession.load(path):
            dump.write_capture(t, str(cap / f"{t.label}.jsonl"), mesh=MESH)

    jd = jwatch.WatchDaemon(jwatch.WatchConfig(root=str(hlo), mesh=jmesh, settle_s=0.0,
                                               quiet=True))
    pd = mk_daemon(cap)
    for start, n in ((0, 2), (2, 1)):
        grow(start, n)
        drain(jd)
        drain(pd)
        js, ps = jd.summary(), pd.summary()
        for key in ("files", "sites", "by_kind_link", "by_semantic"):
            assert ps[key] == js[key], key
        assert ps["files"] == start + n


# -- CommcheckState: the streaming lint (reference tests/test_append.py) -----

def finding_key(f):
    return (f.detector, f.severity, f.site, f.message)


@given(seed=st.integers(0, 200))
@settings(max_examples=6, deadline=None)
def test_commcheck_state_matches_batch_on_buggy_traces(seed):
    trace, _labels = synth.inject_comm_bugs(MESH, n_sites=120, seed=seed)
    batch = commcheck.check_trace(trace, MESH)
    st_ = commcheck.CommcheckState(MESH)
    evs = trace.events
    step = (len(evs) + 4) // 5
    for i in range(0, len(evs), step):
        st_.update(TraceStore.from_events(evs[i:i + step]))
    assert list(map(finding_key, st_.findings())) == list(map(finding_key, batch))


@pytest.mark.parametrize("seed", [0, 7])
def test_commcheck_state_equals_the_reference_s_on_the_same_chunks(seed, tmp_path):
    """The reference's labelled-bug trace, saved, loaded by the port and fed
    in the same 4 chunks to both packages' `CommcheckState`: the same
    findings, field for field (the stored annotation prices the risk), and
    the port's equal to its batch `check_trace` over the whole."""
    jtr, _ = jsynth.inject_comm_bugs(n_sites=120, seed=seed)
    path = jsession.TraceSession("b", [jtr]).save(str(tmp_path / "b.json"))
    ptr = list(TraceSession.load(path))[0]
    jstate = jcommcheck.CommcheckState(JMesh((2, 4), ("data", "model")))
    pstate = commcheck.CommcheckState(MESH)
    rows = np.arange(ptr.store.n)
    for chunk in np.array_split(rows, 4):
        mask = np.isin(rows, chunk)
        jstate.update(jtr.store.where(mask))
        pstate.update(ptr.store.where(mask))
    got = pstate.findings()
    assert got and [f.to_dict() for f in got] == [f.to_dict() for f in jstate.findings()]
    assert list(map(finding_key, got)) == \
        list(map(finding_key, commcheck.check_trace(ptr, MESH)))


def test_commcheck_state_on_a_chunked_capture_equals_batch():
    tr = dump.trace_from_capture(synth.synthetic_capture(400, seed=9), MESH)
    batch = commcheck.check_trace(tr, MESH)
    st_ = commcheck.CommcheckState(MESH)
    rows = tr.store.rows()
    for i in range(0, len(rows), 130):
        st_.update(TraceStore.from_events(rows[i:i + 130]))
    assert list(map(finding_key, st_.findings())) == list(map(finding_key, batch))
