"""The profiler's back half in the port (`repro_torch.core`: persist, diff,
report, session, whatif, detect, commcheck, synth) against the reference's.

The analysis modules are copies that read the port's H100 model where the
reference reads the TPU's, so on the same stored trace they must give the
same texts: a session saved by either package is loaded by the other and
every reading is compared byte for byte.  Where a reading depends on the
hardware (a trace priced anew, the what-if tiers, the link names), the test
says so and compares what the hardware does not change.
"""
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.core import commcheck as jcommcheck
from repro.core import detect as jdetect
from repro.core import persist as jpersist
from repro.core import report as jreport
from repro.core import session as jsession
from repro.core import synth as jsynth
from repro.core import whatif as jwhatif
from repro.core.topology import MeshSpec as JMesh
from repro.core.topology import V5E
from repro_torch.core import commcheck, detect, persist, report, session, synth, whatif
from repro_torch.core.topology import H100, MeshSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = ("json", "npz", "npz-mmap")


def _nvlink(link: str) -> str:
    """A reference link class read on the port's hardware names."""
    return (link.replace("ici.", "nvlink.").replace("dci.", "ib.")
            .replace("xpod.mixed", "xnode.mixed"))


def _save(sess, d, fmt):
    path = os.path.join(d, f"{sess.name}.{fmt.split('-')[0]}")
    return sess.save(path, compress=fmt != "npz-mmap")


def _load(cls, path, fmt):
    return cls.load(path, mmap=fmt == "npz-mmap")


@pytest.fixture(scope="module")
def ref_session():
    """A reference session: its demo sweep, its labelled-bug trace and its
    misconfigured-mesh trace (priced on its TPU model)."""
    sess = jsession.demo_session(n_sites=300, seed=1)
    sess.add(jsynth.inject_comm_bugs(n_sites=48, seed=2)[0])
    sess.add(jsynth.misconfigured_trace(n_sites=120)[0])
    return sess


@pytest.fixture(scope="module")
def port_session():
    """The same built by the port (priced on the H100 model)."""
    sess = session.demo_session(n_sites=300, seed=1)
    sess.add(synth.inject_comm_bugs(n_sites=48, seed=2)[0])
    sess.add(synth.misconfigured_trace(n_sites=120)[0])
    return sess


def _readings(core_session, core_report, sess):
    """Every text and number a user reads off a session."""
    labels = sess.labels()
    out = {"labels": labels, "totals": sess.totals()}
    for by in ("kind_link", "semantic", "site"):
        for metric in ("bytes", "time", "count"):
            out[f"table {by} {metric}"] = sess.table(by=by, metric=metric)
        out[f"diff {by}"] = sess.diff(labels[0], labels[1], by=by)
        out[f"diff {by} json"] = sess.diff(labels[1], labels[2], by=by, top=5,
                                           only_regressed=True, as_json=True)
    for kind in ("all-reduce*", "all-gather"):
        sel = sess.select(kind=kind)
        out[f"select {kind}"] = (sel.labels(), sel.totals())
        out[f"query {kind}"] = sess.query(kind=kind, by="semantic")
    out["query op"] = sess.query(op="*attn*", by="site")
    for t in sess:
        out[f"{t.label} summary"] = core_report.summary(t)
        out[f"{t.label} contenders"] = core_report.top_contenders_table(t)
        out[f"{t.label} semantic"] = core_report.semantic_table(t)
        out[f"{t.label} timeline"] = core_report.timeline(t)
        out[f"{t.label} json"] = sess.report(t.label, fmt="json")
        out[f"{t.label} html"] = sess.report(t.label, fmt="html")
        buf = io.StringIO()
        sess.report(t.label, fmt="json", fp=buf, stream=True, chunk_sites=7)
        out[f"{t.label} json streamed"] = buf.getvalue()
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_reference_session_reads_the_same_in_the_port(ref_session, tmp_path, fmt):
    """Saved by the reference, loaded by the port: totals, n-way tables, diffs
    (text and JSON), select/query, and per trace the summary, top-contenders
    and semantic tables, timeline, JSON (with the commcheck findings, whole
    and streamed) and HTML reports, byte for byte.  The stored annotation is
    read, not recomputed, so the TPU prices and `ici.` link names stand."""
    path = _save(ref_session, str(tmp_path), fmt)
    want = _readings(jsession, jreport, _load(jsession.TraceSession, path, fmt))
    got = _readings(session, report, _load(session.TraceSession, path, fmt))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_port_session_reads_the_same_in_the_reference(port_session, tmp_path, fmt):
    """Saved by the port (H100 prices, `nvlink.`/`ib.` links), loaded by the
    reference: the same readings, byte for byte; and the port's reload of its
    own file reads as the session it saved."""
    path = _save(port_session, str(tmp_path), fmt)
    want = _readings(session, report, port_session)
    got = _readings(jsession, jreport, _load(jsession.TraceSession, path, fmt))
    again = _readings(session, report, _load(session.TraceSession, path, fmt))
    for key in want:
        assert got[key] == want[key], key
        assert again[key] == want[key], key


def test_session_files_are_the_same_bytes_in_both_packages(ref_session, tmp_path):
    """A reference session re-saved by the port, in each format, is the file
    the reference saved (the format is kept, column for column)."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    for fmt in FORMATS:
        a = _save(ref_session, str(tmp_path / "a"), fmt)
        b = _save(_load(session.TraceSession, a, fmt), str(tmp_path / "b"), fmt)
        assert open(a, "rb").read() == open(b, "rb").read(), fmt


def test_ingest_provenance_survives_the_port(ref_session, tmp_path):
    """A reference session's `ingest_report` (written by its HLO ingest) is
    kept through the port's load and save, and `query` reports it."""
    sess = jsession.TraceSession("fleet", list(ref_session)[:2])
    sess.ingest_report = jsession.IngestReport("skip", [
        jsession.IngestRecord("host003_step001.txt", "host003_step001", "skipped",
                              2, error="ValueError: bad"),
        jsession.IngestRecord("host004_step001.txt", "host004_step001")])
    path = sess.save(str(tmp_path / "fleet.json"))
    loaded = session.TraceSession.load(path)
    assert loaded.ingest_report.to_dict() == sess.ingest_report.to_dict()
    assert loaded.query()["ingest"] == sess.query()["ingest"] == {
        "records": 2, "degraded": 1, "degraded_hosts": ["003"]}
    again = loaded.save(str(tmp_path / "again.json"))
    assert jsession.TraceSession.load(again).ingest_report.to_dict() == \
        sess.ingest_report.to_dict()


# --------------------------------------------------------------------------
# persist
# --------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((64, 3)), "codes": rng.integers(0, 9, 500).astype(np.int32),
            "empty": np.zeros(0, np.int64), "names": np.array(["x", "yy", "zzz"]),
            "meta": np.array(json.dumps({"k": [1, 2]}))}


@pytest.mark.parametrize("compress", [True, False])
def test_write_npz_is_the_same_bytes_and_each_package_reads_the_other(tmp_path, compress):
    """The same arrays give the same deterministic `write_npz` bytes in both
    packages; `np.load` and each package's `open_npz_mmap` (uncompressed
    archives) read the other's file."""
    arrs = _arrays()
    paths = {}
    for name, mod in (("ref", jpersist), ("port", persist)):
        paths[name] = str(tmp_path / f"{name}.npz")
        with mod.atomic_open(paths[name], "wb") as f:
            mod.write_npz(f, arrs, compress=compress, workers=2)
    assert open(paths["ref"], "rb").read() == open(paths["port"], "rb").read()
    for reader, path in ((persist, paths["ref"]), (jpersist, paths["port"])):
        with np.load(path) as got:
            for k, v in arrs.items():
                np.testing.assert_array_equal(got[k], v)
        if not compress:
            got = reader.open_npz_mmap(path)
            for k, v in arrs.items():
                np.testing.assert_array_equal(np.asarray(got[k]), v)


# --------------------------------------------------------------------------
# synth
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((8,), ("data",)), ((2, 4), ("data", "model")),
                                        ((2, 8), ("pod", "data"))])
def test_synthetic_trace_is_the_reference_workload(shape, axes):
    """For one seed, the port's synthetic trace has the reference's sites:
    kinds, replica groups, operand bytes, multiplicity, op names and
    semantics.  Only the link names (the port's `nvlink`/`ib`) and the
    prices (the H100's) differ."""
    j = jsynth.synthetic_trace("s", JMesh(shape, axes), V5E, n_sites=150, seed=5)
    p = synth.synthetic_trace("s", MeshSpec(shape, axes), H100, n_sites=150, seed=5)
    fields = ("name", "kind", "replica_groups", "operand_bytes", "multiplicity", "op_name",
              "semantic", "channel_id", "async_start", "axes", "wire_bytes_per_device",
              "protocol")
    for je, pe in zip(j.events, p.events, strict=True):
        assert [getattr(pe, f) for f in fields] == [getattr(je, f) for f in fields]
        kind = MeshSpec(shape, axes).axis_kind
        assert pe.link_class == _nvlink(je.link_class).replace(
            "nvlink.pod", f"{kind.get('pod', 'nvlink')}.pod")
    assert p.total_est_time_s() != j.total_est_time_s()


# --------------------------------------------------------------------------
# commcheck
# --------------------------------------------------------------------------

def test_commcheck_on_the_reference_bug_trace_finds_what_the_reference_finds(tmp_path):
    """The reference's labelled-bug trace, loaded into the port: the port's
    findings are the reference's, field for field (the stored annotation is
    read, so even the risk times agree), and every injected bug is found."""
    jtr, labels = jsynth.inject_comm_bugs(n_sites=48, seed=2)
    path = jsession.TraceSession("bugs", [jtr]).save(str(tmp_path / "bugs.json"))
    ptr = list(session.TraceSession.load(path))[0]
    got = [f.to_dict() for f in commcheck.check_trace(ptr)]
    assert got == [f.to_dict() for f in jcommcheck.check_trace(jtr)]
    assert set(labels.values()) <= {f["analyzer"] for f in got}
    assert commcheck.findings_json(commcheck.check_trace(ptr)) == got


def test_commcheck_on_the_port_bug_trace_differs_only_by_hardware():
    """The port's own labelled-bug trace (priced on the H100): the same kinds
    and severities on the same sites, the same wire bytes at risk; only the
    risk times (and the recommendations that quote them) differ."""
    jf = jcommcheck.check_trace(jsynth.inject_comm_bugs(n_sites=48, seed=2)[0])
    pf = commcheck.check_trace(synth.inject_comm_bugs(n_sites=48, seed=2)[0])
    key = lambda f: (f.detector, f.severity, f.site, f.message, f.wasted_bytes)  # noqa: E731
    assert sorted(map(key, pf)) == sorted(map(key, jf))
    assert [f.time_at_risk_s for f in pf] != [f.time_at_risk_s for f in jf]


# --------------------------------------------------------------------------
# detect
# --------------------------------------------------------------------------

def test_detectors_fire_as_the_reference_does_on_the_misconfigured_mesh():
    """`misconfigured_trace` in both packages: the same detector kinds fire on
    the same rows, with `cross_pod_bulk` (the reference's DCI) read as
    `cross_node_bulk` (InfiniBand), and the same messages but for the link
    names and the saving, which is the H100's `ib_saving`."""
    jtr, _jm, _ = jsynth.misconfigured_trace()
    ptr, pm, _ = synth.misconfigured_trace()
    jf, pf = jdetect.run_all(jtr), detect.run_all(ptr)
    rename = {"cross_pod_bulk": "cross_node_bulk"}
    assert [(rename.get(f.detector, f.detector), f.severity, f.site, f.wasted_bytes)
            for f in jf] == [(f.detector, f.severity, f.site, f.wasted_bytes) for f in pf]
    assert "cross_node_bulk" in {f.detector for f in pf}
    xnode = next(f for f in pf if f.detector == "cross_node_bulk")
    assert xnode.est_saved_s == whatif.ib_saving(ptr.store, pm, H100) > 0
    expected = {"grad_sync": "data"}
    assert [f.to_dict()["site"] for f in detect.run_all(ptr, expected)] == \
        [f.to_dict()["site"] for f in jdetect.run_all(jtr, expected)]


def test_ib_saving_is_the_ib_rows_share():
    """`ib_saving` re-prices every axis as NVLink: the drop comes from the
    rows on `ib.`/`xnode.` links only, each one's weighted time less its
    NVLink price, and rows already on NVLink price the same."""
    mesh = MeshSpec((2, 8), ("pod", "data"))
    s = synth.synthetic_trace("t", mesh, n_sites=200, seed=8).store
    alt = whatif.reannotate(s, whatif.Scenario("nv", axis_kind={a: "nvlink" for a in mesh.axes}),
                            mesh, H100)
    ib = s.link_class.mask_prefix(detect.CROSS_NODE)
    assert ib.any() and (~ib).any()
    np.testing.assert_array_equal(alt.est_time_s[~ib], s.est_time_s[~ib])
    share = float(((s.est_time_s - alt.est_time_s) * s.weights)[ib].sum())
    assert whatif.ib_saving(s, mesh, H100) == pytest.approx(share, rel=1e-12)
    assert share < float((s.est_time_s * s.weights)[ib].sum())


def test_streaming_detectors_equal_the_batch_pass():
    """`DetectorState` over chunks gives `run_all`'s findings (ties of equal
    severity and bytes may order differently, as in the reference)."""
    tr, _, _ = synth.misconfigured_trace()
    st = detect.DetectorState()
    n = tr.store.n
    for lo in range(0, n, 50):
        part = type(tr).from_store(tr.label, tr.mesh_shape, tr.mesh_axes, tr.num_devices,
                                   tr.store.where((np.arange(n) >= lo) & (np.arange(n) < lo + 50)))
        st.update(part)
    batch, stream = detect.run_all(tr), st.findings()
    key = lambda f: (f.detector, f.message)  # noqa: E731
    assert sorted(map(key, stream)) == sorted(map(key, batch))
    np.testing.assert_allclose([f.est_saved_s for f in sorted(stream, key=key)],
                               [f.est_saved_s for f in sorted(batch, key=key)], rtol=1e-9)


def test_layout_thrash_reads_the_reference_op_stats_and_is_silent_on_captures():
    """Layout thrash reads `HloOpStats.transpose_bytes`: it fires on a trace
    that carries them (the reference's) and is silent on a captured one."""
    tr = synth.synthetic_trace("t", MeshSpec((2, 4), ("data", "model")), n_sites=20)
    assert detect.detect_layout_thrash(tr) == []
    tr.op_stats.transpose_bytes, tr.op_stats.n_transpose = 3e9, 7
    (f,) = detect.detect_layout_thrash(tr)
    assert f.detector == "layout_thrash" and f.est_saved_s == 3e9 / H100.hbm_bw


# --------------------------------------------------------------------------
# whatif
# --------------------------------------------------------------------------

_ANNOTATION = ("wire_bytes_per_device", "est_time_s")


def test_identity_scenario_reproduces_the_annotation():
    tr = synth.synthetic_trace("t", MeshSpec((2, 4), ("data", "model")), n_sites=200, seed=3)
    alt = whatif.reannotate(tr.store, whatif.IDENTITY, MeshSpec((2, 4), ("data", "model")), H100)
    for col in _ANNOTATION:
        np.testing.assert_array_equal(getattr(alt, col), getattr(tr.store, col))
    for col in ("link_class", "protocol"):
        assert getattr(alt, col).values() == getattr(tr.store, col).values()
    assert alt.axes_tables == tr.store.axes_tables


@pytest.mark.parametrize("kinds,names", [
    ({"data": "nvlink", "model": "nvlink"},
     ["mesh:model,data", "rndv:8KiB", "rndv:256KiB", "nvlink-2x", "lat-half"]),
    ({"data": "ib", "model": "nvlink"},
     ["mesh:model,data", "rndv:8KiB", "rndv:256KiB", "nvlink-2x", "lat-half", "ib-2x"]),
])
def test_default_scenarios_read_nvlink_and_infiniband(kinds, names):
    """The grid on a 2x4 mesh in one node, and with `data` on InfiniBand:
    the reference's mesh and rendezvous tiers, and the H100's link tiers."""
    mesh = MeshSpec((2, 4), ("data", "model"), kinds)
    assert [s.name for s in whatif.default_scenarios(mesh)] == names
    tr = synth.synthetic_trace("t", mesh, n_sites=120, seed=4)
    res = whatif.sweep(tr.store, mesh)
    assert sorted(r.scenario.name for r in res) == sorted(names)
    assert [r.saved_s for r in res] == sorted((r.saved_s for r in res), reverse=True)
    assert whatif.sweep_to_dict(res, "t", mesh)["mesh"]["axis_kind"] == kinds
    assert whatif.render_sweep(res, "t").startswith("what-if sweep: t")


def test_doubling_nvlink_halves_the_bandwidth_term_of_every_nvlink_row():
    mesh = MeshSpec((2, 4), ("data", "model"), {"data": "ib", "model": "nvlink"})
    tr = synth.synthetic_trace("t", mesh, n_sites=200, seed=6)
    s = tr.store
    res = {r.scenario.name: r for r in whatif.sweep(s, mesh)}
    alt = whatif.reannotate(s, whatif.Scenario("x", hw_overrides={"nvlink_bw": 2 * H100.nvlink_bw}),
                            mesh, H100)
    nv = s.link_class.mask_prefix(("nvlink.",))
    lat = whatif.reannotate(s, whatif.Scenario("z", hw_overrides={"nvlink_bw": 1e30}), mesh, H100)
    bw_term = s.est_time_s - lat.est_time_s
    assert nv.any() and (bw_term[nv] > 0).all()
    np.testing.assert_allclose(alt.est_time_s[nv] - lat.est_time_s[nv], bw_term[nv] / 2,
                               rtol=1e-9)
    np.testing.assert_array_equal(alt.est_time_s[~nv], s.est_time_s[~nv])
    assert res["nvlink-2x"].est_s == pytest.approx(float(np.dot(alt.est_time_s, s.weights)))


def test_the_misconfigured_mesh_sweep_ranks_the_reshape_first():
    """As in the reference: the planted fix (the mesh's transpose) is the
    sweep's best scenario, on the H100's IB/NVLink prices."""
    tr, mesh, fix = synth.misconfigured_trace()
    res = whatif.sweep(tr.store, mesh)
    assert res[0].scenario.name == fix and res[0].saved_s > 0
    jtr, jmesh, jfix = jsynth.misconfigured_trace()
    assert jwhatif.sweep(jtr.store, jmesh)[0].scenario.name == jfix == fix


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr()
    return code, out.out


def _without_cross_pod(text: str) -> str:
    """`detect` output without the reference's DCI findings: the text form's
    finding lines and counts, or the JSON form's entries."""
    if text.startswith("["):
        doc = json.loads(text)
        for res in doc:
            res["findings"] = [f for f in res["findings"] if f["analyzer"] != "cross_pod_bulk"]
        return json.dumps(doc)
    lines = [l for l in text.splitlines() if "cross_pod_bulk" not in l]
    return "\n".join(re.sub(r": \d+ finding\(s\)$", ": finding(s)", l) for l in lines)


@pytest.fixture(scope="module")
def saved(tmp_path_factory, ref_session):
    d = tmp_path_factory.mktemp("cli")
    return {"ref": ref_session.save(str(d / "ref.json")),
            "mmap": ref_session.save(str(d / "ref.npz"), compress=False),
            "dir": str(d)}


@pytest.mark.parametrize("argv", [
    ["show", "{ref}"],
    ["table", "{ref}", "--by", "semantic", "--metric", "time"],
    ["diff", "{ref}", "dp8-baseline", "dp2xtp4", "--by", "site", "--top", "4"],
    ["diff", "{mmap}", "dp8-baseline", "dp2xtp4", "--json", "--mmap"],
    ["diff", "{ref}", "dp8-baseline", "nope"],
    ["query", "{mmap}", "--kind", "all-*", "--json", "--mmap"],
    ["query", "{ref}", "--op", "*mlp*"],
    ["lint", "{ref}", "--fail-on", "critical"],
    ["lint", "{ref}", "--fail-on", "never", "--json"],
    ["detect", "{ref}", "--fail-on", "warn"],
    ["detect", "{ref}", "buggy", "--json"],
    ["report", "{ref}", "buggy", "--format", "html"],
    ["report", "{ref}", "--stream", "--chunk-sites", "5"],
    ["report", "{ref}", "missing-label"],
    ["whatif", "{ref}", "misconfigured", "--top", "2"],
    ["whatif", "{ref}", "--json"],
    ["show", "{dir}/absent.json"],
])
def test_the_session_cli_answers_as_the_reference(saved, capsys, argv):
    """Each command over a reference session: the reference's exit code and,
    where the command only reads the stored traces, its output byte for
    byte.  Two read the hardware: `detect`'s cross-node detector masks the
    port's InfiniBand links (`ib.`, `xnode.`), not the reference's DCI
    (`dci.`, `xpod.`), so its output is compared without the reference's
    `cross_pod_bulk` findings; `whatif` re-prices on each package's own
    hardware, so there the exit code and the scenario set's shape are
    compared."""
    argv = [a.format(**saved) for a in argv]
    want = _cli(jsession._main, argv, capsys)
    got = _cli(session._main, argv, capsys)
    assert got[0] == want[0]
    if argv[0] == "detect":
        assert _without_cross_pod(got[1]) == _without_cross_pod(want[1])
        assert "cross_node_bulk" not in got[1]
    elif argv[0] != "whatif":
        assert got[1] == want[1]
    elif want[0] == 0 and "--json" in argv:
        assert len(json.loads(got[1])["scenarios"]) == len(json.loads(want[1])["scenarios"])


def test_the_cli_refuses_hlo_text_and_runs_as_a_module(saved, tmp_path, capsys):
    """`lint`/`whatif` take saved sessions only (exit 2 on an HLO text file,
    as on any unreadable input); `demo` builds, saves and reloads a sweep;
    `python -m repro_torch.core.session` runs (and imports itself once)."""
    hlo = tmp_path / "module.txt"
    hlo.write_text("HloModule m\n")
    assert session._main(["lint", str(hlo)]) == 2
    assert session._main(["whatif", str(hlo)]) == 2
    out = tmp_path / "demo.npz"
    assert session._main(["demo", "--out", str(out), "--sites", "50"]) == 0
    assert "3 traces" in capsys.readouterr().out
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, "-W", "error::RuntimeWarning", "-m",
                          "repro_torch.core.session", "table", str(out)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("session comparison (3 traces, by kind_link)")


# --------------------------------------------------------------------------
# the example
# --------------------------------------------------------------------------

def test_torch_quickstart_runs_on_the_cpu(tmp_path):
    """`examples/torch_quickstart.py --device cpu`: the 2x4 capture of the
    smoke train step, its tables and roofline, and a saved session that
    loads with the capture's sites."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, os.path.join(REPO, "examples", "torch_quickstart.py"),
                          "--device", "cpu", "--out", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    for head in ("collectives/step", "bytes%", "t_start_us", "roofline"):
        assert head in res.stdout, head
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    sess = session.TraceSession.load(str(tmp_path / path))
    (tr,) = list(sess)
    assert tr.store.n > 0 and "grad_sync" in tr.by_semantic()
    assert jsession.TraceSession.load(str(tmp_path / path)).totals() == sess.totals()


def test_torch_quickstart_needs_a_card_without_device(tmp_path):
    """Without `--device` the example runs on the card; with none it raises
    rather than fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, os.path.join(REPO, "examples", "torch_quickstart.py"),
                          "--out", str(tmp_path)], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not os.listdir(tmp_path)
