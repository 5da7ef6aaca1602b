"""Capture dumps and batch ingest in the port (`core/dump.py`,
`TraceSession.from_captures`, `session ingest`, `lint`/`whatif` on a dump)
against the reference's HLO ingest (`from_hlo`, its `session ingest`).

The reference ingests the HLO text XLA dumps; the port ingests the capture
dump a running rank writes of its captured step.  Held here:
  * the dump's round trip is lossless (every column of every row, every
    Trace attribute, an `identical` store) for the synthetic, labelled-bug
    and misconfigured traces and for the smoke train step captured on a
    2x4 and a 2x2 DeviceMesh under the fake group; a strict read refuses
    each kind of damage, a salvage read keeps the header and every intact
    row, and bytes that are not UTF-8 fail when the file is decoded;
  * against the reference: its `write_hlo_dump` ingested by `from_hlo` and
    saved as npz, loaded by the port, written as capture dumps and ingested
    by `from_captures`, reads the same (labels, totals, every table and
    aggregate, the JSON/HTML reports byte for byte, commcheck's findings;
    the detectors' but for the reference's DCI finding, as
    `tests/test_torch_backhalf.py` allows for hardware); the same for its
    fleet dump through `query(host=..., step=...)`; and `session ingest`'s
    exit codes equal the reference's `_main` on matching inputs;
  * real ranks: the smoke step on 4 gloo ranks of (2, 2), each writing its
    capture (`tests/_torch_dist_worker.py capture`), ingests to one trace a
    host whose site tables are rank 0's, and rank 0's is the fake-group
    capture of the same step.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import free_port
from repro.core import commcheck as jcommcheck
from repro.core import detect as jdetect
from repro.core import session as jsession
from repro.core import synth as jsynth
from repro.core.topology import MeshSpec as JMesh
from repro_torch.core import commcheck, detect, dump, session, synth
from repro_torch.core.session import IngestError, TraceSession
from repro_torch.core.topology import H100, MeshSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
MESH = MeshSpec((2, 4), ("data", "model"))
JM = JMesh((2, 4), ("data", "model"))
ATTRS = ("label", "mesh_shape", "mesh_axes", "num_devices", "op_stats", "hlo_flops",
         "hlo_bytes", "hlo_bytes_unfused", "per_device_memory_bytes", "argument_bytes",
         "output_bytes")
SMOKE = dict(d_model=128, d_ff=256, num_layers=4, vocab_size=512, num_heads=8,
             num_kv_heads=4, head_dim=16)


def assert_same_trace(got, want):
    assert got.store.identical(want.store)
    assert got.store.rows() == want.store.rows()
    for k in ATTRS:
        assert getattr(got, k) == getattr(want, k), k


# --------------------------------------------------------------------------
# the format
# --------------------------------------------------------------------------

TRACES = {
    "synthetic": lambda: synth.synthetic_trace("s", MESH, H100, n_sites=300, seed=1),
    "bugs": lambda: synth.inject_comm_bugs(n_sites=48, seed=2)[0],
    "misconfigured": lambda: synth.misconfigured_trace(n_sites=120)[0],
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_the_round_trip_is_lossless(name, tmp_path):
    tr = TRACES[name]()
    tr.hlo_flops, tr.hlo_bytes, tr.hlo_bytes_unfused = 3.5e12, 1.25e9, 2.5e9
    tr.per_device_memory_bytes, tr.argument_bytes = 7e9, 1e9
    tr.op_stats.bytes_by_scope = {"layer/mlp": 5e8, "loss": 1.5}
    mesh = MeshSpec(tr.mesh_shape, tr.mesh_axes)
    path = str(tmp_path / "t.jsonl")
    n = dump.write_capture(tr, path, mesh=mesh)
    text = dump.read_capture(path)
    assert n == os.path.getsize(path) == len(text.encode()) and text == dump.capture_text(tr, mesh)
    assert text.count("\n") == tr.sites + 2
    assert_same_trace(dump.trace_from_capture(text, mesh), tr)
    salvaged = dump.trace_from_capture(text, mesh, recover=True)
    assert_same_trace(salvaged, tr)
    assert salvaged.salvage.clean and salvaged.salvage.computations_total == tr.sites


_FAKE = r"""
import json, os, sys
sys.path.insert(0, {tests!r})
import torch
import torch.distributed as dist
from _torch_dist_worker import capture_step
from repro_torch.core import dump
from repro_torch.core.session import TraceSession
from repro_torch.launch.mesh import make_host_mesh
inp = torch.load({inputs!r}, weights_only=False)
out = {{}}
for shape in ((2, 4), (2, 2)):
    name = "fake_%dx%d" % shape
    mesh, spec = make_host_mesh(shape, ("data", "model"), backend="fake", device="cpu")
    tr = capture_step(mesh, spec, inp)
    path = os.path.join({d!r}, name + ".jsonl")
    n = dump.write_capture(tr, path, mesh=spec)
    back = dump.trace_from_capture(dump.read_capture(path), spec, label=tr.label)
    out[name] = dict(
        bytes=n, sites=tr.sites, identical=back.store.identical(tr.store),
        rows=back.store.rows() == tr.store.rows(),
        attrs=[k for k in {attrs!r} if getattr(back, k) != getattr(tr, k)],
        unfused=tr.hlo_bytes_unfused != tr.hlo_bytes,
        reports=[TraceSession("a", [back]).report(fmt=f) == TraceSession("a", [tr]).report(fmt=f)
                 for f in ("json", "html")])
    dist.destroy_process_group()
print("FAKE" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def step_dir(tmp_path_factory):
    """The smoke train step's inputs (chatglm3-6b at smoke widths, fp32, 8 x
    64, accum 2, remat full) and its fake-group captures on 2x4 and 2x2."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.presets import StepSettings
    from repro_torch.models import api
    from repro_torch.optim import adamw
    d = tmp_path_factory.mktemp("step")
    cfg = smoke_config(ARCHS["chatglm3-6b"]).replace(**SMOKE)
    torch.save({"cfg": cfg, "opt_cfg": adamw.AdamWConfig(),
                "settings": StepSettings(accum=2, remat="full"),
                "params": api.init_params(cfg, 0, device="cpu", dtype=torch.float32),
                "batch": {k: v.numpy() for k, v in api.demo_batch(cfg, 8, 64,
                                                                 device="cpu").items()}},
               d / "capture_inputs.pt")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-c", _FAKE.format(
        tests=TESTS, inputs=str(d / "capture_inputs.pt"), d=str(d), attrs=ATTRS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(l for l in res.stdout.splitlines() if l.startswith("FAKE"))
    return d, json.loads(line[len("FAKE"):])


def test_a_captured_sharded_step_round_trips(step_dir):
    """The smoke step captured as rank 0 of 2x4 and of 2x2 under the fake
    group: the dump reads back identical, rows, scalars (the unfused byte
    count too) and both reports."""
    _d, fake = step_dir
    for name, r in fake.items():
        assert r["sites"] > 0 and r["unfused"], name
        assert r["identical"] and r["rows"] and r["attrs"] == [], name
        assert r["reports"] == [True, True], name


def _lines():
    text = synth.synthetic_capture(12, seed=3)
    return text.splitlines(keepends=True)


def _swap(lines, i, j):
    lines = list(lines)
    lines[i], lines[j] = lines[j], lines[i]
    return lines


# each damage a strict read refuses: (edit of the capture's lines, error text)
DAMAGE = {
    "bad line": (lambda l: l[:3] + ["{not json\n"] + l[3:], "not JSON"),
    "not a row": (lambda l: l[:3] + ['{"i": 99}\n'] + l[3:], "not a capture row"),
    "no footer": (lambda l: l[:-1], "no footer"),
    "count mismatch": (lambda l: l[:-1] + ['{"rows": 13}\n'], "footer counts 13"),
    "repeated index": (lambda l: l[:3] + [l[2]] + l[3:-1] + ['{"rows": 12}\n'], "repeated"),
    "out of order": (lambda l: _swap(l, 2, 5), "after row"),
    "text after the footer": (lambda l: l + ["trailing\n"], "after the footer"),
    "no header": (lambda l: l[1:], "line 1"),
    "bad header": (lambda l: [l[0].replace('"version":1', '"version":9')] + l[1:], "version"),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_a_strict_read_refuses_each_damage(damage):
    edit, message = DAMAGE[damage]
    text = "".join(edit(_lines()))
    with pytest.raises(ValueError, match=message):
        dump.trace_from_capture(text, MESH)
    tr = dump.trace_from_capture(text, MESH, recover=True)     # salvage never raises
    assert not tr.salvage.clean and tr.salvage.first_error
    assert tr.salvage.computations_dropped == len(tr.salvage.dropped)


def test_a_header_of_another_mesh_is_refused_even_by_salvage():
    text = synth.synthetic_capture(12, seed=3)
    for recover in (False, True):
        with pytest.raises(ValueError, match="is not the mesh given"):
            dump.trace_from_capture(text, MeshSpec((8,), ("data",)), recover=recover)
        with pytest.raises(ValueError, match="is not the mesh given"):
            dump.trace_from_capture(text, MeshSpec((2, 4), ("model", "data")), recover=recover)


def test_salvage_keeps_the_header_and_every_intact_row():
    """Row 4 dropped, row 7's line mangled, a second copy of row 2 (altered)
    after it: the salvage keeps the header's scalars, the first copy of row
    2 and every other intact row, and names rows 4 and 7 as lost."""
    clean = dump.trace_from_capture(synth.synthetic_capture(12, seed=3), MESH)
    lines = _lines()
    dup = json.loads(lines[3])
    dup["multiplicity"] += 1000
    damaged = (lines[:4] + [json.dumps(dup) + "\n"] + lines[4:5] + lines[6:8]
               + [lines[8][:40] + "\n"] + lines[9:])
    tr = dump.trace_from_capture("".join(damaged), MESH, recover=True)
    keep = [i for i in range(12) if i not in (4, 7)]
    assert tr.store.rows() == [clean.store.row(i) for i in keep]
    assert (tr.hlo_flops, tr.op_stats, tr.label) == (clean.hlo_flops, clean.op_stats,
                                                     clean.label)
    rep = tr.salvage.to_dict()
    assert rep["dropped"] == ["row 4 (missing)", "row 7 (missing)"]
    assert (rep["computations_total"], rep["computations_dropped"]) == (12, 2)
    assert rep["bytes_skipped"] == len(json.dumps(dup)) + 1 + 41 and not rep["clean"]
    assert json.loads(json.dumps(rep)) == rep


def test_a_capture_without_its_header_salvages_its_rows_on_the_given_mesh():
    clean = dump.trace_from_capture(synth.synthetic_capture(12, seed=3), MESH)
    tr = dump.trace_from_capture("".join(_lines()[1:]), MESH, label="x", recover=True)
    assert tr.store.rows() == clean.store.rows() and tr.label == "x"
    assert (tr.mesh_shape, tr.hlo_flops) == (MESH.shape, 0.0)
    assert tr.salvage.first_error.startswith("no capture header")
    with pytest.raises(ValueError, match="needs the caller's mesh"):
        dump.trace_from_capture("".join(_lines()[1:]), recover=True)


def test_undecodable_bytes_fail_when_the_file_is_read(tmp_path):
    data = synth.corrupt_capture(synth.synthetic_capture(12, seed=3), "binary", seed=1)
    assert isinstance(data, bytes)
    (tmp_path / "b.jsonl").write_bytes(data)
    with pytest.raises(UnicodeDecodeError):
        dump.read_capture(str(tmp_path / "b.jsonl"))


def test_the_dump_generators_write_the_synthetic_traces(tmp_path):
    """`synthetic_capture` is `synthetic_trace`'s dump; the writers' names and
    seeds are the reference's (`{prefix}_{i:04d}`, `host{h:03d}_step{s:03d}`,
    `{prefix}_{mode}`), with the port's `.jsonl`."""
    tr = dump.trace_from_capture(synth.synthetic_capture(50, seed=9), MESH)
    assert tr.store.identical(synth.synthetic_trace("synthetic", MESH, H100, n_sites=50,
                                                    seed=9).store)
    paths = synth.write_capture_dump(str(tmp_path / "a"), n_files=2, sites_per_file=30,
                                     seed=4, start=1)
    assert [os.path.basename(p) for p in paths] == ["module_0001.jsonl", "module_0002.jsonl"]
    assert dump.read_capture(paths[1]) == synth.synthetic_capture(30, seed=6)
    fleet = synth.write_fleet_dump(str(tmp_path / "f"), n_hosts=2, steps=2, sites_per_file=20)
    assert [os.path.basename(p) for p in fleet] == [
        "host000_step000.jsonl", "host000_step001.jsonl", "host001_step000.jsonl",
        "host001_step001.jsonl"]
    assert dump.read_capture(fleet[3]) == synth.synthetic_capture(20, seed=3)
    assert dump.capture_path("r", 12, 3) == os.path.join("r", "host012_step003.jsonl")
    bad = synth.write_corrupt_dump(str(tmp_path / "c"), sites_per_file=20)
    assert [os.path.basename(p) for p in bad] == [f"corrupt_{m}.jsonl"
                                                  for m in synth.CORRUPT_MODES]
    assert session.label_meta("host012_step003") == {"host": "012", "step": 3}


# --------------------------------------------------------------------------
# against the reference's HLO ingest
# --------------------------------------------------------------------------

def _as_captures(ref_npz, d):
    """The port's reading of a reference session file, each trace written
    as a capture dump named by its label."""
    os.makedirs(d, exist_ok=True)
    loaded = TraceSession.load(ref_npz)
    paths = []
    for t in loaded:
        paths.append(os.path.join(d, f"{t.label}.jsonl"))
        dump.write_capture(t, paths[-1], mesh=MESH)
    return loaded, paths


@pytest.fixture(scope="module")
def hlo_ingest(tmp_path_factory):
    d = tmp_path_factory.mktemp("hlo")
    files = jsynth.write_hlo_dump(str(d / "hlo"), n_files=3, sites_per_file=150, seed=0)
    ref = jsession.TraceSession.from_hlo("sweep", files, JM, max_workers=1)
    npz = ref.save(str(d / "ref.npz"))
    loaded, caps = _as_captures(npz, str(d / "cap"))
    return ref, loaded, caps, files


def _readings(sess):
    out = {"labels": sess.labels(), "totals": sess.totals()}
    for by in ("kind_link", "semantic", "site"):
        for metric in ("bytes", "time", "count"):
            out[f"table {by} {metric}"] = sess.table(by=by, metric=metric)
    for by in ("kind_link", "semantic"):
        out[f"aggregate {by}"] = sess.aggregate(by)
    for t in sess:
        for fmt in ("json", "html"):
            out[f"{t.label} {fmt}"] = sess.report(t.label, fmt=fmt)
    return out


@pytest.mark.parametrize("workers", [1, 2])
def test_ingest_of_the_reference_s_traces_reads_as_its_from_hlo_session(hlo_ingest, workers):
    """Labels, totals, every table and aggregate and both reports byte for
    byte; each trace identical to the reference's as the port loads it; the
    ingest report all `ok` with the reference's labels, hosts and steps."""
    ref, loaded, caps, _files = hlo_ingest
    got = TraceSession.from_captures("sweep", caps, MESH, max_workers=workers)
    want = _readings(ref)
    have = _readings(got)
    assert have.keys() == want.keys()
    for key in want:
        assert have[key] == want[key], key
    for a, b in zip(got, loaded):
        assert_same_trace(a, b)
    key = lambda r: (r.label, r.status, r.attempts, r.host, r.step)  # noqa: E731
    assert [key(r) for r in got.ingest_report.records] == \
        [key(r) for r in ref.ingest_report.records]
    assert [r.source for r in got.ingest_report.records] == caps


def test_findings_on_the_ingested_traces_are_the_reference_s(hlo_ingest):
    """commcheck's findings field for field; the detectors' but for the
    reference's DCI one (`cross_pod_bulk`), which the H100 model has no
    counterpart of on this mesh (`tests/test_torch_backhalf.py`)."""
    ref, _loaded, caps, _files = hlo_ingest
    got = TraceSession.from_captures("sweep", caps, MESH, max_workers=1)
    for a, b in zip(got, ref):
        assert [f.to_dict() for f in commcheck.check_trace(a)] == \
            [f.to_dict() for f in jcommcheck.check_trace(b)]
        strip = lambda fs: [f.to_dict() for f in fs  # noqa: E731
                            if f.detector != "cross_pod_bulk"]
        assert strip(detect.run_all(a)) == strip(jdetect.run_all(b))


def test_a_fleet_dump_queries_as_the_reference_s(tmp_path):
    files = jsynth.write_fleet_dump(str(tmp_path / "hlo"), n_hosts=3, steps=2,
                                    sites_per_file=60)
    ref = jsession.TraceSession.from_hlo("fleet", files, JM, max_workers=1)
    _loaded, caps = _as_captures(ref.save(str(tmp_path / "ref.npz")), str(tmp_path / "cap"))
    got = TraceSession.from_captures("fleet", caps, MESH, max_workers=1)
    assert got.labels() == ref.labels() == [f"host{h:03d}_step{s:03d}"
                                            for h in range(3) for s in range(2)]
    for q in ({"host": "001"}, {"step": "1"}, {"host": "00[02]", "step": "0"},
              {"host": "002", "step": "1", "kind": "all-gather"}, {}):
        assert got.query(**q) == ref.query(**q), q
    assert got.query(host="001")["traces"] == ["host001_step000", "host001_step001"]
    assert got.report("host=001", fmt="json") == ref.report("host=001", fmt="json")


def _exit_and_statuses(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    recs = json.loads(out)["records"] if "--json" in argv and rc in (0, 3) else []
    return rc, [(r["label"], r["status"]) for r in recs]


@pytest.mark.parametrize("case", ["clean", "missing", "raise", "skip", "salvage", "mesh rank"])
def test_session_ingest_exits_as_the_reference_s(case, tmp_path, capsys):
    """`session ingest` on capture dumps against the reference's `_main` on
    HLO dumps of the same shape: a clean directory (0), a missing file (2),
    a damaged input under raise (2), skip (3, dropped) and salvage (3,
    salvaged), and --mesh/--axes of different ranks (2)."""
    hlo = jsynth.write_hlo_dump(str(tmp_path / "hlo"), n_files=2, sites_per_file=40, seed=5)
    cap = synth.write_capture_dump(str(tmp_path / "cap"), n_files=2, sites_per_file=40, seed=5)
    if case != "clean":
        with open(hlo[1]) as f:
            bad = jsynth.corrupt_hlo(f.read(), "mangle_rg")
        with open(hlo[1], "w") as f:
            f.write(bad)
        bad = synth.corrupt_capture(dump.read_capture(cap[1]), "mangle_rg")
        with open(cap[1], "w") as f:
            f.write(bad)
    extra = {"missing": [], "raise": [], "skip": ["--errors", "skip"],
             "salvage": ["--errors", "salvage"], "mesh rank": ["--mesh", "8"],
             "clean": []}[case]
    files = {"hlo": hlo, "cap": cap}
    if case == "missing":
        files = {k: v + [v[0] + ".gone"] for k, v in files.items()}
    got = {}
    for who, main in (("hlo", jsession._main), ("cap", session._main)):
        out = str(tmp_path / f"{who}.json")
        got[who] = _exit_and_statuses(main, ["ingest", out, *files[who], "--workers", "1",
                                             "--retries", "0", "--json", *extra], capsys)
    assert got["cap"] == got["hlo"]
    assert got["cap"][0] == {"clean": 0, "missing": 2, "raise": 2, "skip": 3, "salvage": 3,
                             "mesh rank": 2}[case]
    if case == "salvage":
        assert TraceSession.load(str(tmp_path / "cap.json")).ingest_report.degraded


def test_from_captures_raise_names_the_bad_input(tmp_path):
    cap = synth.write_capture_dump(str(tmp_path), n_files=2, sites_per_file=20)
    with open(cap[0], "a") as f:
        f.write("garbage\n")
    with pytest.raises(IngestError, match="module_0000"):
        TraceSession.from_captures("s", cap, MESH, max_workers=1)
    with pytest.raises(ValueError, match="errors must be"):
        TraceSession.from_captures("s", cap, MESH, errors="ignore")


def test_lint_and_whatif_read_a_capture_dump(tmp_path, capsys):
    """`lint`/`whatif` take a capture where the reference takes an HLO file:
    the same output as over a saved session of the trace; a capture of
    another mesh exits 2."""
    tr, _labels = synth.inject_comm_bugs(n_sites=48, seed=2)
    cap = str(tmp_path / "bugs.jsonl")
    dump.write_capture(tr, cap)
    tr.label = "bugs"
    saved = TraceSession("s", [tr]).save(str(tmp_path / "s.json"))
    outs = {}
    for path in (cap, saved):
        rc = session._main(["lint", path, "--json", "--fail-on", "never"])
        lint = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert session._main(["whatif", path, "--json"]) == 0
        outs[path] = ([r["findings"] for r in lint], capsys.readouterr().out)
    assert outs[cap] == outs[saved] and outs[cap][0][0]
    assert session._main(["lint", cap]) == 1            # critical findings
    capsys.readouterr()
    for cmd in ("lint", "whatif"):
        assert session._main([cmd, cap, "--mesh", "4,2"]) == 2
        assert "is not the mesh given" in capsys.readouterr().err


# --------------------------------------------------------------------------
# real ranks
# --------------------------------------------------------------------------

def _sites(trace):
    return sorted((e.op_name, e.kind, str(e.replica_groups), e.operand_bytes, e.dtype,
                   e.multiplicity, e.link_class, e.est_time_s) for e in trace.events)


def test_four_gloo_ranks_write_captures_that_ingest_per_host(step_dir, tmp_path):
    """Each of 4 gloo ranks of (2, 2) captures the smoke step and writes
    `host{rank:03d}_step000.jsonl`; `from_captures` gives one trace a host
    that `query(host=...)` selects, every rank's site table is rank 0's, and
    rank 0's is the fake-group capture of the same step."""
    d, _fake = step_dir
    out = tmp_path / "ranks"
    out.mkdir()
    (out / "capture_inputs.pt").write_bytes((d / "capture_inputs.pt").read_bytes())
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, os.path.join(TESTS, "_torch_dist_worker.py"),
                          "capture", str(out), "2", "2", str(free_port())],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    files = sorted(str(p) for p in out.glob("*.jsonl"))
    mesh = MeshSpec((2, 2), ("data", "model"))
    sess = TraceSession.from_captures("ranks", files, mesh, max_workers=1)
    assert sess.labels() == [f"host{r:03d}_step000" for r in range(4)]
    assert sess.ingest_report.ok
    for r in range(4):
        assert sess.query(host=f"{r:03d}")["traces"] == [f"host{r:03d}_step000"]
    tables = [_sites(t) for t in sess]
    assert tables[0] and all(t == tables[0] for t in tables[1:])
    fake = dump.trace_from_capture(dump.read_capture(str(d / "fake_2x2.jsonl")), mesh)
    assert _sites(fake) == tables[0]
    assert np.isclose(sess.get("host000_step000").hlo_flops, fake.hlo_flops, rtol=1e-12)
