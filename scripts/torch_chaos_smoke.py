#!/usr/bin/env python
"""The chaos gate on the port's capture dumps: the corrupt-dump matrix through
batch ingest and the watch daemon, with controlled exit codes, no crash and
every input accounted for.

Builds a dump directory holding one clean capture and one capture damaged by
each of `synth.CORRUPT_MODES`, then drives the two fleet entry points over it
as subprocesses (`python -m repro_torch.core.session`):

  1. `ingest --errors salvage --json` exits 3 (degraded, not fatal), writes the
     session and accounts for every input in its ingest report: the clean
     file `ok` and identical to a solo `trace_from_capture`, the undecodable
     file quarantined, every degraded record with its reason.
  2. `watch --once --fail-on critical` exits 0, 1 or 3, names the quarantined
     file in its summary and records every input.
  3. The same daemon restarted on its checkpoint re-parses no file.

Run from the repo root, on the CPU, with no jax:
    python scripts/torch_chaos_smoke.py
It writes under build/torch_smoke/ and prints PASS as its last line.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

from repro_torch.core import dump                                # noqa: E402
from repro_torch.core.session import TraceSession                # noqa: E402
from repro_torch.core.synth import synthetic_capture, write_corrupt_dump  # noqa: E402
from repro_torch.core.topology import MeshSpec                   # noqa: E402

WORK = os.path.join(ROOT, "build", "torch_smoke", "chaos")
MESH = MeshSpec((2, 4), ("data", "model"))
ENV = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
DAEMON = ["--once", "--quiet", "--settle", "0", "--interval", "0.01", "--retry-backoff", "0"]


def run(args):
    return subprocess.run([sys.executable, "-m", "repro_torch.core.session", *args], env=ENV,
                          capture_output=True, text=True, timeout=300)


def fail(msg):
    print(f"torch_chaos_smoke: FAIL - {msg}", file=sys.stderr)
    raise SystemExit(1)


def main():
    shutil.rmtree(WORK, ignore_errors=True)
    root = os.path.join(WORK, "dump")
    os.makedirs(root)
    clean = dump.trace_from_capture(synthetic_capture(n_sites=200, seed=17), MESH,
                                    label="clean")
    clean_path = os.path.join(root, "clean.jsonl")
    dump.write_capture(clean, clean_path, mesh=MESH)
    write_corrupt_dump(root, seed=9)
    files = sorted(os.path.join(root, f) for f in os.listdir(root))
    names = [os.path.basename(p) for p in files]
    print(f"torch_chaos_smoke: {len(files)} inputs ({names})")

    # -- batch ingest: exit 3, the session written, every input accounted for
    out = os.path.join(WORK, "chaos.npz")
    r = run(["ingest", out, *files, "--workers", "1", "--errors", "salvage", "--retries", "0",
             "--retry-backoff", "0", "--json"])
    if r.returncode != 3:
        fail(f"ingest --errors salvage exited {r.returncode}, expected 3\n{r.stdout}\n{r.stderr}")
    report = json.loads(r.stdout)
    if [rec["source"] for rec in report["records"]] != files:
        fail(f"the ingest report does not cover every input: {report}")
    statuses = {os.path.basename(rec["source"]): rec["status"] for rec in report["records"]}
    if statuses["clean.jsonl"] != "ok":
        fail(f"the clean capture was degraded: {statuses}")
    if statuses["corrupt_binary.jsonl"] != "quarantined":
        fail(f"the undecodable capture was not quarantined: {statuses}")
    for rec in report["records"]:
        if rec["status"] != "ok" and not rec["error"]:
            fail(f"a degraded input without a reason: {rec}")
    solo = dump.trace_from_capture(dump.read_capture(clean_path), MESH, label="clean")
    if not TraceSession.load(out).get("clean").store.identical(solo.store):
        fail("the clean capture is not identical through the chaos ingest")
    print(f"torch_chaos_smoke: ingest ok (exit 3, "
          f"{sum(s != 'ok' for s in statuses.values())} degraded, the clean capture identical)")

    # -- the watch daemon: a controlled exit, the quarantine in its summary
    summary = os.path.join(WORK, "summary.json")
    ckpt = os.path.join(WORK, "watch.npz")
    r = run(["watch", root, *DAEMON, "--fail-on", "critical", "--summary", summary,
             "--checkpoint", ckpt])
    if r.returncode not in (0, 1, 3):
        fail(f"watch --once exited {r.returncode} (crash?)\n{r.stderr}")
    with open(summary) as f:
        summ = json.load(f)
    quarantined = [os.path.basename(p) for p in summ["ingest"]["quarantined"]]
    if "corrupt_binary.jsonl" not in quarantined:
        fail(f"the daemon's summary lacks the quarantined file: {summ['ingest']}")
    recorded = {os.path.basename(rec["source"]) for rec in summ["ingest"]["records"]}
    if recorded != set(names):
        fail(f"the daemon's records are incomplete: {sorted(recorded)}")
    print(f"torch_chaos_smoke: watch ok (exit {r.returncode}, quarantined={quarantined})")

    # -- a resume on the daemon's checkpoint re-parses nothing
    r = run(["watch", root, *DAEMON, "--summary", summary, "--checkpoint", ckpt])
    if r.returncode not in (0, 1, 3):
        fail(f"the resumed watch exited {r.returncode}\n{r.stderr}")
    with open(summary) as f:
        parsed = json.load(f)["ingest"]["parse_count"]
    if parsed != 0:
        fail(f"the resumed daemon re-parsed {parsed} file(s)")
    print("torch_chaos_smoke: resume ok (0 re-parses)")
    print("torch_chaos_smoke: PASS")


if __name__ == "__main__":
    main()
