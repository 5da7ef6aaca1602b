"""The port's examples (`examples/torch_*.py` beside `torch_quickstart.py`),
each run in a subprocess with `--device cpu` (`torch_session_compare.py`
also with `--synthetic`).

`torch_detect_misconfig.py` is held against the reference's example
(`examples/detect_misconfig.py`, whose step it imports and compiles on 8
forced jax devices with Auto mesh axes: under jax 0.9.0's default Explicit
axes its `with_sharding_constraint` raises): the stale annotation's
detour is found in both (an `ffn` all-gather over `data`, where `ffn`
belongs on `model`), neither finds one in the good program, and the bad
program moves more wire bytes than the good one in both.  What differs is
named in `EXAMPLE_DIFFERENCES` with both readings.  Every example refuses
to start without `--device` when there is no card.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import run_subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["torch_detect_misconfig.py", "torch_profile_arch.py", "torch_diff_configs.py",
            "torch_serve_lm.py", "torch_train_lm.py", "torch_lint_collectives.py",
            "torch_session_compare.py"]


def _run(name, *args, timeout=300, tmpdir=None):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "2"}
    if tmpdir is not None:
        env["TMPDIR"] = str(tmpdir)
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", name), *args],
                          env=env, capture_output=True, text=True, timeout=timeout)


_REFERENCE_DETECT = r"""
import json, sys
sys.path.insert(0, {examples!r})
import detect_misconfig as ex
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.core import MeshSpec, detect, trace_from_hlo
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
spec = MeshSpec((2, 4), ("data", "model"))
out = {{}}
for label in ("good", "bad"):
    g = jax.jit(jax.value_and_grad(ex.make_step(mesh, label == "bad"), argnums=(0, 1)),
                in_shardings=(NamedSharding(mesh, P(None, None, "model")),
                              NamedSharding(mesh, P(None, "model", None)),
                              NamedSharding(mesh, P("data", None, None))))
    with mesh:
        compiled = g.lower(jax.ShapeDtypeStruct((ex.L, ex.D, ex.F), jnp.bfloat16),
                           jax.ShapeDtypeStruct((ex.L, ex.F, ex.D), jnp.bfloat16),
                           jax.ShapeDtypeStruct((ex.B, ex.S, ex.D), jnp.bfloat16)).compile()
    tr = trace_from_hlo(compiled.as_text(), spec, label=label)
    out[label] = dict(wire_mb=round(tr.total_wire_bytes() / 1e6, 1), findings=[
        str(f) for f in detect.run_all(tr, expected_axes={{"grad_sync": "data",
                                                          "ffn": "model"}})])
print("REFERENCE" + json.dumps(out))
"""

# what the two examples print differently: (reference, port, why)
EXAMPLE_DIFFERENCES = {
    "wire MB good -> bad": ((411.0, 1094.7), (323.0, 897.6), (
        "XLA reduces the layers' bf16 products in f32 (2 MiB operands where "
        "DTensor reduces the bf16 1 MiB) and moves the stale layout by "
        "all-to-all, collective-permute and f32 gathers, where DTensor "
        "all-gathers the bf16 activations over data and cuts them locally; "
        "both price an all-gather on its gathered bytes")),
    "redundant_collective findings good, bad": ((2, 10), (0, 1), (
        "the reference's HLO repeats each layer's collective as its own site "
        "(8x, 7x identical all-reduces in the good program), which the "
        "detector reads as re-gathers; the capture folds a layer loop's "
        "repeats into one site's multiplicity (its example prints 5 of 10).  "
        "The port's one: two all-gather sites of the bad program's 2.1 MB "
        "activation over data in scope `layer`, above the detector's 1 MiB "
        "floor since an all-gather is read on its gathered bytes")),
}


def _findings(text):
    """The example's printed findings, per config."""
    out, label = {}, None
    for line in text.splitlines():
        m = re.match(r"=== (\w+) config ===", line)
        if m:
            label = m.group(1)
            out[label] = {"findings": []}
        elif line.startswith("  ["):
            out[label]["findings"].append(line.strip())
        elif line.startswith("modeled collective time"):
            out[label]["wire_mb"] = float(re.search(r"wire ([\d.]+) MB", line).group(1))
    return out


def _detours(findings):
    return sorted(re.search(r"axis_detour: (\w+ [\w-]+) \(.*spans axes (\(.*?\))", f).groups()
                  for f in findings if "axis_detour" in f)


def test_detect_misconfig_finds_what_the_reference_finds():
    res = _run("torch_detect_misconfig.py", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-4000:]
    port = _findings(res.stdout)
    out = run_subprocess(_REFERENCE_DETECT.format(examples=os.path.join(REPO, "examples")),
                         devices=8, timeout=300)
    ref = json.loads(next(l for l in out.splitlines()
                          if l.startswith("REFERENCE"))[len("REFERENCE"):])
    # the stale annotation: an ffn all-gather over data, in both; none in the good program
    assert _detours(port["bad"]["findings"]) == [("ffn all-gather", "('data',)")]
    assert ("ffn all-gather", "('data',)") in _detours(ref["bad"]["findings"])
    assert _detours(port["good"]["findings"]) == _detours(ref["good"]["findings"]) == []
    # the bad program moves more than 1.5x the good one's wire bytes in both
    readings = {"reference": (ref["good"]["wire_mb"], ref["bad"]["wire_mb"]),
                "port": (port["good"]["wire_mb"], port["bad"]["wire_mb"])}
    for good, bad in readings.values():
        assert bad > 1.5 * good
    r, p, why = EXAMPLE_DIFFERENCES["wire MB good -> bad"]
    assert (readings["reference"], readings["port"]) == (r, p) and why
    counts = {who: tuple(sum("redundant_collective" in f for f in d[c]["findings"])
                         for c in ("good", "bad")) for who, d in (("ref", ref), ("port", port))}
    r, p, why = EXAMPLE_DIFFERENCES["redundant_collective findings good, bad"]
    assert (counts["ref"], counts["port"]) == (r, p) and why


def test_profile_arch_writes_the_report(tmp_path):
    """Without `--out` the report goes under TMPDIR, named by the cell."""
    html = tmp_path / "repro_torch_chatglm3-6b_decode_32k.html"
    res = _run("torch_profile_arch.py", "--device", "cpu", "--arch", "chatglm3-6b",
               "--shape", "decode_32k", tmpdir=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "tracing chatglm3-6b x decode_32k on a 2x4 mesh" in res.stdout
    for head in ("collectives/step", "attention", f"wrote {html}"):
        assert head in res.stdout, head
    assert html.read_text().lstrip().lower().startswith("<!doctype html")


def test_diff_configs_shows_the_fsdp_gathers_gone():
    """Serving weights replicated over data: the per-layer gathers over data
    go (GONE), the analytic memory grows."""
    res = _run("torch_diff_configs.py", "--device", "cpu", "--arch", "chatglm3-6b")
    assert res.returncode == 0, res.stderr[-4000:]
    before, after = map(float, re.search(r"per-device memory \(analytic\): ([\d.]+) GB -> "
                                         r"([\d.]+) GB", res.stdout).groups())
    assert after > before
    assert re.search(r"all-gather\|nvlink\.data .* GONE", res.stdout)
    assert "(by semantic)" in res.stdout


def test_serve_lm_serves_every_request():
    res = _run("torch_serve_lm.py", "--device", "cpu", "--requests", "4", "--max-new", "5")
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("[serve] admitting request") == 4
    gens = re.findall(r"-> generated \[([\d, ]+)\]", res.stdout)
    assert len(gens) == 4 and all(len(g.split(",")) == 5 for g in gens)


def test_train_lm_trains(tmp_path):
    """Without `--ckpt-dir` the checkpoints go under TMPDIR, named by the config."""
    args = ("--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32")
    res = _run("torch_train_lm.py", *args, tmpdir=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "15.7M params, 3 steps, batch 2 x seq 32" in res.stdout
    assert f"checkpoints in {tmp_path / 'repro_torch_train_lm_small'}" in res.stdout
    assert re.search(r"loss: [\d.]+ -> [\d.]+; stragglers flagged: \d+", res.stdout)


def test_lint_collectives_finds_every_injected_bug_and_nothing_in_clean_dumps():
    """The three passes: the clean synthetic trace and both capture dumps (a
    synthetic one and the captured smoke step's) without a finding, every
    injected bug class found, the sharding plan's two bad specs."""
    res = _run("torch_lint_collectives.py", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-4000:]
    out = res.stdout
    assert "== clean synthetic trace: 0 finding(s)" in out
    assert re.search(r"== capture dump synthetic\.jsonl \(400 sites, \d+ bytes\): 0 finding",
                     out)
    assert re.search(r"== capture dump smoke_step\.jsonl \(\d+ sites, \d+ bytes\): 0 finding",
                     out)
    assert "all 6 injected bug classes detected" in out
    assert "pspec_dup_axis @ w2" in out and "pspec_unknown_axis @ w3" in out


@pytest.mark.parametrize("mode", ["--device", "--synthetic"])
def test_session_compare_ingests_each_layout_s_dump(mode, tmp_path):
    """Each mesh layout's capture dump ingested into one session, saved under
    `--out`, reloaded and tabled."""
    args = ("--device", "cpu") if mode == "--device" else ("--synthetic",)
    res = _run("torch_session_compare.py", *args, "--out", str(tmp_path))
    assert res.returncode == 0, res.stderr[-4000:]
    for label in ("dp8", "dp4xtp2", "dp2xtp4"):
        assert re.search(rf"^{label}: \d+ bytes of capture dump, \d+ sites ingested$",
                         res.stdout, re.M)
    assert "saved + reloaded 'mesh-layout-sweep'" in res.stdout
    assert "session comparison (3 traces, by kind_link)" in res.stdout
    assert "trace diff: 'dp8' -> 'dp2xtp4'" in res.stdout
    from repro_torch.core.session import TraceSession
    sess = TraceSession.load(str(tmp_path / "torch_mesh_layout_sweep.npz"))
    assert sess.labels() == ["dp8", "dp4xtp2", "dp2xtp4"] and sess.ingest_report.ok
    assert [t.mesh_shape for t in sess] == [(8, 1), (4, 2), (2, 4)]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_without_device(name, tmp_path):
    """Without `--device` each example runs on the card; with none it raises
    rather than fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    extra = {"torch_profile_arch.py": ("--out", str(tmp_path / "t.html")),
             "torch_train_lm.py": ("--ckpt-dir", str(tmp_path / "ck"))}.get(name, ())
    res = _run(name, *extra, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not os.listdir(tmp_path)
