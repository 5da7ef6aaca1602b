"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as files, with their entries in BENCHMARK.json, make a
runnable cell with no file edited; names and units outside the rules are
refused; the configuration files are the program's configurations."""
import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from perfbench.tests.helpers import DATA, ROOT, WINDOW_S, small_cell


@pytest.fixture
def checkout(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ (the program stays where it is)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def add_cell(root):
    """Add one configuration, one traffic mix and one metric as new files."""
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    shutil.copy(DATA / "tiny-ssm.json", root / "perfbench" / "configs" / "tiny-ssm.json")
    shutil.copy(DATA / "tiny-prefill.json", root / "perfbench" / "traffic" / "tiny-prefill.json")
    (root / "perfbench" / "metrics" / "requests_traced.py").write_text(
        "def read(ctx):\n    return float(len(ctx.traced))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-ssm", "source": "https://example.org/tiny",
                            "file": "perfbench/configs/tiny-ssm.json", "reduced": [],
                            "why": "a small SSM"})
    spec["workloads"].append({"name": "tiny-ssm.tiny-prefill", "config": "tiny-ssm",
                              "traffic": "tiny-prefill", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("prefill_tokens_per_s", "ttft_p95_ms"):
            m["workloads"].append("tiny-ssm.tiny-prefill")
    spec["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "device (H100)",
                              "moves": "ttft_p95_ms", "workloads": ["tiny-ssm.tiny-prefill"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return before


def test_new_cell_from_files_alone(checkout, cpu):
    from perfbench.harness import main, spec
    before = add_cell(checkout)
    for path, data in before.items():
        assert path.read_bytes() == data, f"{path} was edited"
    cell = spec.cell(spec.load_spec(checkout), "tiny-ssm.tiny-prefill", checkout)
    assert [m["name"] for m in cell.per_layer] == ["requests_traced"]
    assert {m["name"] for m in cell.end_to_end} == {"prefill_tokens_per_s", "ttft_p95_ms",
                                                   "setup_s"}
    cell.limits = {"logits_rel": 1.0, "cache_rel": 1.0}
    for trace in (0, 1):
        out, _ = main.measure(cell, SimpleNamespace(seed=5, seconds=WINDOW_S, trace=trace), cpu,
                              time.perf_counter())
        assert out["correct"], out["checks"]
        if trace:
            assert out["metrics"] == {"requests_traced": {"value": 2.0, "unit": "requests"}}
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(out["metrics"]) == {"prefill_tokens_per_s", "ttft_p95_ms", "setup_s"}


@pytest.mark.parametrize("where,bad", [
    ("workload", "tiny ssm"), ("workload", "tiny/ssm"), ("workload", "tiny,ssm"),
    ("workload", "tïny"), ("metric", "k1 roofline"), ("unit", "tokens per s"),
    ("unit", "µs"), ("reduced", "num layers")])
def test_names_and_units_outside_the_rules_are_refused(checkout, where, bad):
    from perfbench.harness import spec
    add_cell(checkout)
    s = json.loads((checkout / "BENCHMARK.json").read_text())
    if where == "workload":
        s["workloads"][-1]["name"] = bad
    elif where == "metric":
        s["per_layer"][-1]["name"] = bad
    elif where == "unit":
        s["per_layer"][-1]["unit"] = bad
    else:
        s["configs"][-1]["reduced"] = [bad]
    (checkout / "BENCHMARK.json").write_text(json.dumps(s))
    with pytest.raises(spec.SpecError):
        spec.load_spec(checkout)


def test_committed_spec_is_valid_and_every_file_exists():
    from perfbench.harness import spec
    s = spec.load_spec()
    for w in s["workloads"]:
        cell = spec.cell(s, w["name"])
        for m in cell.per_layer:
            assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert cell.limits, f"{w['name']} has no limits file"
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", ["chatglm3-6b", "falcon-mamba-7b", "falcon-mamba-7b-l4"])
def test_configuration_file_is_the_ports_configuration(name):
    """Every field of the file's model block is the port's, but the depth where cut."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    port = dataclasses.asdict(get_config(cfg["model"]["name"].removesuffix("-l4")))
    cut = {"num_layers"} if "num_hidden_layers" in cfg["reduced"] else set()
    for key, value in cfg["model"].items():
        if key not in cut | {"name"}:
            assert port[key] == value, key
    assert cfg["model"]["num_layers"] == (4 if cut else port["num_layers"])


def test_only_benchmark_files_make_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and perfbench/, a run exits
    non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "chatglm3-6b.prefill-long", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_split_metrics_read_their_quantity(cpu):
    """A metric `<quantity>.<part>` reads the quantity: the falcon-mamba-7b
    cell's end-to-end and per-layer metrics, on a small SSM."""
    from perfbench.harness import main, spec
    real = spec.cell(spec.load_spec(), "falcon-mamba-7b.prefill-long")
    cell = small_cell("tiny-ssm", "tiny-prefill", limits={"logits_rel": 1, "cache_rel": 1},
                      per_layer=real.per_layer)
    cell.end_to_end = real.end_to_end
    untraced, _ = main.measure(cell, SimpleNamespace(seed=8, seconds=WINDOW_S, trace=0), cpu,
                               time.perf_counter())
    assert set(untraced["metrics"]) == {"prefill_tokens_per_s.ssm", "ttft_p95_ms.ssm", "setup_s"}
    traced, _ = main.measure(cell, SimpleNamespace(seed=8, seconds=WINDOW_S, trace=1), cpu,
                             time.perf_counter())
    # the CPU runs no K2 and no device op: those readers find nothing to read
    assert {"prefill_mfu.ssm", "idle_share.prefill.ssm", "dispatch_ms.prefill.ssm"} <= set(
        traced["metrics"])
    assert all(m["value"] > 0 for m in list(untraced["metrics"].values())
               + list(traced["metrics"].values()))
