"""BENCHMARK.json and the data files it names, found by name and checked.

A configuration is `configs/<name>.json`, a traffic mix `traffic/<name>.json`,
a per-layer metric's reader `metrics/<name>.py`, a cell's limits
`limits/<workload>.json`, a reference `reference/<family>.py`, a family's
model FLOPs `roofline/<family>.py` and the driver of a kind of traffic
`harness/<kind>.py`, all under the benchmark's folder: a new cell, family or
kind adds files and entries and edits none."""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]          # the benchmark's folder
ROOT = BENCH.parent                                   # the checkout
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names breaks the benchmark's rules."""


def check_name(value, what):
    if not isinstance(value, str) or not NAME.fullmatch(value):
        raise SpecError(f"{what} {value!r}: a name is 1-64 of A-Z a-z 0-9 _ . - "
                        f"and starts with a letter, a digit or _")
    return value


def check_unit(value, what):
    if not isinstance(value, str) or not UNIT.fullmatch(value):
        raise SpecError(f"{what} unit {value!r}: 1-16 of A-Z a-z 0-9 _ / % . -")
    return value


def validate(spec):
    """Raise SpecError where a name, unit or reference breaks the rules."""
    for c in spec["configs"]:
        check_name(c["name"], "config")
        for key in c["reduced"]:
            check_name(key, f"config {c['name']} reduced key")
    configs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        for key in ("name", "config", "traffic"):
            check_name(w[key], f"workload {key}")
        if w["config"] not in configs:
            raise SpecError(f"workload {w['name']}: no config {w['config']!r}")
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        check_name(m["name"], "metric")
        check_unit(m["unit"], f"metric {m['name']}")
        if m["better"] not in ("lower", "higher"):
            raise SpecError(f"metric {m['name']}: better {m['better']!r}")
        missing = set(m.get("workloads", ())) - cells
        if missing:
            raise SpecError(f"metric {m['name']}: no workload {sorted(missing)}")
    for m in spec["per_layer"]:
        if m["moves"] not in e2e:
            raise SpecError(f"metric {m['name']}: moves {m['moves']!r}, not an end-to-end metric")
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[key]]
    if len(names) != len(set(names)):
        raise SpecError("two entries share a name")


def load_spec(root=ROOT):
    spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
    validate(spec)
    return spec


@dataclass
class Cell:
    """One workload with what it names: its configuration, traffic and limits,
    and the metrics it reports."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench: Path


def _reports(metric, cell):
    return cell in metric["workloads"] if "workloads" in metric else None


def cell(spec, name, root=ROOT):
    """The workload `name` of `spec`, its files read from the checkout `root`."""
    root = Path(root)
    bench = root / BENCH.name
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise SpecError(f"no workload {name!r}; have {[w['name'] for w in spec['workloads']]}")
    w = found[0]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    if config["name"] != entry["name"]:
        raise SpecError(f"{entry['file']} holds {config['name']!r}, not {entry['name']!r}")
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = bench / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.is_file() else {}
    e2e = [m for m in spec["end_to_end"] if _reports(m, name) is not False]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, name) or ("workloads" not in m and m["moves"] in moved)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer, bench)
