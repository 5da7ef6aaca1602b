"""Small cells for the benchmark's CPU tests, built from the configurations
and mixes under data/."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
# a window long enough for the few requests the tests check on a busy CPU
WINDOW_S = 1.5


def small_cell(config, traffic, *, compute_dtype=None, limits=None, per_layer=()):
    """A Cell of the small configuration `config` under the small mix `traffic`."""
    from perfbench.harness import spec
    cfg = json.loads((DATA / f"{config}.json").read_text())
    if compute_dtype:
        cfg["model"]["compute_dtype"] = compute_dtype
    return spec.Cell(f"{config}.{traffic}", 1, cfg, json.loads((DATA / f"{traffic}.json").read_text()),
                     dict(limits or {}), [], list(per_layer), ROOT / "perfbench")
