"""`correct` comes out false when the timed path is broken underneath, and
for the control: the rest of a run past the look for a card, at small width
on the CPU, held to the cells' own limits.  A sound run in float32 passes
them, so each fault and the control fail by what they break."""
import json
import time
from types import SimpleNamespace

import pytest

from perfbench.harness import faults
from perfbench.tests.helpers import ROOT, WINDOW_S, small_cell

PREFILL_CELLS = {"tiny-dense": "chatglm3-6b.prefill-long", "tiny-ssm": "falcon-mamba-7b.prefill-long"}
TRAIN_CELL = "falcon-mamba-7b-l4.train"


def limits(workload):
    return json.loads((ROOT / "perfbench" / "limits" / f"{workload}.json").read_text())


def run(cell, cpu, fault=None, seed=21):
    from perfbench.harness import main
    out, _ = main.measure(cell, SimpleNamespace(seed=seed, seconds=WINDOW_S, trace=0), cpu,
                          time.perf_counter(), fault=fault)
    return out


@pytest.mark.parametrize("config", sorted(PREFILL_CELLS))
def test_sound_prefill_passes(config, cpu):
    cell = small_cell(config, "tiny-prefill", compute_dtype="float32",
                      limits=limits(PREFILL_CELLS[config]))
    assert run(cell, cpu)["correct"]


@pytest.mark.parametrize("fault", faults.PREFILL)
@pytest.mark.parametrize("config", sorted(PREFILL_CELLS))
def test_prefill_fault_is_caught(config, fault, cpu):
    cell = small_cell(config, "tiny-prefill", compute_dtype="float32",
                      limits=limits(PREFILL_CELLS[config]))
    out = run(cell, cpu, faults.prefill(fault))
    assert not out["correct"], out["checks"]


def test_sound_train_passes(cpu):
    cell = small_cell("tiny-ssm", "tiny-train", compute_dtype="float32", limits=limits(TRAIN_CELL))
    assert run(cell, cpu)["correct"]


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_train_fault_is_caught(fault, cpu):
    cell = small_cell("tiny-ssm", "tiny-train", compute_dtype="float32", limits=limits(TRAIN_CELL))
    out = run(cell, cpu, faults.train(fault, cell.config["model"]["vocab_size"]))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("prec", ["fp8", "fp8_gemm"])
@pytest.mark.parametrize("config", sorted(PREFILL_CELLS))
def test_prefill_control_is_not_correct(config, prec, cpu):
    """The reference in float8 put in the program's place fails the cell's
    limits: every bf16 tensor rounded, and the GEMMs' operands alone."""
    from perfbench.harness import checks, prefill
    cell = small_cell(config, "tiny-prefill")
    ok, judged = checks.judge(prefill.control(cell, 23, cpu, prec), limits(PREFILL_CELLS[config]))
    assert not ok, judged


def test_train_control_is_not_correct(cpu):
    """The reference with every bf16 tensor in float8 fails the train cell's
    limits.  (Its GEMMs alone in float8 do not, on the card: PERF.md.)"""
    from perfbench.harness import checks, train
    cell = small_cell("tiny-ssm", "tiny-train")
    ok, judged = checks.judge(train.control(cell, 24, cpu, "fp8"), limits(TRAIN_CELL))
    assert not ok, judged
