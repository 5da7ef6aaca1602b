"""Import hygiene of the port: no jax and nothing of the reference package.

Also: `chip_smoke.py` exits non-zero and prints no result without a CUDA
device, and in a directory that holds nothing else of the repo.
"""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    code = ("import importlib, sys\n"
            f"for name in {_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")), timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 15 and bad == "[]", res.stdout


def test_scan_covers_the_sharding_and_profiler_modules():
    """The walk above reaches the sharding, MoE and profiler modules, and the
    store, session, synth, capture-dump and watch-daemon copies import none of
    the reference's HLO parser or tracer (the port reads its own captures)."""
    mods = _modules()
    for name in ("repro_torch.scope", "repro_torch.launch.mesh",
                 "repro_torch.distributed.sharding", "repro_torch.distributed.autoshard",
                 "repro_torch.core.capture", "repro_torch.core.events",
                 "repro_torch.core.topology", "repro_torch.core.store",
                 "repro_torch.core.costmodel", "repro_torch.core.attribution",
                 "repro_torch.core.roofline", "repro_torch.core.commcheck",
                 "repro_torch.core.detect", "repro_torch.distributed.moe_ep",
                 "repro_torch.core.persist", "repro_torch.core.diff",
                 "repro_torch.core.whatif", "repro_torch.core.synth",
                 "repro_torch.core.report", "repro_torch.core.session",
                 "repro_torch.distributed.ppermute", "repro_torch.distributed.algorithms",
                 "repro_torch.distributed.pipeline", "repro_torch.core.dump",
                 "repro_torch.core.watch"):
        assert name in mods, name
    for name in ("store", "session", "synth", "dump", "watch"):
        text = (PKG / "core" / f"{name}.py").read_text()
        assert not re.search(r"import .*(hlo_parser|tracer)|(hlo_parser|tracer) import",
                             text), name


def test_sources_have_no_jax_or_repro_import():
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert {f.name for f in examples} >= {
        "torch_quickstart.py", "torch_detect_misconfig.py", "torch_profile_arch.py",
        "torch_diff_configs.py", "torch_serve_lm.py", "torch_train_lm.py",
        "torch_lint_collectives.py", "torch_session_compare.py"}
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert {f.name for f in scripts} >= {"torch_chaos_smoke.py", "torch_peak_holders.py",
                                         "torch_scan_chunks.py"}
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + examples + scripts
    assert len(files) >= 15
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.models import api")      # the pattern itself bites
    assert not FORBIDDEN.search("from repro_torch.models import api")


def _run_chip_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, env=env, timeout=120)


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    import torch
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    runs = [_run_chip_smoke(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append(_run_chip_smoke(REPO, REPO / "chip_smoke.py"))
    for res in runs:
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
