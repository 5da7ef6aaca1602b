"""What the benchmark may import: nothing of JAX or the JAX package `repro`
anywhere under perfbench/, and nothing of the program under reference/.
Top-level module names are compared whole: `repro_torch` is not `repro`."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    """Top-level names of every module that the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)
    assert imported(path) <= {"__future__", "contextlib", "math", "torch", "perfbench"}


def test_whole_names_tell_the_port_from_the_jax_package():
    from perfbench.harness.main import FORBIDDEN
    assert "repro" in FORBIDDEN and "repro_torch" not in FORBIDDEN


def test_loading_every_module_loads_no_jax():
    """Import the harness, every reader and both references in a fresh process."""
    code = f"""
import sys, importlib.util
from pathlib import Path
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH.parent / 'src')!r}]
import perfbench.harness.main, perfbench.harness.prefill, perfbench.harness.train
import perfbench.reference.dense, perfbench.reference.ssm
for p in sorted(Path({str(BENCH / 'metrics')!r}).glob('*.py')):
    s = importlib.util.spec_from_file_location('m_' + p.stem, p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
from perfbench.harness.main import forbidden_modules
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
