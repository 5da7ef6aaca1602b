"""The GPipe pipeline in the port (`distributed/pipeline.py`) against the
reference's (`tests/test_pipeline.py`'s case: P 4, M 6, mb 2, D 32, a tanh
stage).

Values: `pipeline_apply` on 4 real `gloo` ranks (`tests/_torch_dist_worker.py
pipeline`), with the stage weights as plain tensors and as a DTensor placed
Shard(0) on `model`, against the reference's on 4 forced jax devices (Auto
mesh axes) at 2e-5 max abs, and against a sequential run for one stage
(a (4, 1) mesh: each rank its own one-stage pipeline of 4 layers) and for
fewer micro-batches than stages.

Signature: the port's capture (rank 0 of (4,) ("model",) under the fake
process group) against `trace_from_hlo` of the compiled reference: M + P - 2
`pipeline_hop` permutes (XLA drops the last tick's hop, the port does not
send it) with pairs (0,1), (1,2), (2,3), and one all-reduce of the whole
[M, mb, D] output; read across the packages by the renames of
`tests/test_torch_collectives.py` (HLO's `f32`, ICI as NVLink).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import free_port
from conftest import run_subprocess
from repro.distributed.pipeline import bubble_fraction as jbubble
from repro_torch.distributed.pipeline import bubble_fraction

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5
P_STAGES, M, MB, D = 4, 6, 2, 32
CASES = {   # name: (mesh, axes, stages, layers a stage, micro-batches)
    "reference": ((4,), ("model",), 4, 1, M),
    "fewer_micro_batches": ((4,), ("model",), 4, 1, 2),
    "one_stage": ((4, 1), ("data", "model"), 1, 4, 3),
}


def _case_inputs(name):
    _mesh, _axes, stages, layers, micro = CASES[name]
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((stages * layers, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((micro, MB, D)).astype(np.float32)
    return w.reshape(stages, layers, D, D), x


def _sequential(w, x):
    h = torch.from_numpy(x)
    for wi in torch.from_numpy(w).reshape(-1, D, D):
        h = torch.tanh(h @ wi)
    return h.numpy()


@pytest.mark.parametrize("n_micro,n_stages,want", [(1, 4, 3 / 4), (16, 4, 3 / 19),
                                                   (64, 2, 1 / 65)])
def test_bubble_fraction(n_micro, n_stages, want):
    assert bubble_fraction(n_micro, n_stages) == pytest.approx(want)
    assert bubble_fraction(n_micro, n_stages) == jbubble(n_micro, n_stages)


_SCRIPT = r"""
import json
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

W, X = ({w}, {x})

def rows(tr):
    return [dict(kind=e.kind, scope=e.scope, pairs=e.source_target_pairs,
                 ob=e.operand_bytes, dtype=e.dtype, mult=e.multiplicity,
                 group_size=e.group_size, num_groups=e.num_groups, link=e.link_class,
                 semantic=e.semantic) for e in tr.events]

from repro.core import MeshSpec as JMesh, trace_from_hlo
from repro.distributed.pipeline import pipeline_apply as jpipeline
jmesh = jax.make_mesh((4,), ("model",), axis_types=(AxisType.Auto,))
w = jnp.asarray(np.asarray(W, np.float32))[:, 0]
x = jnp.asarray(np.asarray(X, np.float32))
fn = jax.jit(lambda w, x: jpipeline(lambda wi, h: jnp.tanh(h @ wi), w, x, jmesh, axis="model"))
with jmesh:
    compiled = fn.lower(w, x).compile()
    y = fn(w, x)
ref = trace_from_hlo(compiled.as_text(), JMesh((4,), ("model",)), label="pipe")

from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.core import commcheck, trace_step
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_host_mesh
mesh, spec = make_host_mesh((4,), ("model",), backend="fake", device="cpu")
stage = lambda wi, h: torch.tanh(h @ wi[0])
tw, tx = torch.tensor(W), torch.tensor(X)
run = lambda w, x: pipeline_apply(stage, w, x, mesh, axis="model")
tr = trace_step(run, (tw, tx), mesh, spec, label="pipe")
with FakeTensorMode() as fm:
    ftr = trace_step(run, (fm.from_tensor(tw), fm.from_tensor(tx)), mesh, spec, label="pipe")
print("PIPELINE" + json.dumps({{"y": np.asarray(y).tolist(), "ref": rows(ref), "port": rows(tr),
                               "fake": rows(ftr),
                               "lint": [f.detector for f in commcheck.check_trace(tr)]}}))
"""


@pytest.fixture(scope="module")
def captured():
    w, x = _case_inputs("reference")
    out = run_subprocess(_SCRIPT.format(w=repr(w.tolist()), x=repr(x.tolist())), devices=4,
                         timeout=300)
    line = next(l for l in out.splitlines() if l.startswith("PIPELINE"))
    return json.loads(line[len("PIPELINE"):])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each gloo rank's (plain, DTensor-params) output per case (4 ranks)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    cases = {}
    for name, (mesh, axes, _s, _l, _m) in CASES.items():
        w, x = _case_inputs(name)
        cases[name] = dict(mesh=mesh, axes=axes, w=w, x=x)
    torch.save(cases, tmp / "pipe_inputs.pt")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
                          "pipeline", str(tmp), "1", "4", str(free_port())],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return [torch.load(tmp / f"pipe_{r}.pt", weights_only=False) for r in range(4)]


def test_pipeline_matches_the_reference_on_every_rank(captured, ranks):
    """P 4, M 6: every rank holds the whole [M, mb, D] output (the final
    all-reduce), from plain and from DTensor stage weights, equal to the
    reference's within 2e-5; the reference equals the sequential run."""
    y_ref = np.asarray(captured["y"], np.float32)
    w, x = _case_inputs("reference")
    assert np.abs(y_ref - _sequential(w, x)).max() < F32_TOL
    for r, got in enumerate(ranks):
        for y in got["reference"]:
            assert np.abs(y.numpy() - y_ref).max() < F32_TOL, r


@pytest.mark.parametrize("case", ["fewer_micro_batches", "one_stage"])
def test_pipeline_matches_a_sequential_run(case, ranks):
    w, x = _case_inputs(case)
    want = _sequential(w, x)
    for r, got in enumerate(ranks):
        plain, sharded = got[case]
        assert plain.shape == want.shape
        assert np.abs(plain.numpy() - want).max() < F32_TOL, r
        assert torch.equal(plain, sharded)


def _table(rows, ref=False):
    t = {}
    for r in rows:
        dtype, link = r["dtype"], r["link"]
        if ref:
            dtype = {"f32": "float32"}.get(dtype, dtype)
            link = link.replace("ici.", "nvlink.")
        pairs = tuple(map(tuple, r["pairs"])) if r["pairs"] else None
        key = (r["kind"], r["scope"], pairs, r["ob"], dtype, r["group_size"], r["num_groups"],
               link, r["semantic"])
        t[key] = t.get(key, 0) + r["mult"]
    return t


def test_pipeline_signature_equals_the_compiled_reference(captured):
    """Summed multiplicity per (kind, scope, pairs, operand bytes, dtype, group
    size, groups, link, semantic): no difference to name."""
    assert _table(captured["port"]) == _table(captured["ref"], ref=True)


def test_pipeline_signature_is_m_plus_p_minus_2_hops_and_one_all_reduce(captured):
    hops = [r for r in captured["port"] if r["kind"] == "collective-permute"]
    assert sum(r["mult"] for r in hops) == M + P_STAGES - 2
    assert {(r["scope"], r["semantic"], r["ob"]) for r in hops} == \
        {("pipeline_hop", "pipeline", MB * D * 4)}
    assert hops[0]["pairs"] == [[0, 1], [1, 2], [2, 3]] and hops[0]["group_size"] == 4
    (ar,) = [r for r in captured["port"] if r["kind"] == "all-reduce"]
    assert (ar["ob"], ar["mult"], ar["group_size"]) == (M * MB * D * 4, 1, 4)


def test_pipeline_capture_is_clean_and_the_same_on_fake_tensors(captured):
    assert captured["lint"] == []
    assert _table(captured["fake"]) == _table(captured["port"])
