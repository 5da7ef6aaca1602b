"""The explicit all-reduce algorithms and `ppermute` in the port against the
reference's (`distributed/algorithms.py`, `jax.lax.ppermute`).

Values: each algorithm on 8 real `gloo` ranks (`tests/_torch_dist_worker.py
collectives`), on an (8,) ("data",) mesh over `data` and on a (2, 4)
("data", "model") mesh over `model`, with a numpy-seeded fp32 payload whose
rank-local length (50) is not a multiple of the group (the pad path),
against the reference's `allreduce_fn` on 8 forced jax devices (Auto mesh
axes) at 2e-5 max abs; `ppermute`'s output (zeros where no pair targets a
rank) and its gradient against `jax.grad` through `jax.lax.ppermute`.

Signatures: the port's capture (rank 0 under the fake process group) of
each algorithm on both meshes against `trace_from_hlo` of the compiled
reference: the summed multiplicity per (kind, scope, pairs, operand bytes,
dtype, group size, groups, link, semantic).  Names are read across the
packages by three renames: the reference's scope starts with its jitted
function's name (`jit(run)` gives `run/`), HLO writes `f32` for float32,
and ICI links read as NVLink.  Every other difference is named in
`DIFFERENCES`.  Also: the captures on fake tensors equal those on real
ones, commcheck finds nothing in any capture and flags a corrupted pair
table as the reference does, and the captured ring's and recursive
doubling's modelled times equal `costmodel.allreduce_time`'s closed forms.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import free_port
from conftest import run_subprocess
from repro.core import commcheck as jcommcheck
from repro.core.events import CollectiveEvent as JEvent
from repro.core.store import TraceStore as JStore
from repro.core.topology import MeshSpec as JMesh
from repro_torch.core import commcheck, costmodel
from repro_torch.core.events import CollectiveEvent
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import H100, MeshSpec
from repro_torch.distributed.ppermute import check_pairs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5
MESHES = {"8": ((8,), ("data",), "data"), "2x4": ((2, 4), ("data", "model"), "model")}
# the port's algorithm names -> the reference's
REF_NAME = {"builtin": "xla", "ring": "ring", "rsag": "rsag",
            "recursive_doubling": "recursive_doubling"}
ROWS_PER_RANK, COLS = 2, 25             # 50 elements a rank: not a multiple of 4 or 8
PAIRS = [(0, 1), (1, 2), (2, 0), (3, 3), (5, 4), (4, 6)]   # 5 and 7 untargeted
BAD_PAIRS = [[(0, 1), (0, 2)], [(0, 1), (2, 1)], [(0, 8)]]
PIN_ELEMENTS = 1 << 16                  # the cost-model pin's payload, a multiple of 8


def _inputs():
    rng = np.random.default_rng(0)
    x = {name: rng.standard_normal((ROWS_PER_RANK * dict(zip(axes, shape))[axis], COLS))
         .astype(np.float32) for name, (shape, axes, axis) in MESHES.items()}
    return dict(x=x, p_x=rng.standard_normal((8, 5)).astype(np.float32),
                p_w=rng.standard_normal((8, 5)).astype(np.float32))


_SCRIPT = r"""
import json
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import AxisType, PartitionSpec as P

INP = {inputs}
MESHES = {meshes}
REF_NAME = {ref_name}
PAIRS = {pairs}
PIN = {pin}

def rows(tr):
    return [dict(kind=e.kind, scope=e.scope, pairs=e.source_target_pairs,
                 ob=e.operand_bytes, dtype=e.dtype, mult=e.multiplicity,
                 group_size=e.group_size, num_groups=e.num_groups, link=e.link_class,
                 semantic=e.semantic, groups=e.replica_groups, est=e.est_time_s)
            for e in tr.events]

# the reference: values and compiled traces
from repro.core import MeshSpec as JMesh, trace_from_hlo
from repro.distributed.algorithms import allreduce_fn as jallreduce_fn
out = {{"ref": {{}}, "port": {{}}, "fake": {{}}, "lint": {{}}}}
for name, (shape, axes, axis) in MESHES.items():
    jmesh = jax.make_mesh(tuple(shape), tuple(axes), axis_types=(AxisType.Auto,) * len(axes))
    x = jnp.asarray(np.asarray(INP["x"][name], np.float32))
    for alg, jalg in REF_NAME.items():
        fn = jax.jit(jallreduce_fn(jalg, jmesh, axis))
        with jmesh:
            compiled = fn.lower(x).compile()
            y = fn(x)
        tr = trace_from_hlo(compiled.as_text(), JMesh(tuple(shape), tuple(axes)), label=alg)
        out["ref"][name + "/" + alg] = {{"rows": rows(tr), "y": np.asarray(y).tolist()}}

# ppermute through jax.grad
jmesh = jax.make_mesh((8,), ("data",), axis_types=(AxisType.Auto,))
px, pw = (jnp.asarray(np.asarray(INP[k], np.float32)) for k in ("p_x", "p_w"))
perm = shard_map(lambda a: jax.lax.ppermute(a, "data", PAIRS), mesh=jmesh,
                 in_specs=P("data"), out_specs=P("data"), check_rep=False)
loss = lambda a, w: jnp.sum(jnp.sin(perm(a)) * w)
with jmesh:
    out["ppermute"] = {{"y": np.asarray(jax.jit(perm)(px)).tolist(),
                        "grad": np.asarray(jax.jit(jax.grad(loss))(px, pw)).tolist()}}

# the port: rank 0 under the fake process group, on real and on fake tensors
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.core import commcheck, trace_step
from repro_torch.core.topology import H100, MeshSpec
from repro_torch.distributed.algorithms import allreduce_fn
from repro_torch.launch.mesh import make_host_mesh
for name, (shape, axes, axis) in MESHES.items():
    mesh, spec = make_host_mesh(tuple(shape), tuple(axes), backend="fake", device="cpu")
    n = dict(zip(axes, shape))[axis]
    x = torch.from_numpy(np.asarray(INP["x"][name], np.float32))[:len(INP["x"][name]) // n]
    for alg in REF_NAME:
        tr = trace_step(allreduce_fn(alg, mesh, axis), (x,), mesh, spec, label=alg)
        out["port"][name + "/" + alg] = rows(tr)
        out["lint"][name + "/" + alg] = [f.detector for f in commcheck.check_trace(tr)]
        with FakeTensorMode() as fm:
            fx = fm.from_tensor(x)
            ftr = trace_step(allreduce_fn(alg, mesh, axis), (fx,), mesh, spec, label=alg)
        out["fake"][name + "/" + alg] = rows(ftr)
    if name == "8":
        # the cost-model pin: a payload that 8 divides, on NVLink and with data on IB
        big = torch.ones(PIN, dtype=torch.float32)
        ib = MeshSpec(spec.shape, spec.axes, axis_kind={{"data": "ib"}})
        out["pin"] = {{}}
        for alg in ("ring", "recursive_doubling", "rsag"):
            tr = trace_step(allreduce_fn(alg, mesh, axis), (big,), mesh, spec, label=alg)
            ib_store = tr.store.annotation_clone()
            from repro_torch.core import costmodel
            costmodel.annotate_store(ib_store, ib, H100)
            out["pin"][alg] = [tr.total_est_time_s(), float(ib_store.total_est_time_s())]
print("COLLECTIVES" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def captured():
    inp = _inputs()
    code = _SCRIPT.format(
        inputs=repr({k: ({n: a.tolist() for n, a in v.items()} if isinstance(v, dict)
                         else v.tolist()) for k, v in inp.items()}),
        meshes=repr(MESHES), ref_name=repr(REF_NAME), pairs=repr(PAIRS), pin=PIN_ELEMENTS)
    out = run_subprocess(code, devices=8, timeout=400)
    line = next(l for l in out.splitlines() if l.startswith("COLLECTIVES"))
    return json.loads(line[len("COLLECTIVES"):])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each gloo rank's results (8 ranks, `collectives` mode)."""
    tmp = tmp_path_factory.mktemp("collectives")
    inp = _inputs()
    torch.save({**inp, "meshes": MESHES, "pairs": PAIRS, "bad_pairs": BAD_PAIRS},
               tmp / "coll_inputs.pt")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
                          "collectives", str(tmp), "8", "1", str(free_port())],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return [torch.load(tmp / f"coll_{r}.pt", weights_only=False) for r in range(8)]


# --------------------------------------------------------------------------
# values
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("alg", sorted(REF_NAME))
def test_algorithm_values_match_the_reference(alg, mesh, captured, ranks):
    """Every rank's output against the reference's output shard at 2e-5: the
    rank at axis coordinate i holds shard i of the reference's (the sum of
    every shard of the group); on (8,) the DTensor path gives the same
    local values with the input's placements."""
    shape, axes, axis = MESHES[mesh]
    y_ref = np.asarray(captured["ref"][f"{mesh}/{alg}"]["y"], np.float32)
    n = dict(zip(axes, shape))[axis]
    x = _inputs()["x"][mesh]
    np.testing.assert_allclose(y_ref[:ROWS_PER_RANK],
                               x.reshape(n, ROWS_PER_RANK, COLS).sum(0), atol=1e-5)
    for r, got in enumerate(ranks):
        i = np.unravel_index(r, shape)[axes.index(axis)]
        want = y_ref[i * ROWS_PER_RANK:(i + 1) * ROWS_PER_RANK]
        assert np.abs(got[mesh, alg].numpy() - want).max() < F32_TOL, (r, alg)
        if len(shape) == 1:
            local, same_placements = got[mesh, alg, "dtensor"]
            assert same_placements and torch.equal(local, got[mesh, alg])


def test_ppermute_moves_copies_and_zeros_as_jax(captured, ranks):
    """Each rank's output equals jax.lax.ppermute's: the source's x, its own x
    for a self pair, zeros where no pair targets the rank."""
    y_ref = np.asarray(captured["ppermute"]["y"], np.float32)
    x = _inputs()["p_x"]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ppermute"][0].numpy(), y_ref[r])
    assert not y_ref[[5, 7]].any()
    np.testing.assert_array_equal(y_ref[3], x[3])
    np.testing.assert_array_equal(y_ref[1], x[0])


def test_ppermute_gradient_matches_jax_grad(captured, ranks):
    """The gradient of sum(sin(ppermute(x)) * w) is the inverse permute of the
    cotangent: cos(x_s) w_t at each source s, zero where a rank sends nothing."""
    g_ref = np.asarray(captured["ppermute"]["grad"], np.float32)
    for r, got in enumerate(ranks):
        assert np.abs(got["ppermute"][1].numpy() - g_ref[r]).max() < F32_TOL, r
    assert not g_ref[[6, 7]].any()


def test_ppermute_raises_on_bad_pairs_on_every_rank(ranks):
    for got in ranks:
        assert got["raised"] == [True] * len(BAD_PAIRS)


@pytest.mark.parametrize("pairs,message", [
    ([(0, 1), (0, 2)], "repeat a source"), ([(0, 1), (2, 1)], "repeat a target"),
    ([(0, 8)], "outside a group of 8"), ([(-1, 0)], "outside a group of 8")])
def test_check_pairs_refuses_what_jax_refuses(pairs, message):
    with pytest.raises(ValueError, match=message):
        check_pairs(pairs, 8)
    assert check_pairs([(0, 1), (1, 0), (2, 2)], 8) == [(0, 1), (1, 0), (2, 2)]


def test_ppermute_fake_implementation_runs_under_fake_tensor_mode():
    """Under FakeTensorMode the op answers from its fake implementation: a fake
    tensor of x's shape and dtype, with no process group looked up."""
    import repro_torch.distributed.ppermute  # noqa: F401  (registers the op)
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    with FakeTensorMode() as fm:
        x = fm.from_tensor(torch.ones(3, 4, dtype=torch.bfloat16))
        y = torch.ops.repro_torch.ppermute(x, [0], [1], "no such group")
    assert isinstance(y, FakeTensor) and y.shape == (3, 4) and y.dtype == torch.bfloat16


def test_make_host_mesh_fake_without_a_device_needs_a_card():
    """A fake mesh with no `device` goes on the card, as every entry point;
    without one it raises before any process group is made."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mesh would go on it")
    had = dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh((2, 4), ("data", "model"), backend="fake")
    assert dist.is_initialized() == had


# --------------------------------------------------------------------------
# signatures
# --------------------------------------------------------------------------

# (mesh, algorithm, kind, scope): (reference operand bytes, port operand bytes, why).
# An all-gather's payload is its gathered bytes in both packages.
DIFFERENCES = {
    ("8", "rsag", "reduce-scatter", "rsag_rs"): (28, 224, (
        "both take a reduce-scatter's payload as its pre-scatter input, but the "
        "reference's parser reads it as the result shard times the group only "
        "for iota replica groups (hlo_parser.py:431-436); these groups are "
        "explicit, so it falls back to the result shard (7 elements) where the "
        "port records the padded 56-element input")),
    ("2x4", "rsag", "reduce-scatter", "rsag_rs"): (52, 208, (
        "as on (8,): the reference's non-iota fallback reads the result shard "
        "(13 elements) against the padded input (52)")),
}
_HLO_DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def _key(row, ref: bool):
    scope, dtype, link = row["scope"], row["dtype"], row["link"]
    if ref:     # the three renames of the module's docstring
        scope = re.sub(r"^run(/|$)", "", scope)
        dtype = _HLO_DTYPES.get(dtype, dtype)
        link = link.replace("ici.", "nvlink.")
    pairs = tuple(map(tuple, row["pairs"])) if row["pairs"] else None
    return (row["kind"], scope, pairs, row["ob"], dtype, row["group_size"],
            row["num_groups"], link, row["semantic"])


def _table(rows, ref=False):
    t = {}
    for r in rows:
        k = _key(r, ref)
        t[k] = t.get(k, 0) + r["mult"]
    return t


def signature_tables(captured, mesh, alg):
    """(the reference's table with every `DIFFERENCES` reading of its own
    replaced by the port's, the port's table)."""
    ref = _table(captured["ref"][f"{mesh}/{alg}"]["rows"], ref=True)
    for (m, a, kind, scope), (r_ob, p_ob, why) in DIFFERENCES.items():
        if (m, a) != (mesh, alg):
            continue
        (key,) = [k for k in ref if k[:2] == (kind, scope) and k[3] == r_ob]
        ref[key[:3] + (p_ob,) + key[4:]] = ref.pop(key)
        assert why
    return ref, _table(captured["port"][f"{mesh}/{alg}"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("alg", sorted(REF_NAME))
def test_capture_signature_equals_the_compiled_reference(alg, mesh, captured):
    """Summed multiplicity per (kind, scope, pairs, operand bytes, dtype, group
    size, groups, link, semantic), equal but for `DIFFERENCES`."""
    ref, port = signature_tables(captured, mesh, alg)
    assert port == ref


def test_signatures_have_the_reference_s_shapes(captured):
    """What the tables above hold, spelled out: the ring 2 (n-1) hops of the
    padded payload / n with pairs (i, i+1 mod n) in every group of the layout
    (the whole mesh's table, group size 8 as the parser gives a permute),
    recursive doubling log2 n rounds of the whole payload with pairs i ^ 2^k,
    rsag one reduce-scatter and one all-gather, builtin one all-reduce; every
    site `other`."""
    port = captured["port"]
    ring8 = port["8/ring"]
    assert sum(r["mult"] for r in ring8) == 14 and {r["ob"] for r in ring8} == {28}
    assert all(r["pairs"] == [[i, (i + 1) % 8] for i in range(8)] for r in ring8)
    ring24 = port["2x4/ring"]
    assert sum(r["mult"] for r in ring24) == 6 and {r["ob"] for r in ring24} == {52}
    assert ring24[0]["pairs"] == [[g + i, g + (i + 1) % 4] for g in (0, 4) for i in range(4)]
    assert {(r["group_size"], r["num_groups"]) for r in ring8 + ring24} == {(8, 1)}
    rd = port["8/recursive_doubling"]
    assert [r["pairs"] for r in rd] == [[[i, i ^ (1 << k)] for i in range(8)] for k in range(3)]
    assert [r["scope"] for r in rd] == [f"recdbl_round{k}" for k in range(3)]
    assert {r["ob"] for r in rd} == {200}
    assert [r["kind"] for r in port["8/rsag"]] == ["reduce-scatter", "all-gather"]
    assert [(r["kind"], r["ob"]) for r in port["8/builtin"]] == [("all-reduce", 200)]
    assert {r["semantic"] for rows in port.values() for r in rows} == {"other"}


def test_captures_on_fake_tensors_equal_those_on_real_ones(captured):
    for name, rows in captured["port"].items():
        assert _table(captured["fake"][name]) == _table(rows), name


def test_commcheck_finds_nothing_in_the_captures(captured):
    assert captured["lint"] == {name: [] for name in captured["port"]}


def _events(cls, rows):
    return [cls(name=f"%{r['kind']}.{i}", kind=r["kind"], async_start=False,
                operand_bytes=r["ob"], result_bytes=r["ob"], dtype="f32",
                replica_groups=r["groups"], group_size=r["group_size"],
                num_groups=r["num_groups"], op_name=f"{r['scope']}/ppermute", computation="c",
                multiplicity=r["mult"],
                source_target_pairs=[tuple(p) for p in r["pairs"]] if r["pairs"] else None)
            for i, r in enumerate(rows)]


@pytest.mark.parametrize("corrupt", ["dup_target", "out_of_range", "self_loop"])
def test_a_corrupted_pair_table_is_flagged_as_the_reference_flags_it(captured, corrupt):
    """The captured (8,) ring with one pair of its table broken: both packages'
    commcheck give the same findings (detector, severity, message)."""
    rows = [dict(r, pairs=[list(p) for p in r["pairs"]]) for r in captured["port"]["8/ring"]]
    pairs = rows[0]["pairs"]
    pairs[-1] = {"dup_target": [7, 1], "out_of_range": [7, 9], "self_loop": [7, 7]}[corrupt]
    findings = []
    for ev_cls, st_cls, mesh_cls, check in (
            (JEvent, JStore, JMesh, jcommcheck.check_store),
            (CollectiveEvent, TraceStore, MeshSpec, commcheck.check_store)):
        store = st_cls.from_events(_events(ev_cls, rows))
        findings.append([(f.detector, f.severity, f.message)
                         for f in check(store, mesh_cls((8,), ("data",)))])
    assert findings[0] == findings[1] and findings[0]
    code = {"dup_target": "permute_dup_target", "out_of_range": "device_out_of_range",
            "self_loop": "permute_self_loop"}[corrupt]
    assert code in {f[0] for f in findings[1]}


_GATHER = r"""
import json
import torch
import torch.distributed._functional_collectives as fc
from repro_torch.core import trace_step
from repro_torch.launch.mesh import make_host_mesh
mesh, spec = make_host_mesh((2,), ("data",), backend="fake", device="cpu")
x = torch.ones({k} // 4, dtype=torch.float32)
def step(t):
    return fc.reduce_scatter_tensor(fc.all_gather_tensor(t, 0, mesh), "sum", 0, mesh)
tr = trace_step(step, (x,), mesh, spec, label="gather")
print("GATHER" + json.dumps([[e.kind, e.operand_bytes, e.result_bytes,
                              e.wire_bytes_per_device, e.group_size] for e in tr.events]))
"""


def test_an_all_gather_is_captured_on_its_gathered_bytes():
    """A hand-built 2-rank all-gather of k bytes of input (rank 0 of (2,)
    under the fake group): its operand is the gathered 2k bytes, as the
    reference's parser reads an all-gather, and the cost model's (n-1)/n of
    it, k, is what each rank sends; the reduce-scatter of that 2k back to k
    keeps its 2k input as its operand."""
    k = 4096
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, "-c", _GATHER.format(k=k)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(l for l in res.stdout.splitlines() if l.startswith("GATHER"))
    assert json.loads(line[len("GATHER"):]) == [["all-gather", 2 * k, 2 * k, k, 2],
                                                ["reduce-scatter", 2 * k, k, k, 2]]


@pytest.mark.parametrize("link", ["nvlink", "ib"])
@pytest.mark.parametrize("alg", ["ring", "recursive_doubling"])
def test_captured_modelled_time_equals_the_closed_form(alg, link, captured):
    """On (8,), 2 (n-1) hops of b/n (ring) or log2 n hops of b (recursive
    doubling), each priced by the per-event model, sum to `allreduce_time` at
    the port's ring directions; on NVLink and with `data` on InfiniBand."""
    nv, ib = captured["pin"][alg]
    bw, lat = ((H100.nvlink_bw, H100.nvlink_latency_s) if link == "nvlink"
               else (H100.ib_bw, H100.ib_latency_s))
    closed = costmodel.allreduce_time(alg, PIN_ELEMENTS * 4, 8, bw, lat, H100)
    assert closed == pytest.approx(nv if link == "nvlink" else ib, rel=1e-12)


@pytest.mark.parametrize("link", ["nvlink", "ib"])
def test_captured_rsag_time_is_its_closed_form_but_for_the_latency_hops(link, captured):
    """On (8,), rsag's reduce-scatter of b and all-gather of b (its gathered
    bytes) move 2 (n-1)/n b, the closed form's bandwidth term, to 1e-12; the
    per-event model prices each of the two ring phases' n-1 hops, where the
    closed form (`reduce_scatter_allgather`) takes 2 log2 n, so the two
    differ by (2 (n-1) - 2 log2 n) hop latencies (8 at n = 8)."""
    nv, ib = captured["pin"]["rsag"]
    bw, lat = ((H100.nvlink_bw, H100.nvlink_latency_s) if link == "nvlink"
               else (H100.ib_bw, H100.ib_latency_s))
    closed = costmodel.allreduce_time("reduce_scatter_allgather", PIN_ELEMENTS * 4, 8, bw,
                                      lat, H100)
    got = nv if link == "nvlink" else ib
    assert got - 2 * 7 * lat == pytest.approx(closed - 2 * 3 * lat, rel=1e-12)
    ring = costmodel.allreduce_time("ring", PIN_ELEMENTS * 4, 8, bw, lat, H100)
    assert got == pytest.approx(ring, rel=1e-12)
