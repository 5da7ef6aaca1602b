"""The sort dispatch (`repro_torch.distributed.moe_ep`) against the
reference's (`repro.distributed.moe_ep`) and against the port's own einsum
dispatch.

The setup is the reference's `tests/test_moe_ep.py`: the qwen3-moe smoke
config with 8 experts, top-2 and capacity_factor 4.0 (= E/k: no drops), the
reference's seed-0 MoE weights, and x [4, 32, D] from a numpy seed, on a
(2, 4) ("data", "model") mesh.  The reference runs in one subprocess with 8
forced host devices and Auto mesh axes; the port runs on 8 real `gloo`
ranks (`tests/_torch_dist_worker.py moe`) for values, and as rank 0 of the
mesh under the fake process group for the capture.
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
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import moe as moe_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL, AUX_TOL = 2e-5, 1e-6
# the reference test's limits in bf16 (tests/test_moe_ep.py)
BF16_TOL, BF16_AUX_TOL = 0.03, 0.2
GRAD_TOL = 1e-4
X_SHAPE = (4, 32)          # B, S; rows split 2 + 2 over `data`


def _cfg():
    return smoke_config(ARCHS["qwen3-moe-235b-a22b"]).replace(
        num_experts=8, top_k=2, capacity_factor=4.0, compute_dtype="float32")


def _x(cfg):
    rng = np.random.default_rng(7)
    return rng.standard_normal(X_SHAPE + (cfg.d_model,)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# the reference in one subprocess: its sort dispatch's values (fp32 and bf16)
# on the 2x4 mesh and, per data shard, on a 1x4 mesh (the aux of each shard's
# rows); its compiled trace of the gradient; and the port's capture of the
# same forward + backward as rank 0 of the mesh under the fake process group
_REFERENCE = r"""
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from repro.configs import ARCHS as JARCHS, smoke_config as jsmoke
from repro.core import MeshSpec as JMesh, trace_from_hlo
from repro.distributed import sharding as jsh
from repro.distributed.autoshard import activation_sharding as jact
from repro.models import moe as jmoe
from repro.models.meta import materialize, tree_map_meta as jtree_map_meta

out_path, x_path = sys.argv[1], sys.argv[2]
cfg = jsmoke(JARCHS["qwen3-moe-235b-a22b"]).replace(num_experts=8, top_k=2,
                                                     capacity_factor=4.0, moe_dispatch="sort")
params = materialize(jmoe.moe_meta(cfg), jax.random.PRNGKey(0))
x = np.load(x_path)

def mesh(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])

def run(m, xx, dt):
    with jact(m):
        xd = jax.device_put(jnp.asarray(xx).astype(dt), NamedSharding(m, P("data")))
        pd = jax.device_put(params, NamedSharding(m, P()))
        y, aux = jax.jit(lambda p, v: jmoe.apply_moe(cfg, p, v))(pd, xd)
    return np.asarray(y, np.float32), float(aux)

res = {"params": {k: np.asarray(v, np.float32).tolist() for k, v in params.items()}}
for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
    y, aux = run(mesh((2, 4)), x, dt)
    shards = [run(mesh((1, 4)), x[2 * i:2 * i + 2], dt) for i in range(2)]
    res[name] = {"y": y.tolist(), "aux": aux, "shard_aux": [a for _, a in shards],
                 "shard_y": np.concatenate([s for s, _ in shards]).tolist()}

# the reference's compiled trace of the gradient, weights placed by its rules
m = mesh((2, 4))
sizes = dict(zip(m.axis_names, m.devices.shape))
specs = jtree_map_meta(lambda _p, mm: jsh.spec_for(mm.shape, mm.logical, jsh.TRAIN_RULES, sizes),
                       jmoe.moe_meta(cfg))

def loss(p, v):
    y, aux = jmoe.apply_moe(cfg, p, v)
    return (y.astype(jnp.float32) ** 2).mean() + 0.01 * aux

with jact(m):
    fn = jax.jit(jax.grad(loss, argnums=(0, 1)),
                 in_shardings=(jsh.named(m, specs), NamedSharding(m, P("data"))))
    compiled = fn.lower(params, jnp.asarray(x)).compile()
ref = trace_from_hlo(compiled.as_text(), JMesh((2, 4), ("data", "model")), label="moe")

# the port's capture of the same forward + backward
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.core import trace_step
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as pmoe
from repro_torch.models.meta import tree_map_meta
pcfg = cfg.replace(compute_dtype="float32")
pm, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cpu")
psizes = sh.mesh_axis_sizes(pm)
pspecs = tree_map_meta(lambda _p, mm: sh.spec_for(mm.shape, mm.logical, sh.TRAIN_RULES, psizes),
                       pmoe.moe_meta(pcfg))
pp = {k: distribute_tensor(torch.from_numpy(np.asarray(v, np.float32)), pm,
                           sh.placements_for(pspecs[k], pm), src_data_rank=None).requires_grad_()
      for k, v in params.items()}
px = distribute_tensor(torch.from_numpy(x), pm, [Shard(0), Replicate()],
                       src_data_rank=None).requires_grad_()

def step(p, v):
    y, aux = pmoe.apply_moe(pcfg, p, v)
    ((y.float() ** 2).mean() + 0.01 * aux).backward()

with activation_sharding(pm):
    tr = trace_step(step, (pp, px), pm, spec, label="moe")

# the dispatch rule: which (experts, mesh) pairs reach the sort dispatch
from repro_torch.distributed import moe_ep
calls = []
real = moe_ep.apply_moe_sort
moe_ep.apply_moe_sort = lambda *a: calls.append(1) or real(*a)
rule = {}
for e in (8, 6):
    c = pcfg.replace(num_experts=e, top_k=2)
    mp = {k: torch.zeros(m.shape) for k, m in pmoe.moe_meta(c).items()}
    n = len(calls)
    with activation_sharding(pm):
        pmoe.apply_moe(c, mp, px.detach())
    rule[e] = len(calls) - n
moe_ep.apply_moe_sort = real
res["rule"] = rule

def rows(t):
    return [[e.semantic, e.kind, e.link_class, e.multiplicity, e.operand_bytes, e.op_name]
            for e in t.events]
res["ref_trace"], res["port_trace"] = rows(ref), rows(tr)
json.dump(res, open(out_path, "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ref")
    np.save(d / "x.npy", _x(_cfg()))
    code = f"import sys; sys.argv = ['-', {str(d / 'ref.json')!r}, {str(d / 'x.npy')!r}]\n"
    run_subprocess(code + _REFERENCE, devices=8, timeout=500)
    with open(d / "ref.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    """The port's runs on 8 gloo ranks (`_torch_dist_worker.MOE_RUNS`)."""
    d = tmp_path_factory.mktemp("moe_port")
    cfg = _cfg()
    params = {k: torch.tensor(v, dtype=torch.float32) for k, v in reference["params"].items()}
    torch.save({"cfg": cfg, "params": params, "x": torch.from_numpy(_x(cfg))},
               d / "moe_inputs.pt")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
                          "moe", str(d), "2", "4", str(free_port())],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return torch.load(d / "moe.pt", weights_only=False)


def _einsum(cfg, params, x, shards):
    """The port's einsum dispatch without a mesh on each of `shards` row blocks
    of x, y concatenated and aux averaged, and the gradients of
    mean(y^2) + 0.01 * aux: the sort dispatch's maths at no-drop capacity."""
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    outs = [moe_mod.apply_moe(cfg.replace(moe_dispatch="einsum"), p, xs)
            for xs in xt.chunk(shards)]
    y = torch.cat([o[0] for o in outs])
    aux = sum(o[1] for o in outs) / shards
    ((y ** 2).mean() + 0.01 * aux).backward()
    return {"y": y.detach(), "aux": float(aux.detach()),
            "grads": {"x": xt.grad, **{k: t.grad for k, t in p.items()}}}


@pytest.fixture(scope="module")
def plain(reference):
    cfg = _cfg()
    params = {k: torch.tensor(v, dtype=torch.float32) for k, v in reference["params"].items()}
    return {n: _einsum(cfg, params, _x(cfg), n) for n in (1, 2)}


def test_sort_matches_the_reference_sort_dispatch_fp32(reference, port):
    """fp32 output within 2e-5; aux within 1e-6 of the mean of the reference's
    per-data-shard aux.  The reference's own aux is data shard 0's (its output
    is declared replicated while each data shard computes its own), which the
    port does not copy: it reports the mean, whose gradient both take."""
    ref, got = reference["float32"], port["sort"]
    assert _rel(got["y"], ref["y"]) < F32_TOL
    assert _rel(ref["shard_y"], ref["y"]) == 0.0
    assert ref["aux"] == ref["shard_aux"][0] != ref["shard_aux"][1]
    assert abs(got["aux"] - np.mean(ref["shard_aux"])) < AUX_TOL


def test_sort_matches_the_reference_sort_dispatch_bf16(reference, port):
    """bf16 within the reference test's limits (0.03 relative, aux 0.2)."""
    ref, got = reference["bfloat16"], port["sort_bf16"]
    assert _rel(got["y"], ref["y"]) < BF16_TOL
    assert abs(got["aux"] - ref["aux"]) < BF16_AUX_TOL


def test_sort_matches_einsum_at_no_drop_capacity_with_gradients(port, plain):
    """At capacity_factor = E/k nothing drops in either dispatch, so the sort
    dispatch on the 2x4 mesh equals the einsum dispatch run per data shard:
    output and aux in fp32, and the gradients of x and every weight (finite,
    non-zero) within 1e-4."""
    got, want = port["sort"], plain[2]
    assert _rel(got["y"], want["y"]) < F32_TOL
    assert abs(got["aux"] - want["aux"]) < AUX_TOL
    for name, g in got["grads"].items():
        g = g.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, name
        assert _rel(g, want["grads"][name]) < GRAD_TOL, name


def test_einsum_on_a_mesh_is_unchanged(port, plain):
    """`moe_dispatch="einsum"` on the 2x4 mesh runs the einsum dispatch: its
    output, aux and gradients equal the einsum dispatch without a mesh."""
    got, want = port["einsum"], plain[1]
    assert _rel(got["y"], want["y"]) < F32_TOL
    assert abs(got["aux"] - want["aux"]) < AUX_TOL
    for name, g in got["grads"].items():
        assert _rel(g, want["grads"][name]) < GRAD_TOL, name


def test_sort_falls_through_to_einsum(reference, monkeypatch):
    """The reference's rule: under a mesh whose `model` size (4) divides the
    experts (8) the sort dispatch runs, with 6 experts it falls through to the
    einsum dispatch (counted in the subprocess); without a mesh it is the
    einsum dispatch, value for value."""
    assert reference["rule"] == {"8": 1, "6": 0}
    from repro_torch.distributed import moe_ep

    def refuse(*a):
        raise AssertionError("the sort dispatch ran without a mesh")
    monkeypatch.setattr(moe_ep, "apply_moe_sort", refuse)
    cfg = _cfg()
    params = {k: torch.tensor(v, dtype=torch.float32) for k, v in reference["params"].items()}
    x = torch.from_numpy(_x(cfg))
    ys, auxs = moe_mod.apply_moe(cfg.replace(moe_dispatch="sort"), params, x)
    ye, auxe = moe_mod.apply_moe(cfg, params, x)
    assert torch.equal(ys, ye) and torch.equal(auxs, auxe)


def _link(s: str) -> str:
    return s.replace("ici.", "nvlink.").replace("dci.", "ib.")


# (semantic, kind, link): (reference multiplicity, port multiplicity, why), for
# the gradient of mean(y^2) + 0.01 * aux through the sort dispatch on 2x4
DIFFERENCES = {
    ("moe_dispatch", "all-reduce", "nvlink.data"): (0, 1, (
        "the aux loss's mean over the data shards (a scalar, `moe/router`); the "
        "reference declares each shard's aux replicated and reduces nothing")),
    ("moe_dispatch", "all-reduce", "nvlink.model"): (0, 1, (
        "the same scalar's sum over model (DTensor reduces a two-dim Partial "
        "one mesh dim at a time)")),
    ("grad_sync", "all-reduce", "nvlink.data"): (1, 0, (
        "XLA all-reduces the three expert gradients over data in one combined "
        "buffer; the port reduce-scatters each to its FSDP shard (next row)")),
    ("grad_sync", "reduce-scatter", "nvlink.data"): (0, 4, (
        "each weight's gradient (router, w_gate, w_up, w_down) reduce-scattered "
        "over data back to its FSDP shard")),
    ("moe_combine", "all-reduce", "nvlink.mixed(data+model)"): (1, 0, (
        "XLA reduces the router's gradient over data and model at once; the port "
        "over data in the reduce-scatter above and over model in one of the three "
        "moe_combine all-reduces below")),
}


def _table(rows, rename=False):
    t = {}
    for sem, kind, link, mult, _ob, _op in rows:
        key = (sem, kind, _link(link) if rename else link)
        t[key] = t.get(key, 0) + mult
    return t


def test_capture_of_the_sort_dispatch_against_the_reference_trace(reference):
    """Forward + backward of `apply_moe` (sort) on 2x4: the port's capture and
    the reference's compiled trace of the same gradient, by (semantic, kind,
    link) multiplicity, equal except where `DIFFERENCES` names the gap.  Both
    have the combine's sum over `model` (`moe_combine`, in the `combine` scope)
    and no all-to-all.  The three `moe_combine` all-reduces over model are, in
    both, the forward combine and the input gradient's sum; the third is the
    reference's transposed psum of the output and the port's router gradient."""
    ref, port = reference["ref_trace"], reference["port_trace"]
    for rows, link in ((ref, "ici.model"), (port, "nvlink.model")):
        assert not any(r[1] == "all-to-all" for r in rows)
        assert any(r[0] == "moe_combine" and r[1] == "all-reduce" and r[2] == link
                   and "combine/" in r[5] and "transpose" not in r[5] for r in rows)
    got, want = _table(port), _table(ref, rename=True)
    for key in sorted(set(got) | set(want)):
        pair = (want.get(key, 0), got.get(key, 0))
        if pair[0] != pair[1]:
            assert key in DIFFERENCES and DIFFERENCES[key][:2] == pair, (key, pair)
    for key, (r, p, why) in DIFFERENCES.items():
        assert (want.get(key, 0), got.get(key, 0)) == (r, p) and why, key
