"""The profiler's front half in the port against the reference's.

Part 1: the copied modules (`events`, `topology`, `store`, `costmodel`,
`attribution`, `roofline`) on the same hand-built `CollectiveEvent`s: the
same attribution, wire bytes, rollups and merges; the costs differ only by
`Hardware` (priced with the reference's TPU constants in the port's
`Hardware`, they are equal).

Part 2: the capture of the port's sharded train step against the
reference's compiled trace, at the reference system test's smoke widths
(chatglm3, d_model 128, d_ff 256, 4 layers, vocab 512, 8 heads, 4 kv heads,
head_dim 16; accum 2, remat "full"; global batch 8 x 64) on a (2, 4)
("data", "model") mesh: the reference on an Auto-axes jax mesh over 8 host
devices, the port as rank 0 of a DeviceMesh under the fake process group.
Links compare with `ici.` read as `nvlink.` (one node).  Held: the
reference's 13-row table; the same semantics; `grad_sync` on `data`;
layer x micro-batch multiplicity; the `grad_sync` bytes rule; and every
difference in the (semantic, kind, link) table, named in `DIFFERENCES`
with the DTensor strategy behind it.
"""
import json

import numpy as np
import pytest

from conftest import run_subprocess
from repro.core import attribution as jattr
from repro.core import costmodel as jcost
from repro.core.roofline import roofline as jroofline
from repro.core.events import CollectiveEvent as JEvent
from repro.core.events import Trace as JTrace
from repro.core.store import TraceStore as JStore
from repro.core.topology import MeshSpec as JMesh
from repro.core.topology import V5E
from repro_torch.core import attribution, costmodel
from repro_torch.core.events import CollectiveEvent, Trace
from repro_torch.core.roofline import roofline
from repro_torch.core.store import TraceStore
from repro_torch.core.topology import H100, Hardware, MeshSpec

# --------------------------------------------------------------------------
# part 1: the copies on hand-built events
# --------------------------------------------------------------------------

_G_DATA = [[0, 4], [1, 5], [2, 6], [3, 7]]
_G_MODEL = [[0, 1, 2, 3], [4, 5, 6, 7]]
_G_ALL = [list(range(8))]
_EVENTS = [
    # kind, operand, result, groups, op_name, multiplicity, permute pairs
    ("all-reduce", 74240, 74240, _G_DATA,
     "jit(step)/transpose(jvp(layer))/checkpoint/layer/bsd,dh->bsh/dot_general", 8, None),
    ("all-gather", 16384, 65536, _G_MODEL, "jit(step)/jvp(layer)/attn/bsz,zd->bsd/dot_general", 8, None),
    ("all-reduce", 65536, 65536, _G_MODEL, "jit(step)/layer/mlp/bsf,fd->bsd/dot_general", 16, None),
    ("reduce-scatter", 4096, 1024, _G_ALL, "jit(step)/transpose(jvp(loss))/reduce_sum", 2, None),
    ("all-to-all", 1 << 20, 1 << 20, _G_MODEL, "jit(step)/layer/moe/dispatch/all_to_all", 4, None),
    ("all-reduce", 4, 4, _G_DATA, "jit(step)/optimizer/reduce_sum", 1, None),
    ("collective-permute", 8192, 8192, [], "jit(step)/pipeline/ppermute", 3,
     [(0, 4), (4, 0), (1, 5), (5, 1)]),
    ("all-gather", 128, 512, _G_MODEL, "transpose(jvp)/layer/_c10d_functional.all_gather_into_tensor",
     5, None),
    ("all-reduce", 512, 512, _G_DATA, "grad_sync/_c10d_functional.all_reduce", 9, None),
]


def _events(cls):
    out = []
    for i, (kind, ob, rb, groups, op, mult, pairs) in enumerate(_EVENTS):
        gs = len(groups[0]) if groups else 2
        out.append(cls(name=f"%{kind}.{i}", kind=kind, async_start=False, operand_bytes=ob,
                       result_bytes=rb, dtype="f32", replica_groups=groups, group_size=gs,
                       num_groups=len(groups) or 1, op_name=op, computation="main",
                       multiplicity=mult, source_target_pairs=pairs))
    return out


def _link(s: str) -> str:
    return (s.replace("ici.", "nvlink.").replace("dci.", "ib.")
            .replace("xpod.mixed", "xnode.mixed"))


def _v5e_in_port() -> Hardware:
    """The reference's TPU constants in the port's Hardware (ICI as NVLink, DCI
    as InfiniBand, the torus ring's two directions)."""
    return Hardware(name="v5e-constants", flops_bf16=V5E.flops_bf16, hbm_bw=V5E.hbm_bw,
                    nvlink_bw=V5E.ici_bw, ib_bw=V5E.dci_bw,
                    nvlink_latency_s=V5E.ici_latency_s, ib_latency_s=V5E.dci_latency_s,
                    hbm_per_chip=V5E.hbm_per_chip, ring_directions=2,
                    rndv_threshold=V5E.rndv_threshold)


def _stores(mesh_axes=("data", "model"), shape=(2, 4), hw=None):
    js, ps = JStore.from_events(_events(JEvent)), TraceStore.from_events(_events(CollectiveEvent))
    jmesh = JMesh(shape, mesh_axes)
    pmesh = MeshSpec(shape, mesh_axes, axis_kind={
        a: ("ib" if k == "dci" else "nvlink") for a, k in jmesh.axis_kind.items()})
    jcost.annotate_store(js, jmesh, V5E)
    costmodel.annotate_store(ps, pmesh, hw or _v5e_in_port())
    jattr.attribute_store(js)
    attribution.attribute_store(ps)
    return js, ps


@pytest.mark.parametrize("mesh", [(("data", "model"), (2, 4)), (("pod", "model"), (2, 4))])
def test_copies_attribute_and_price_as_the_reference(mesh):
    """Row by row: axes, link class (renamed), semantic, scope, primitive,
    protocol, wire bytes and modelled time, on an intra-node and a two-kind mesh."""
    js, ps = _stores(*mesh)
    for a, b in zip(js.rows(), ps.rows()):
        assert (a.axes, _link(a.link_class), a.semantic, a.scope, a.jax_prim, a.protocol) == \
            (b.axes, b.link_class, b.semantic, b.scope, b.jax_prim, b.protocol)
        assert a.wire_bytes_per_device == b.wire_bytes_per_device
        np.testing.assert_allclose(b.est_time_s, a.est_time_s, rtol=1e-12)
    # the port's own markers: backward scope and grad_sync scope
    sems = [e.semantic for e in ps.rows()]
    assert sems[-2:] == ["other", "grad_sync"]
    assert attribution.is_backward(_EVENTS[-2][4])


def test_copies_roll_up_and_merge_as_the_reference():
    """by_semantic, by_kind_and_link (renamed links), by_site, totals, and a
    merge of two stores, equal between the packages."""
    js, ps = _stores()
    assert js.by_semantic() == ps.by_semantic()
    assert {_link(k): v for k, v in js.by_kind_and_link().items()} == ps.by_kind_and_link()
    assert js.total_wire_bytes() == ps.total_wire_bytes()
    assert js.total_collective_bytes() == ps.total_collective_bytes()
    jm, pm = JStore.merge([js, js]), TraceStore.merge([ps, ps])
    assert jm.n == pm.n == 2 * len(_EVENTS)
    assert [r.multiplicity for r in jm.rows()] == [r.multiplicity for r in pm.rows()]
    assert jm.by_semantic() == pm.by_semantic()


def test_costs_differ_only_by_hardware():
    """On H100 constants the same events cost what the model gives for NVLink
    and InfiniBand; the wire bytes do not move, and an axis moved to IB costs
    more than on NVLink."""
    js, ps = _stores(hw=H100)
    assert [r.wire_bytes_per_device for r in js.rows()] == \
        [r.wire_bytes_per_device for r in ps.rows()]
    ar = ps.rows()[2]      # all-reduce of 64 KiB over model (4 ranks), NVLink
    expected = 2 * (4 - 1) * H100.nvlink_latency_s + ar.wire_bytes_per_device / H100.nvlink_bw
    np.testing.assert_allclose(ar.est_time_s, expected, rtol=1e-12)
    ib = TraceStore.from_events(_events(CollectiveEvent))
    costmodel.annotate_store(ib, MeshSpec((2, 4), ("data", "model"),
                                          axis_kind={"data": "ib", "model": "nvlink"}), H100)
    assert ib.rows()[0].link_class == "ib.data" and ps.rows()[0].link_class == "nvlink.data"
    assert ib.rows()[0].est_time_s > ps.rows()[0].est_time_s


def test_default_axis_kinds_follow_the_node():
    """The innermost axes within 8 GPUs ride NVLink; an axis across nodes, and
    `pod`, ride InfiniBand (the H100 production meshes)."""
    assert MeshSpec((2, 4), ("data", "model")).axis_kind == {"data": "nvlink", "model": "nvlink"}
    assert MeshSpec.single_pod().axis_kind == {"data": "ib", "model": "nvlink"}
    assert MeshSpec.multi_pod().axis_kind == {"pod": "ib", "data": "ib", "model": "nvlink"}
    assert MeshSpec.single_pod().num_devices == 256


def test_trace_and_roofline_match_the_reference_with_the_port_peak():
    """Trace aggregates equal; the roofline's terms divide by the hw passed in,
    the model-FLOPs bound too (the reference hard-codes its chip's peak)."""
    js, ps = _stores()
    jt = JTrace.from_store("s", (2, 4), ("data", "model"), 8, js, hlo_flops=1e12, hlo_bytes=1e9)
    pt = Trace.from_store("s", (2, 4), ("data", "model"), 8, ps, hlo_flops=1e12, hlo_bytes=1e9)
    assert jt.by_site() == pt.by_site()
    jr = jroofline(jt, V5E, model_flops=4e12)
    pr = roofline(pt, _v5e_in_port(), model_flops=4e12)
    assert (jr.compute_s, jr.memory_s, jr.collective_s) == (pr.compute_s, pr.memory_s,
                                                            pr.collective_s)
    assert jr.model_roofline_fraction == pr.model_roofline_fraction
    h = roofline(pt, H100, model_flops=4e12)
    assert h.compute_s == 1e12 / H100.flops_bf16
    np.testing.assert_allclose(h.model_roofline_fraction,
                               4e12 / (8 * H100.flops_bf16) / h.bound_s, rtol=1e-12)


# --------------------------------------------------------------------------
# part 2: the capture of the 2x4 smoke train step against the reference trace
# --------------------------------------------------------------------------

_TRACES = r"""
import json
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

SMOKE = dict(d_model=128, d_ff=256, num_layers=4, vocab_size=512, num_heads=8,
             num_kv_heads=4, head_dim=16)

def rows(tr):
    return [[e.semantic, e.kind, e.link_class, e.multiplicity, e.operand_bytes,
             e.op_name] for e in tr.events]

# the reference: tests/test_system.py's traced step, with Auto mesh axes
from repro.configs import ARCHS as JARCHS, smoke_config as jsmoke
from repro.core import MeshSpec as JMesh, trace_from_hlo
from repro.distributed import sharding as jsh
from repro.distributed.autoshard import activation_sharding as jact
from repro.launch.presets import StepSettings as JSt
from repro.launch.steps import make_train_step as jstep
from repro.models import api as japi
from repro.optim import adamw as jadamw
jcfg = jsmoke(JARCHS["chatglm3-6b"]).replace(**SMOKE)
jmesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
step = jstep(jcfg, jadamw.AdamWConfig(), JSt(accum=2, remat="full"))
params = japi.abstract_params(jcfg)
f32 = lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32)
opt = {"m": jax.tree.map(f32, params), "v": jax.tree.map(f32, params),
       "count": jax.ShapeDtypeStruct((), jnp.int32)}
shape = type("S", (), {"global_batch": 8, "seq_len": 64, "kind": "train"})()
ps = jsh.param_pspecs(jcfg, jmesh)
in_sh = (jsh.named(jmesh, ps), jsh.named(jmesh, {"m": ps, "v": ps,
         "count": jax.sharding.PartitionSpec()}), None)
jfn = jax.jit(step, in_shardings=in_sh, donate_argnums=(0, 1))
with jact(jmesh):
    compiled = jfn.lower(params, opt, japi.batch_specs(jcfg, shape)).compile()
ref = trace_from_hlo(compiled.as_text(), JMesh((2, 4), ("data", "model")), label="smoke")

# the port: rank 0 of a (2, 4) DeviceMesh under the fake process group
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import trace_step
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import StepSettings
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.optim import adamw
cfg = smoke_config(ARCHS["chatglm3-6b"]).replace(**SMOKE)
mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cpu")
pl = sh.param_placements(cfg, mesh)
params = sh.distribute_params(api.init_params(cfg, 0, device="cpu", dtype=torch.float32), mesh, pl)
oc = adamw.AdamWConfig()
opt = adamw.init(oc, params)
host = {k: v.numpy() for k, v in api.demo_batch(cfg, 8, 64, device="cpu").items()}
bspecs = sh.batch_pspecs(cfg, type("S", (), {"global_batch": 8, "seq_len": 64})(), mesh)
batch = shard_batch(host, mesh, {k: sh.placements_for(s, mesh) for k, s in bspecs.items()})
with activation_sharding(mesh):
    tr = trace_step(make_train_step(cfg, oc, StepSettings(accum=2, remat="full")),
                    (params, opt, batch), mesh, spec, label="smoke")

# the gradient bytes with `data` replicated: each param's local bytes on the
# mesh, times its `data` shards (the gradient before its data reduction)
sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
rule = 0
from repro_torch.models.meta import leaves
for p, spec_ in zip(leaves(params), leaves(sh.param_pspecs(cfg, mesh))):
    shards = 1
    for e in spec_:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            shards *= sizes[a] if a != "data" else 1
    rule += p.numel() * 4 // shards
print("TRACES" + json.dumps({"ref": rows(ref), "port": rows(tr), "rule": int(rule),
                              "flops": tr.hlo_flops, "layers": cfg.num_layers}))
"""

# the reference's compiled trace of this step (jax 0.9.0, Auto axes), by (semantic, kind, link)
REFERENCE_TABLE = {
    ("attention", "all-gather", "nvlink.data"): 16,
    ("attention", "all-reduce", "nvlink.model"): 16,
    ("embed_logits", "all-gather", "nvlink.data"): 3,
    ("embed_logits", "all-gather", "nvlink.model"): 2,
    ("embed_logits", "all-reduce", "nvlink.model"): 2,
    ("ffn", "all-gather", "nvlink.data"): 48,
    ("ffn", "all-reduce", "nvlink.model"): 16,
    ("grad_sync", "all-reduce", "nvlink.data"): 12,
    ("grad_sync", "all-reduce", "nvlink.model"): 1,
    ("loss", "all-reduce", "nvlink.data"): 1,
    ("loss", "all-reduce", "nvlink.model"): 4,
    ("other", "all-gather", "nvlink.data"): 48,
    ("other", "all-reduce", "nvlink.model"): 8,
}

# (semantic, kind, link): (reference multiplicity, port multiplicity, why).
# The port's readings are torch 2.13's on the CPU; DTensor's strategies are
# version-dependent (the card's 2.11 gives another table, PERF.md section 6).
DIFFERENCES = {
    ("attention", "all-gather", "nvlink.data"): (16, 24, (
        "wo's FSDP gather: forward 8 + remat 8, as XLA's, + 8 in backward: "
        "DTensor's matmul saves the sharded weight and gathers it again for the "
        "input gradient, where XLA reuses the remat's gathered copy")),
    ("attention", "all-reduce", "nvlink.model"): (16, 24, (
        "forward + remat 16, as XLA's, + 8 in backward: the residual gradient "
        "arrives partial over model (the MLP's column-parallel input gradient) "
        "and the attention output's constraint reduces it; XLA reduces the "
        "column-parallel input gradients where they are made")),
    ("embed_logits", "all-gather", "nvlink.data"): (3, 6, (
        "the LM head's FSDP gather in each chunk's forward, remat and backward, "
        "per micro-batch (2 x 3); XLA gathers it 3 times")),
    ("embed_logits", "all-gather", "nvlink.model"): (2, 4, (
        "the embedding's 2, as XLA's, + 2 in the chunked loss's backward: DTensor "
        "gathers the head weight over model (vocab) for the hidden-state gradient")),
    ("embed_logits", "all-reduce", "nvlink.model"): (2, 0, (
        "XLA reduces the hidden-state gradient of the vocab-parallel head; "
        "DTensor gathers the head weight instead (the row above)")),
    ("ffn", "all-gather", "nvlink.data"): (48, 64, (
        "w_gate/w_up/w_down's FSDP gathers: forward 24 + remat 16 (torch's "
        "checkpoint stops its recompute before w_down's product) + 24 backward "
        "re-gathers (DTensor saves the sharded weight); XLA: forward 24 + remat 24")),
    ("ffn", "all-reduce", "nvlink.model"): (16, 8, (
        "the MLP output's forward reduction (8; none in the remat, which stops "
        "before w_down); XLA's other 8 reduce the column-parallel input gradient "
        "in backward, which the port reduces at the next constraint (attention, other)")),
    ("grad_sync", "all-reduce", "nvlink.data"): (12, 21, (
        "the port all-reduces the data-replicated gradients (the input table, 9 "
        "norm scales) in each micro-batch (2 x 10) + the global norm; XLA "
        "all-reduces each layer's combined gradients per micro-batch (8) + 4 more")),
    ("grad_sync", "all-reduce", "nvlink.model"): (1, 18, (
        "the 8 layer norms' scale gradients reach the synchronisation partial "
        "over model (DTensor carries the column-parallel input gradient's "
        "partial sum through the norm's backward), in each micro-batch (2 x 8), "
        "+ 2 global-norm pieces; XLA: 1")),
    ("grad_sync", "reduce-scatter", "nvlink.data"): (0, 58, (
        "the FSDP-sharded gradients are reduce-scattered in each micro-batch, one "
        "tensor each (2 x (7 a layer + the head)); XLA all-reduces combined buffers")),
    ("loss", "all-gather", "nvlink.model"): (0, 2, (
        "in the loss's backward DTensor gathers the fp32 logits chunk over model "
        "(its strategy for the vocab-parallel softmax's backward)")),
    ("loss", "all-reduce", "nvlink.data"): (1, 0, (
        "the loss's mean over data: the port takes it outside the `loss` scope "
        "(other, over data and model)")),
    ("loss", "reduce-scatter", "nvlink.model"): (0, 14, (
        "DTensor reduce-scatters the [B, chunk] per-token sums of the vocab-"
        "parallel softmax and target pick (forward 6, backward 8), where XLA "
        "all-reduces them")),
    ("other", "all-gather", "nvlink.data"): (48, 74, (
        "q/k/v's FSDP gathers: forward + remat 48, as XLA's, + 24 backward "
        "re-gathers, + 2 gathers of the token ids for the micro-batch split")),
    ("other", "all-reduce", "nvlink.data"): (0, 1, "the loss's token count over data"),
    ("other", "all-reduce", "nvlink.model"): (8, 11, (
        "the residual gradient reduced at each layer-entry constraint (4 layers "
        "x 2 micro-batches) and at the final norm's (2, scope `final_norm`), + "
        "the loss's count over model; XLA's 8 reduce the q/k/v input gradients")),
}


@pytest.fixture(scope="module")
def traces():
    out = run_subprocess(_TRACES, devices=8, timeout=400)
    line = next(l for l in out.splitlines() if l.startswith("TRACES"))
    return json.loads(line[len("TRACES"):])


def _table(rows, rename=False):
    t = {}
    for sem, kind, link, mult, _ob, _op in rows:
        key = (sem, kind, _link(link) if rename else link)
        t[key] = t.get(key, 0) + mult
    return t


def test_reference_trace_is_the_31_site_table(traces):
    assert len(traces["ref"]) == 31
    assert _table(traces["ref"], rename=True) == REFERENCE_TABLE


def test_capture_has_the_reference_semantics_and_grad_sync_on_data(traces):
    port, ref = traces["port"], traces["ref"]
    assert 0 < len(port)
    assert {r[0] for r in port} == {r[0] for r in ref}
    assert any(r[0] == "grad_sync" and r[2] == "nvlink.data" for r in port)
    assert any(r[0] == "attention" for r in port)
    assert traces["flops"] > 0


def test_capture_folds_layers_and_micro_batches(traces):
    """A per-layer site of forward runs once per layer and micro-batch (and
    again in the remat): its multiplicity is a multiple of layers x accum."""
    per = traces["layers"] * 2
    layer_sites = [r for r in traces["port"] if r[5].startswith("layer/")]
    assert layer_sites and all(r[3] % per == 0 for r in layer_sites)
    assert max(r[3] for r in traces["port"]) >= per


def test_grad_sync_bytes_are_the_data_replicated_gradient_bytes(traces):
    """The bytes that grad_sync reduces over data (the gradients as they stand
    before their data reduction), without the global norm's scalars, equal
    the params' gradient bytes with `data` replicated, worked out from the
    placements, once per micro-batch (accum 2).  The reference's own reading
    is the same rule, once per micro-batch too, but in bf16 (XLA reduces the
    weight gradients as its bf16 products make them, before their cast to
    the fp32 params): half the port's fp32 bytes, within 4 bytes (its
    combined all-reduces carry 2 more bytes per micro-batch)."""
    def data_bytes(rows):
        return sum(r[3] * r[4] for r in rows if r[0] == "grad_sync" and
                   r[2].endswith(".data") and "optimizer" not in r[5])
    assert data_bytes(traces["port"]) == 2 * traces["rule"]
    assert 0 <= data_bytes(traces["ref"]) - 2 * traces["rule"] // 2 <= 4


def test_every_difference_from_the_reference_is_named(traces):
    """The (semantic, kind, link) multiplicity table equals the reference's
    except where `DIFFERENCES` names the gap, with both readings."""
    port, ref = _table(traces["port"]), _table(traces["ref"], rename=True)
    for key in sorted(set(port) | set(ref)):
        got = (ref.get(key, 0), port.get(key, 0))
        if got[0] == got[1]:
            continue
        assert key in DIFFERENCES and DIFFERENCES[key][:2] == got, (key, got)
    for key, (r, p, why) in DIFFERENCES.items():
        assert (ref.get(key, 0), port.get(key, 0)) == (r, p), key
        assert r == p or why


# --------------------------------------------------------------------------
# part 3: the capture's fused and unfused byte counts on hand-built op chains
# --------------------------------------------------------------------------

def _counted(fn, *args):
    """(fused, unfused) bytes that the capture's recorder counts over fn(*args),
    the fused count finished while fn's result is live."""
    from repro_torch.core import capture
    rec = capture._Recorder()
    with rec:
        out = fn(*args)
    rec.fused.finish()
    del out
    return rec.fused.bytes, rec.bytes


def test_a_pointwise_chain_is_read_once_and_written_where_it_leaves():
    """x * 2 + 1, exp, then a matmul: the chain reads x and is written once, when
    the matmul (not pointwise) reads it; unfused, every op reads and writes."""
    import torch
    x, m = torch.ones(64, 32), torch.ones(32, 16)
    N, M, O = x.numel() * 4, m.numel() * 4, 64 * 16 * 4
    fused, unfused = _counted(lambda x, m: ((x * 2 + 1).exp()) @ m, x, m)
    assert fused == N + (N + N) + M + O         # read x; write + read the chain; m; out
    assert unfused == 3 * 2 * N + (N + M + O)


def test_a_chain_that_dies_inside_its_region_is_never_written():
    import torch
    x = torch.ones(128)

    def step(x):
        y = (x * 3).sin()
        del y
        return None
    assert _counted(step, x) == (x.numel() * 4, 2 * 2 * x.numel() * 4)


def test_a_chain_live_at_the_step_s_end_is_written_once():
    """A result of pointwise ops (and a cast, fused as XLA fuses converts) is
    written once, at the step's end; an in-place update of an input too."""
    import torch
    x, p = torch.ones(256), torch.ones(256)

    def step(x, p):
        p.mul_(0.5).add_(x)                     # a param updated in place
        return (x + 1).to(torch.bfloat16)
    fused, unfused = _counted(step, x, p)
    n = x.numel() * 4
    assert fused == 3 * n + n + n // 2          # reads p, x, x; writes p, the result
    assert unfused == 2 * n + 3 * n + 2 * n + (n + n // 2)


def test_live_bytes_name_the_holders_when_the_peak_is_first_reached():
    """`_LiveBytes` with `holders_at` (what `capture.peak_holders` asks of a
    fake step) takes the storages live when the live bytes first reach it,
    each by the op that made it: the argument, exp's and cat's outputs; not
    mul's, freed before, nor sin's, made after."""
    import torch
    from repro_torch.core import capture
    x = torch.ones(1000)
    live = capture._LiveBytes([x], holders_at=16000)
    with capture._Recorder(live):
        t = x * 2
        del t
        y = x.exp()
        z = torch.cat([y, y])
        w = z.sin()
    assert live.peak == 4000 + 4000 + 8000 + 8000 and w.numel() == 2000
    got = sorted((op, shape, n) for op, _, shape, _, n in live.holders)
    assert got == [("argument", (1000,), 4000), ("aten.cat.default", (2000,), 8000),
                   ("aten.exp.default", (1000,), 4000)]
