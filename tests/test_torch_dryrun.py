"""The port's dry-run (`repro_torch.launch.dryrun`) against the reference's.

Part 1, in one subprocess with 8 forced jax devices (`jax.devices()` is
touched before `repro.launch.dryrun` is imported, whose import would force
512): for every arch x shape, the shape and arch orders, the 5 skipped cells
and their reasons, every leaf of `input_specs` (shape and dtype), and
`analytic_memory_bytes` on an Auto-axes (2, 4) mesh against the port's on a
(2, 4) DeviceMesh under the fake process group (relative 1e-12), also with
the rule table forced (serving weights FSDP-split or replicated on (2, 4),
HSDP training on (2, 2, 2) over pod, data and model).

Part 2, in another: one cell of each shape kind (train, prefill, decode) in
each family at smoke widths (`cfg_overrides`) on (2, 4): the reference's
compiled `lower_cell` against the port's fake-tensor one; equal skips and
model GFLOPs, and the same (semantic, kind, link) rows but where
`DIFFERENCES` names a gap with both readings and the reason (`ici.` read as
`nvlink.`, one node).  With the rule table forced (`serve_fsdp`, `hsdp`),
the rows that forcing adds or removes are the reference's but where
`FORCED_DIFFERENCES` names the gap, and HSDP keeps the weight gathers
inside the pod in both packages.

Part 3: the port's fake-tensor trace of smoke train, prefill and decode
steps on the fake (2, 4) mesh equals the same steps on real CPU tensors
site for site and FLOP for FLOP (exactly; byte for byte where no kernel runs).  Decode on 8 real
gloo ranks, its cache's sequence split over the mesh, gives the straight
decode's logits (fp32, relative 2e-5), and the CLI runs whisper-tiny at
full width on the production mesh on the CPU, its `--serve-fsdp` and
`--hsdp` flags included.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import free_port
from conftest import REPO, SRC, run_subprocess

F32_TOL = 2e-5
MEM_RTOL = 1e-12

_SPECS = r"""
import dataclasses
import json
import jax
jax.devices()                  # lock 8 devices before repro.launch.dryrun forces 512
from jax.sharding import AxisType
import repro.launch.dryrun as jdr
from repro.configs import (ARCHS as JARCHS, ARCH_ORDER as JARCH_ORDER, SHAPES as JSHAPES,
                           SHAPE_ORDER as JSHAPE_ORDER, shape_applicable as japplicable)
from repro.distributed import sharding as jsh
from repro.launch import presets as jpresets
from repro.models import api as japi
from repro_torch.configs import ARCHS, ARCH_ORDER, SHAPES, SHAPE_ORDER, shape_applicable
from repro_torch.launch import dryrun as dr, presets
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api

def walk(tree, path=""):
    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in walk(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [r for i, v in enumerate(tree) for r in walk(v, f"{path}/{i}")]
    return [[path, list(tree.shape), str(tree.dtype).replace("torch.", "")]]

jmesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
mesh, _ = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cpu")
pods = ("pod", "data", "model")
jmesh3 = jax.make_mesh((2, 2, 2), pods, axis_types=(AxisType.Auto,) * 3)
mesh3, _ = make_host_mesh((2, 2, 2), pods, backend="fake", device="cpu")
out = {"orders": [[list(JSHAPE_ORDER), list(SHAPE_ORDER)], [list(JARCH_ORDER), list(ARCH_ORDER)]],
       "skips": {}, "specs": {}, "mem": {}, "forced_mem": {}}

def mems(jcfg, jshape, cfg, shape, jst, st, jm, m):
    jrules = ((jsh.TRAIN_RULES_HSDP if jst.hsdp else jsh.TRAIN_RULES) if jshape.kind == "train"
              else jdr._serve_rules(jcfg, jm, jst))
    return [jdr.analytic_memory_bytes(jcfg, jshape, jst, jm, jrules),
            dr.analytic_memory_bytes(cfg, shape, st, m, dr.cell_rules(cfg, shape, st, m))]
for a in ARCH_ORDER:
    for s in SHAPE_ORDER:
        key = f"{a}/{s}"
        jcfg, jshape, cfg, shape = JARCHS[a], JSHAPES[s], ARCHS[a], SHAPES[s]
        out["skips"][key] = [list(japplicable(jcfg, jshape)), list(shape_applicable(cfg, shape))]
        if not shape_applicable(cfg, shape)[0]:
            continue
        out["specs"][key] = [walk(japi.input_specs(jcfg, jshape)), walk(api.input_specs(cfg, shape))]
        jst, st = jpresets.settings_for(a, s), presets.settings_for(a, s)
        out["mem"][key] = mems(jcfg, jshape, cfg, shape, jst, st, jmesh, mesh)
        forced = ([({"hsdp": True}, jmesh3, mesh3)] if shape.kind == "train" else
                  [({"serve_fsdp": v}, jmesh, mesh) for v in (True, False)])
        for force, jm, m in forced:
            out["forced_mem"][f"{key}/{force}"] = mems(
                jcfg, jshape, cfg, shape, dataclasses.replace(jst, **force),
                dataclasses.replace(st, **force), jm, m)
print("SPECS" + json.dumps(out))
"""

# one arch of each family, and a cell of each shape kind (decode_32k; hymba-1.5b's
# long_500k too, whose batch of 1 splits the cache's sequence over both axes)
FAMILIES = ("chatglm3-6b", "mixtral-8x22b", "falcon-mamba-7b", "hymba-1.5b", "qwen2-vl-2b",
            "whisper-tiny")
CELLS = [(a, s) for a in FAMILIES for s in ("train_4k", "prefill_32k", "decode_32k")] + \
    [("hymba-1.5b", "long_500k")]

# the config fields a smoke cell takes from `smoke_config` (`cfg_overrides`)
FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
          "vocab_size", "window_pattern", "window", "num_experts", "top_k", "moe_d_ff",
          "ssm_state", "d_conv", "expand", "encoder_layers", "source_len", "max_positions",
          "mrope_sections")

_CELLS = r"""
import json
import jax
jax.devices()
from jax.sharding import AxisType
import repro.launch.dryrun as jdr
from repro.core import MeshSpec as JMesh
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh

jmesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cpu")

def rows(tr):
    return sorted({(e.semantic, e.kind, e.link_class.replace("ici.", "nvlink."))
                   for e in tr.events})

out = {}
for arch, shape in CELLS:
    smoke = smoke_config(ARCHS[arch])
    over = {f: getattr(smoke, f) for f in FIELDS}
    ref = jdr.lower_cell(arch, shape, mesh=jmesh, mesh_spec=JMesh((2, 4), ("data", "model")),
                         cfg_overrides=over)
    port = dr.lower_cell(arch, shape, mesh=mesh, mesh_spec=spec, cfg_overrides=over)
    out[f"{arch}/{shape}"] = {
        "skipped": ["skipped" in ref, "skipped" in port],
        "model_gflops": [ref.get("model_gflops"), port.get("model_gflops")],
        "rows": [rows(ref["trace"]), rows(port["trace"])],
        "hlo_bytes": [ref["trace"].hlo_bytes, port["trace"].hlo_bytes,
                      port["trace"].hlo_bytes_unfused],
        "cache_gathers": (len(dr.cache_gathers(port["trace"], ARCHS[arch].replace(**over),
                                                dr.SHAPES[shape], spec))
                          if shape in ("decode_32k", "long_500k") else 0)}
print("CELLS" + json.dumps(out))
"""

_XLA_MOVES = ("XLA moves shards between dims with all-to-all, and exchanges the edges of a "
              "split dim with collective-permute, where a sharded dim is concatenated, sliced "
              "or split (rope halves, the q/k/v and gate/up splits, the micro-batch "
              "dynamic_slice, the SSM's in_proj split and conv window); DTensor has no such "
              "redistribution: it gathers (all-gather) or the op runs per rank")
_REDUCE_INTO_SPLIT = ("a row-parallel product's partial sum over model: XLA all-reduces it, "
                      "DTensor reduce-scatters it into the split layout its consumer takes and "
                      "all-gathers where the whole is needed")
# (semantic, kind, link): (the side that has the row, the cells where only it has it,
# why).  The port's readings are torch 2.13's on the CPU (DTensor's strategies are
# version-dependent); the reference's are jax 0.9.0's compiled traces, Auto axes.
DIFFERENCES = {
    ("attention", "all-gather", "nvlink.model"): ("reference", (
        "chatglm3-6b/train_4k", "chatglm3-6b/prefill_32k", "mixtral-8x22b/train_4k",
        "mixtral-8x22b/prefill_32k", "hymba-1.5b/prefill_32k", "qwen2-vl-2b/train_4k",
        "qwen2-vl-2b/prefill_32k"),
        "XLA gathers k/v over model inside the attention core's products where the kv "
        "heads do not divide model (2 on 4 at smoke width); the port gathers them at the "
        "projection (`attention._heads`, scope layer: the `other` all-gather below) and "
        "runs the core per rank"),
    ("attention", "all-reduce", "nvlink.mixed(data+model)"): ("reference", (
        "hymba-1.5b/long_500k",),
        "XLA reduces the softmax's max and sum over the cache's sequence, split over data "
        "and model, in one group of both axes; the port reduces over each axis in turn "
        "(`attention._decode_attend_local`)"),
    ("attention", "all-reduce", "nvlink.model"): ("port", ("hymba-1.5b/prefill_32k",),
        "the attention output's row-parallel partial sum reduced at the port's residual "
        "constraint, where XLA reduces the hybrid's mean of the attention and SSM heads "
        "(`ffn`, `other`)"),
    ("attention", "all-to-all", "nvlink.model"): ("reference", (
        "chatglm3-6b/decode_32k", "mixtral-8x22b/decode_32k", "hymba-1.5b/decode_32k",
        "qwen2-vl-2b/decode_32k"), _XLA_MOVES),
    ("attention", "collective-permute", "nvlink.model"): ("reference", (
        "chatglm3-6b/decode_32k", "mixtral-8x22b/decode_32k", "hymba-1.5b/decode_32k",
        "qwen2-vl-2b/decode_32k", "hymba-1.5b/long_500k"), _XLA_MOVES),
    ("attention", "reduce-scatter", "nvlink.model"): ("port", (
        "whisper-tiny/train_4k", "whisper-tiny/prefill_32k", "whisper-tiny/decode_32k"),
        "the cross attention's output projection: " + _REDUCE_INTO_SPLIT),
    ("embed_logits", "all-reduce", "nvlink.model"): ("reference", (
        "chatglm3-6b/train_4k", "mixtral-8x22b/train_4k", "falcon-mamba-7b/train_4k",
        "hymba-1.5b/train_4k", "qwen2-vl-2b/train_4k", "whisper-tiny/train_4k",
        "whisper-tiny/prefill_32k", "whisper-tiny/decode_32k"),
        "XLA reduces the vocab-parallel head's hidden-state gradient (and the tied head's "
        "logits); DTensor gathers the head weight instead (`loss` all-gather) or "
        "reduce-scatters (the row below)"),
    ("embed_logits", "reduce-scatter", "nvlink.model"): ("port", (
        "chatglm3-6b/decode_32k", "mixtral-8x22b/decode_32k", "falcon-mamba-7b/decode_32k",
        "hymba-1.5b/decode_32k", "qwen2-vl-2b/decode_32k", "whisper-tiny/train_4k",
        "whisper-tiny/prefill_32k", "whisper-tiny/decode_32k", "hymba-1.5b/long_500k"),
        "the logits' partial sum (an FSDP head contracted over data, a tied table over "
        "model): " + _REDUCE_INTO_SPLIT),
    ("ffn", "all-gather", "nvlink.model"): ("port", (
        "chatglm3-6b/decode_32k", "hymba-1.5b/train_4k", "hymba-1.5b/prefill_32k",
        "hymba-1.5b/decode_32k", "qwen2-vl-2b/decode_32k"), _REDUCE_INTO_SPLIT),
    ("ffn", "all-reduce", "nvlink.model"): ("reference", (
        "chatglm3-6b/decode_32k", "hymba-1.5b/train_4k", "hymba-1.5b/prefill_32k",
        "hymba-1.5b/decode_32k", "qwen2-vl-2b/decode_32k", "whisper-tiny/decode_32k"),
        _REDUCE_INTO_SPLIT),
    ("ffn", "reduce-scatter", "nvlink.model"): ("port", (
        "chatglm3-6b/decode_32k", "hymba-1.5b/train_4k", "hymba-1.5b/prefill_32k",
        "hymba-1.5b/decode_32k", "qwen2-vl-2b/decode_32k", "whisper-tiny/train_4k",
        "whisper-tiny/prefill_32k", "whisper-tiny/decode_32k", "hymba-1.5b/long_500k"),
        _REDUCE_INTO_SPLIT),
    ("grad_sync", "all-gather", "nvlink.model"): ("port", ("whisper-tiny/train_4k",),
        "a gradient left split over model where its param is whole (whisper's 6 heads on "
        "8) gathered at the synchronisation"),
    ("grad_sync", "reduce-scatter", "nvlink.data"): ("port", (
        "chatglm3-6b/train_4k", "mixtral-8x22b/train_4k", "falcon-mamba-7b/train_4k",
        "hymba-1.5b/train_4k", "qwen2-vl-2b/train_4k", "whisper-tiny/train_4k"),
        "the FSDP-sharded gradients reduce-scattered in each micro-batch, one tensor "
        "each (`steps._sync_grad`); XLA all-reduces combined buffers (as in "
        "test_torch_capture.DIFFERENCES)"),
    ("grad_sync", "reduce-scatter", "nvlink.model"): ("port", (
        "hymba-1.5b/train_4k", "whisper-tiny/train_4k"),
        "gradients partial over model reduced into their params' model shards at the "
        "synchronisation; XLA reduces them where they are made"),
    ("loss", "all-gather", "nvlink.model"): ("port", (
        "chatglm3-6b/train_4k", "mixtral-8x22b/train_4k", "falcon-mamba-7b/train_4k",
        "hymba-1.5b/train_4k", "qwen2-vl-2b/train_4k", "whisper-tiny/train_4k"),
        "in the loss's backward DTensor gathers the fp32 logits chunk over model (its "
        "strategy for the vocab-parallel softmax's backward; as in "
        "test_torch_capture.DIFFERENCES)"),
    ("loss", "all-reduce", "nvlink.data"): ("reference", (
        "chatglm3-6b/train_4k", "mixtral-8x22b/train_4k", "falcon-mamba-7b/train_4k",
        "hymba-1.5b/train_4k", "qwen2-vl-2b/train_4k", "whisper-tiny/train_4k"),
        "the loss's mean over data: the port takes it outside the `loss` scope (the "
        "`other` all-reduce over data)"),
    ("loss", "reduce-scatter", "nvlink.model"): ("port", (
        "chatglm3-6b/train_4k", "mixtral-8x22b/train_4k", "falcon-mamba-7b/train_4k",
        "hymba-1.5b/train_4k", "qwen2-vl-2b/train_4k", "whisper-tiny/train_4k"),
        "DTensor reduce-scatters the [B, chunk] per-token sums of the vocab-parallel "
        "softmax and target pick, where XLA all-reduces them"),
    ("moe_combine", "all-gather", "nvlink.model"): ("port", ("mixtral-8x22b/train_4k",),
        "the combine's backward gathers the expert outputs' gradient over model (experts "
        "TP'd on moe_mlp: E does not divide model); XLA reduces it in the dispatch "
        "(`moe_dispatch` all-reduce)"),
    ("moe_dispatch", "all-gather", "nvlink.data"): ("reference", (
        "mixtral-8x22b/prefill_32k", "mixtral-8x22b/decode_32k"),
        "XLA gathers the router probabilities over data for top_k; the port's top_k runs "
        "on each rank's tokens and only the aux loss's means are reduced (the port's "
        "all-reduce over data)"),
    ("moe_dispatch", "all-reduce", "nvlink.data"): ("port", (
        "mixtral-8x22b/prefill_32k", "mixtral-8x22b/decode_32k"),
        "the aux loss's router means reduced over data (XLA gathers the probabilities "
        "instead, the row above)"),
    ("moe_dispatch", "all-reduce", "nvlink.model"): ("reference", ("mixtral-8x22b/train_4k",),
        "XLA all-reduces the router softmax's max and sum over model (the router's "
        "contraction over a model-split input); the port reduce-scatters it (next row)"),
    ("moe_dispatch", "reduce-scatter", "nvlink.model"): ("port", ("mixtral-8x22b/train_4k",),
        "the router input's gradient: " + _REDUCE_INTO_SPLIT),
    ("other", "all-gather", "nvlink.data"): ("port", ("falcon-mamba-7b/train_4k",),
        "the token ids gathered over data for the micro-batch split (accum 8: 32 rows of "
        "256 a micro-batch), where XLA moves them with an all-to-all"),
    ("other", "all-gather", "nvlink.model"): ("port", (
        "chatglm3-6b/train_4k", "chatglm3-6b/prefill_32k", "chatglm3-6b/decode_32k",
        "mixtral-8x22b/prefill_32k", "mixtral-8x22b/decode_32k", "falcon-mamba-7b/decode_32k",
        "hymba-1.5b/train_4k", "hymba-1.5b/prefill_32k", "hymba-1.5b/decode_32k",
        "qwen2-vl-2b/train_4k", "qwen2-vl-2b/prefill_32k", "qwen2-vl-2b/decode_32k",
        "whisper-tiny/decode_32k"),
        "k/v (and whisper's q) gathered over model at the projection where model does not "
        "divide the heads (`attention._heads`, scope layer), and the SSM's decode state; "
        "XLA gathers inside the attention core (the `attention` all-gather above)"),
    ("other", "all-reduce", "nvlink.data"): ("port", (
        "chatglm3-6b/train_4k", "mixtral-8x22b/train_4k", "falcon-mamba-7b/train_4k",
        "hymba-1.5b/train_4k", "qwen2-vl-2b/train_4k"),
        "the loss's mean and token count over data, outside the `loss` scope"),
    ("other", "all-reduce", "nvlink.model"): ("port", (
        "chatglm3-6b/decode_32k", "mixtral-8x22b/decode_32k", "falcon-mamba-7b/train_4k",
        "falcon-mamba-7b/prefill_32k", "falcon-mamba-7b/decode_32k", "hymba-1.5b/prefill_32k",
        "hymba-1.5b/decode_32k", "qwen2-vl-2b/decode_32k"),
        "a partial sum over model reduced at the residual constraint of the layer's entry "
        "(scope layer): the decode layer's output, the SSM's out_proj; XLA reduces it in "
        "the sub-scope that made it"),
    ("other", "all-to-all", "nvlink.data"): ("reference", (
        "chatglm3-6b/train_4k", "mixtral-8x22b/train_4k", "falcon-mamba-7b/train_4k",
        "hymba-1.5b/train_4k", "qwen2-vl-2b/train_4k"), _XLA_MOVES),
    ("other", "all-to-all", "nvlink.model"): ("reference", (
        "chatglm3-6b/train_4k", "chatglm3-6b/prefill_32k", "mixtral-8x22b/train_4k",
        "mixtral-8x22b/prefill_32k", "hymba-1.5b/train_4k", "hymba-1.5b/prefill_32k",
        "qwen2-vl-2b/train_4k", "qwen2-vl-2b/prefill_32k"), _XLA_MOVES),
    ("other", "collective-permute", "nvlink.model"): ("reference", (
        "chatglm3-6b/train_4k", "chatglm3-6b/prefill_32k", "mixtral-8x22b/train_4k",
        "mixtral-8x22b/prefill_32k", "falcon-mamba-7b/prefill_32k", "hymba-1.5b/train_4k",
        "hymba-1.5b/prefill_32k", "qwen2-vl-2b/train_4k", "qwen2-vl-2b/prefill_32k"),
        _XLA_MOVES),
    ("other", "reduce-scatter", "nvlink.model"): ("port", (
        "chatglm3-6b/decode_32k", "mixtral-8x22b/decode_32k", "falcon-mamba-7b/decode_32k",
        "hymba-1.5b/train_4k", "hymba-1.5b/prefill_32k", "hymba-1.5b/decode_32k",
        "qwen2-vl-2b/decode_32k", "whisper-tiny/train_4k", "whisper-tiny/prefill_32k",
        "whisper-tiny/decode_32k"),
        "a partial sum over model at the layer's entry: " + _REDUCE_INTO_SPLIT),
    ("ssm", "all-gather", "nvlink.model"): ("port", (
        "falcon-mamba-7b/train_4k", "falcon-mamba-7b/prefill_32k", "falcon-mamba-7b/decode_32k",
        "hymba-1.5b/train_4k", "hymba-1.5b/prefill_32k", "hymba-1.5b/decode_32k",
        "hymba-1.5b/long_500k"),
        "the SSM's x_proj input whole over model for the reduced projection (x_proj is "
        "row-parallel; the port reduces its [B, S, r + 2N] output once, `ssm._ssm_inputs`) "
        "and the conv's window, which XLA exchanges with collective-permute"),
    ("ssm", "all-to-all", "nvlink.model"): ("reference", (
        "falcon-mamba-7b/train_4k", "hymba-1.5b/train_4k"), _XLA_MOVES),
    ("ssm", "collective-permute", "nvlink.model"): ("reference", (
        "falcon-mamba-7b/train_4k", "falcon-mamba-7b/prefill_32k", "falcon-mamba-7b/decode_32k",
        "hymba-1.5b/train_4k", "hymba-1.5b/prefill_32k", "hymba-1.5b/decode_32k",
        "hymba-1.5b/long_500k"), _XLA_MOVES),
}


@pytest.fixture(scope="module")
def specs():
    out = run_subprocess(_SPECS, devices=8, timeout=400)
    line = next(l for l in out.splitlines() if l.startswith("SPECS"))
    return json.loads(line[len("SPECS"):])


@pytest.fixture(scope="module")
def cells():
    out = run_subprocess(f"CELLS = {CELLS!r}\nFIELDS = {FIELDS!r}\n" + _CELLS, devices=8,
                         timeout=900)
    line = next(l for l in out.splitlines() if l.startswith("CELLS"))
    return json.loads(line[len("CELLS"):])


def test_shape_and_arch_orders_are_the_reference_s(specs):
    for ref, port in specs["orders"]:
        assert ref == port


def test_the_five_skipped_cells_and_their_reasons_are_the_reference_s(specs):
    skips = specs["skips"]
    assert len(skips) == 40
    for key, (ref, port) in skips.items():
        assert ref == port, key
    assert sum(not ok for ok, _ in (v[1] for v in skips.values())) == 5


def test_input_specs_have_the_reference_s_leaves(specs):
    """Every leaf's path, shape and dtype, for each of the 35 cells."""
    assert len(specs["specs"]) == 35
    for key, (ref, port) in specs["specs"].items():
        assert ref == port, key


def _same_memory(pairs):
    for key, (ref, port) in pairs.items():
        assert ref.keys() == port.keys(), key
        for term in ref:
            np.testing.assert_allclose(port[term], ref[term], rtol=MEM_RTOL, err_msg=key)


def test_analytic_memory_is_the_reference_s(specs):
    """Each term and the total with slack on (2, 4), within a relative 1e-12."""
    assert len(specs["mem"]) == 35
    _same_memory(specs["mem"])


def test_analytic_memory_with_a_forced_rule_table_is_the_reference_s(specs):
    """As above, with each cell's rule table forced as the reference's
    `serve_fsdp` (on and off: the 25 serving cells, on (2, 4)) and `hsdp`
    (the 10 train cells, on (2, 2, 2)) force it."""
    assert len(specs["forced_mem"]) == 10 + 2 * 25
    _same_memory(specs["forced_mem"])


def test_smoke_cells_skip_and_count_model_flops_as_the_reference(cells):
    assert set(cells) == {f"{a}/{s}" for a, s in CELLS}
    for key, c in cells.items():
        assert c["skipped"] == [False, False], key
        np.testing.assert_allclose(c["model_gflops"][1], c["model_gflops"][0], rtol=1e-12,
                                   err_msg=key)


def test_smoke_cells_have_the_reference_s_rows_or_name_the_gap(cells):
    """The (semantic, kind, link) rows of each smoke cell equal the reference's
    compiled trace's, except where `DIFFERENCES` names the gap: which side has
    the row, in exactly which cells, and why."""
    found = {}
    for key, c in cells.items():
        ref, port = ({tuple(r) for r in rows} for rows in c["rows"])
        assert port, key
        for row in ref ^ port:
            side = "reference" if row in ref else "port"
            found.setdefault(row, (side, set()))[1].add(key)
            assert found[row][0] == side, (row, key)
    assert set(found) == set(DIFFERENCES)
    for row, (side, where, why) in DIFFERENCES.items():
        assert found[row] == (side, set(where)) and why, row


_SCORES_PASSES = ("XLA's CPU backend (the devices the reference's dry-run forces here) reads "
                  "the attention's fp32 [B, K, G, S, T] scores in more fusions than the port's "
                  "rule counts (one write where a pointwise chain leaves, one read per "
                  "consumer that is not pointwise): at smoke widths and 4096 tokens the scores "
                  "are most of the step's bytes; by scope the reference's `attn` bytes are "
                  "2.3x the port's and its backward's 1.9x (chatglm3-6b)")
_CACHE_UPDATE = ("XLA counts each layer's cache update (a dynamic-update-slice, outside any "
                 "scope) as reading and writing the whole k/v cache; the port writes the new "
                 "slot in place and reads the cache once, in the attention")
# cells whose fused byte count (the roofline's memory term) is outside [0.5, 2] of the
# reference's `hlo_bytes`: the side of the gap, the ratio read (port / reference, torch
# 2.13 on the CPU against jax 0.9.0), and why
BYTES_DIFFERENCES = {
    "chatglm3-6b/train_4k": ("low", 0.425, _SCORES_PASSES),
    "qwen2-vl-2b/train_4k": ("low", 0.427, _SCORES_PASSES),
    "whisper-tiny/train_4k": ("low", 0.432, _SCORES_PASSES),
    "hymba-1.5b/train_4k": ("low", 0.447, _SCORES_PASSES + "; hymba-1.5b's attention bytes "
                            "are 0.41x the reference's (313 against 771 GB), which its scan no "
                            "longer offsets since the training scan runs the reference's "
                            "odd-even associative scan (the doubling scan read 0.575)"),
    "chatglm3-6b/decode_32k": ("low", 0.417, _CACHE_UPDATE),
    "mixtral-8x22b/decode_32k": ("low", 0.417, _CACHE_UPDATE),
    "hymba-1.5b/decode_32k": ("low", 0.417, _CACHE_UPDATE),
    "qwen2-vl-2b/decode_32k": ("low", 0.417, _CACHE_UPDATE),
    "falcon-mamba-7b/prefill_32k": ("low", 0.084,
        "the port's prefill runs K2's fused entry point, which reads delta, x, B and C "
        "([B, S, di] and [B, S, N]); the reference materialises a_bar and bx ([B, S, di, N] "
        "fp32 each) and scans them in an associative scan's log2(256) levels (its `ssm` "
        "scope: 52 of its 68 GB)"),
}


def test_smoke_cells_fused_bytes_are_the_reference_s_or_name_the_gap(cells):
    """The roofline's memory term reads the capture's fused byte count.  On each
    smoke cell it is within [0.5, 2] of the reference's compiled `hlo_bytes`,
    but where `BYTES_DIFFERENCES` names the cell, its side and its cause (the
    ratio read there within 10%); and it never exceeds the unfused count.
    `pytest -s` prints each cell's ratios."""
    assert set(BYTES_DIFFERENCES) <= set(cells)
    for key, c in cells.items():
        ref, fused, unfused = c["hlo_bytes"]
        ratio = fused / ref
        print(f"{key}: fused / reference {ratio:.3f}, unfused / reference {unfused / ref:.3f}")
        assert 0 < fused <= unfused, key
        if key in BYTES_DIFFERENCES:
            side, read, why = BYTES_DIFFERENCES[key]
            assert (ratio < 0.5 if side == "low" else ratio > 2) and why, (key, ratio)
            assert abs(ratio / read - 1) < 0.1, (key, ratio, read)
        else:
            assert 0.5 <= ratio <= 2, (key, ratio)


def test_smoke_decode_cells_never_gather_the_cache(cells):
    for key, c in cells.items():
        assert c["cache_gathers"] == 0, key


# the rule table forced: (arch, shape, mesh shape, the StepSettings fields set)
FORCED = [("mixtral-8x22b", "decode_32k", (2, 4), {"serve_fsdp": True}),
          ("chatglm3-6b", "prefill_32k", (2, 4), {"serve_fsdp": True}),
          ("chatglm3-6b", "prefill_32k", (2, 4), {"serve_fsdp": False}),
          ("chatglm3-6b", "train_4k", (2, 2, 2), {"hsdp": True})]

_FORCED = r"""
import dataclasses
import json
import jax
jax.devices()
from jax.sharding import AxisType
import repro.launch.dryrun as jdr
from repro.core import MeshSpec as JMesh
from repro.launch import presets as jpresets
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import dryrun as dr, presets
from repro_torch.launch.mesh import make_host_mesh

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}

def rows(tr):
    return sorted({(e.semantic, e.kind, e.link_class.replace("ici.", "nvlink."))
                   for e in tr.events})

out = {}
for arch, shape, mshape, force in FORCED:
    axes = AXES[len(mshape)]
    jmesh = jax.make_mesh(mshape, axes, axis_types=(AxisType.Auto,) * len(axes))
    mesh, spec = make_host_mesh(mshape, axes, backend="fake", device="cpu")
    smoke = smoke_config(ARCHS[arch])
    over = {f: getattr(smoke, f) for f in FIELDS}
    got = {}
    for name, fields in (("default", {}), ("forced", force)):
        jst = dataclasses.replace(jpresets.settings_for(arch, shape), **fields)
        st = dataclasses.replace(presets.settings_for(arch, shape), **fields)
        ref = jdr.lower_cell(arch, shape, mesh=jmesh, mesh_spec=JMesh(mshape, axes),
                             cfg_overrides=over, settings=jst)
        port = dr.lower_cell(arch, shape, mesh=mesh, mesh_spec=spec, cfg_overrides=over,
                             settings=st)
        got[name] = [rows(ref["trace"]), rows(port["trace"])]
    out["/".join([arch, shape] + [f"{k}={v}" for k, v in force.items()])] = got
print("FORCED" + json.dumps(out))
"""

# (semantic, kind, link) that forcing FSDP serving weights adds in one package
# only: (that side, the cases, why)
FORCED_DIFFERENCES = {
    ("moe_dispatch", "all-gather", "nvlink.data"): ("port", (
        "mixtral-8x22b/decode_32k/serve_fsdp=True",),
        "the router weight, split over data, gathered before the router product; XLA "
        "permutes the product's operand instead (the `local` row below)"),
    ("moe_dispatch", "collective-permute", "local"): ("reference", (
        "mixtral-8x22b/decode_32k/serve_fsdp=True",),
        "XLA's permute inside the router product (`gsd,de->gse`) under FSDP, where the port "
        "gathers the router weight (the row above)"),
    ("other", "all-gather", "nvlink.data"): ("port", (
        "mixtral-8x22b/decode_32k/serve_fsdp=True",),
        "a weight gathered over data in the layer's own scope, outside `attention`, where "
        "the port takes k/v whole (`attention._heads`; both packages add the row in "
        "chatglm3-6b's prefill)"),
}
# the weights whose FSDP gathers HSDP keeps inside the pod
WEIGHT_GATHERS = {"attention", "embed_logits", "ffn"}


@pytest.fixture(scope="module")
def forced():
    out = run_subprocess(f"FORCED = {FORCED!r}\nFIELDS = {FIELDS!r}\n" + _FORCED, devices=8,
                         timeout=600)
    line = next(l for l in out.splitlines() if l.startswith("FORCED"))
    return json.loads(line[len("FORCED"):])


def test_forced_serving_rules_change_the_rows_as_the_reference_s(forced):
    """Forcing `serve_fsdp` on (2, 4) at smoke widths: the rows that forcing
    adds to and removes from each package's default cell (weights replicated
    over data: `auto` at these sizes) are the reference's, except where
    `FORCED_DIFFERENCES` names the gap; forcing them off changes nothing."""
    found = {}
    for key, c in forced.items():
        if "serve_fsdp" not in key:
            continue
        (ref0, port0), (ref1, port1) = ([{tuple(r) for r in side} for side in c[k]]
                                        for k in ("default", "forced"))
        ref_delta, port_delta = ref0 ^ ref1, port0 ^ port1
        assert ref_delta or key.endswith("False"), key
        assert not ref_delta or key.endswith("True"), key
        for row in ref_delta ^ port_delta:
            side = "reference" if row in ref_delta else "port"
            found.setdefault(row, (side, set()))[1].add(key)
    assert set(found) == set(FORCED_DIFFERENCES)
    for row, (side, where, why) in FORCED_DIFFERENCES.items():
        assert found[row] == (side, set(where)) and why, row


def test_forced_hsdp_keeps_weight_gathers_inside_the_pod_as_the_reference(forced):
    """`hsdp` on (2, 2, 2) at smoke widths, in both packages: by default the
    weights' gathers cross pods (the reference's `xpod.` group of pod and
    data, the port's per-axis `ib.pod`); under HSDP every one stays on
    `nvlink.data`, and the gradients are all-reduced over the pod alone (the
    reference's `dci.pod`, the port's `ib.pod`)."""
    c = forced["chatglm3-6b/train_4k/hsdp=True"]

    def gathers(rows, crossing):
        return {s for s, k, link in rows if k == "all-gather" and s in WEIGHT_GATHERS
                and ("pod" in link) == crossing}
    for side in (0, 1):
        default, hsdp = ({tuple(r) for r in c[k][side]} for k in ("default", "forced"))
        assert gathers(default, True) == WEIGHT_GATHERS, side
        assert gathers(hsdp, True) == set() and gathers(hsdp, False) == WEIGHT_GATHERS, side
        assert any(s == "grad_sync" and k == "all-reduce" and link.endswith(".pod")
                   for s, k, link in hsdp), side


_FAKE_REAL = r"""
import json
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import StepSettings

mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cpu")
steps = [("chatglm3-6b", ShapeSpec("t", "train", 64, 8), StepSettings(accum=2, remat="full")),
         ("hymba-1.5b", ShapeSpec("t", "train", 32, 8), StepSettings(accum=2, remat="full")),
         ("hymba-1.5b", ShapeSpec("p", "prefill", 64, 4),
          StepSettings(accum=1, remat="none", attn_impl="flash")),
         ("mixtral-8x22b", ShapeSpec("p", "prefill", 64, 4), StepSettings(accum=1, remat="none")),
         ("chatglm3-6b", ShapeSpec("d", "decode", 64, 8), StepSettings(accum=1, remat="none")),
         ("whisper-tiny", ShapeSpec("d", "decode", 64, 8), StepSettings(accum=1, remat="none")),
         ("h2o-danube-3-4b", ShapeSpec("d", "decode", 64, 1, True),
          StepSettings(accum=1, remat="none"))]
out = []
for arch, shape, st in steps:
    cfg = smoke_config(ARCHS[arch])
    got = []
    for fake in (True, False):
        tr, flops, _ = dr.trace_cell(cfg, shape, st, mesh, spec, fake=fake)
        got.append([sorted([e.op_name, e.kind, str(e.replica_groups), e.operand_bytes, e.dtype,
                            e.multiplicity] for e in tr.events),
                    tr.hlo_flops, tr.hlo_bytes, flops, tr.per_device_memory_bytes,
                    tr.hlo_bytes_unfused])
    out.append([arch, shape.kind, got])
print("FAKEREAL" + json.dumps(out))
"""


def test_fake_steps_trace_as_real_steps():
    """Smoke train, prefill and decode steps: the same sites, FLOPs and model
    FLOPs on fake tensors as on real CPU tensors, and the same bytes (fused and
    unfused) where no kernel runs.  A hybrid prefill runs K2 (and K1 with flash): on fake
    tensors through the kernels' custom ops, whose fake implementations count
    FLOPs as the plain versions do, on CPU tensors through the plain versions,
    whose many ops move more bytes than a kernel's one read and write.  The
    fake run's peak of live bytes is > 0 (0 is a CPU run's reading)."""
    out = run_subprocess(_FAKE_REAL, devices=1, timeout=400)
    line = next(l for l in out.splitlines() if l.startswith("FAKEREAL"))
    for arch, kind, (fake, real) in json.loads(line[len("FAKEREAL"):]):
        assert fake[0] and fake[0] == real[0], (arch, kind)
        assert fake[1] > 0 and fake[1] == real[1] and fake[3] == real[3], (arch, kind)
        kernels = kind == "prefill" and arch == "hymba-1.5b"
        assert kernels or fake[2] == real[2], (arch, kind, fake[2], real[2])
        assert kernels or fake[5] == real[5], (arch, kind, fake[5], real[5])
        assert fake[4] > 0 and real[4] == 0, (arch, kind)


def _decode_cases():
    """Smoke configs in fp32 with seed-0 params: chatglm3-6b (batch 2: rows over
    data, sequence over model), h2o-danube-3-4b's ring of 16 slots at batch 1
    (sequence over data and model) decoded past its wrap, qwen2-vl-2b (m-rope
    ids) and whisper-tiny (cross k/v from a prefill)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import api
    rng = np.random.default_rng(0)
    cases = {}
    for name, B, cache_len, windowed, prompt, n in (
            ("chatglm3-6b", 2, 16, False, 0, 12), ("h2o-danube-3-4b", 1, 16, True, 0, 24),
            ("qwen2-vl-2b", 2, 16, False, 0, 6), ("whisper-tiny", 2, 16, False, 8, 6)):
        cfg = smoke_config(ARCHS[name]).replace(compute_dtype="float32")
        params = api.init_params(cfg, 0, device="cpu", dtype=torch.float32)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, n + 1)))
        case = dict(cfg=cfg, B=B, cache_len=cache_len, windowed=windowed, params=params,
                    steps=[(prompt + i, toks[:, i:i + 1]) for i in range(n)])
        if prompt:
            case["prompt"] = api.demo_batch(cfg, B, prompt, seed=1, device="cpu")
        cases[name] = case
    return cases


def test_decode_on_a_sequence_sharded_cache_matches_the_straight_decode(tmp_path):
    """8 gloo ranks decode with the cache placed by `cache_pspecs`: each rank
    writes the new key only where its shard holds the slot and combines the
    partial softmaxes; every step's logits equal the straight decode's (fp32,
    relative 2e-5)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from _torch_dist_worker import decode_cache
    from repro_torch.models import api
    cases = _decode_cases()
    torch.save(cases, tmp_path / "decode_inputs.pt")
    res = subprocess.run([sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
                          "decode", str(tmp_path), "2", "4", str(free_port())],
                         env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    got = torch.load(tmp_path / "decode.pt", weights_only=False)
    for name, case in cases.items():
        cache = decode_cache(case)
        assert any(got[name]["seq_split"]), name
        with torch.no_grad():
            for (pos, tok), mesh_logits in zip(case["steps"], got[name]["logits"]):
                want, cache = api.decode_step(case["cfg"], case["params"], cache, tok, pos)
                err = float((mesh_logits - want).abs().max() / want.abs().max())
                assert err < F32_TOL, (name, pos, err)


def test_cli_runs_whisper_tiny_at_full_width_on_the_cpu(tmp_path):
    """`python -m repro_torch.launch.dryrun --device cpu --arch whisper-tiny
    --shape all --tables --whatif --html DIR --out FILE`: exit 0, one row per
    cell (long_500k skipped, as in the reference), the tables, and an HTML and
    a JSON report per traced cell."""
    html, out = tmp_path / "html", tmp_path / "rows.json"
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
                          "--arch", "whisper-tiny", "--shape", "all", "--tables", "--whatif",
                          "--html", str(html), "--out", str(out)],
                         env={**os.environ, "PYTHONPATH": SRC}, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    rows = json.loads(out.read_text())
    assert [r["shape"] for r in rows] == ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    assert "skipped" in rows[-1]
    for r in rows[:3]:
        assert r["mesh"] == "32x8" and r["n_collectives"] > 0 and r["fits_hbm"], r
        assert r["dominant"] in ("compute", "memory", "collective")
        for ext in ("html", "json"):
            assert (html / f"whisper-tiny_{r['shape']}_32x8.{ext}").stat().st_size > 0
    assert res.stdout.count("OK    whisper-tiny") == 3 and res.stdout.count("est_ms") >= 6


@pytest.mark.parametrize("flags,fields", [
    ([], {"serve_fsdp": None, "hsdp": False}),
    (["--serve-fsdp", "on"], {"serve_fsdp": True, "hsdp": False}),
    (["--serve-fsdp", "off", "--hsdp"], {"serve_fsdp": False, "hsdp": True}),
])
def test_cli_flags_force_the_rule_table(monkeypatch, flags, fields):
    """`--serve-fsdp` and `--hsdp` reach each cell's `StepSettings`, the rest
    of its `settings_for` row unchanged (what each forced table does is held
    against the reference above)."""
    from repro_torch.launch import dryrun as dr, presets
    seen = []

    def lower_cell(arch, shape, *, settings, **kw):
        seen.append((shape, settings))
        return {"arch": arch, "shape": shape, "skipped": "not traced here"}
    monkeypatch.setattr(dr, "lower_cell", lower_cell)
    dr.run_cli(["--device", "cpu", "--arch", "chatglm3-6b", "--shape", "all"] + flags)
    assert [s for s, _ in seen] == list(dr.SHAPE_ORDER)
    for shape, st in seen:
        want = presets.settings_for("chatglm3-6b", shape)
        assert st == dataclasses.replace(want, **fields), shape


# --------------------------------------------------------------------------
# the H100 row of the train settings, and what the dry-run holds at its peak
# --------------------------------------------------------------------------

PRODUCTION = {"(32, 8)": {"data": 32, "model": 8}, "(2, 32, 8)": {"pod": 2, "data": 32, "model": 8}}


@pytest.mark.parametrize("mesh", sorted(PRODUCTION))
def test_h100_train_rows_leave_every_data_rank_a_row(mesh):
    """Every train cell's H100 row splits each micro-batch over every data rank
    (accum <= global batch / (data x pod)); it is the reference's row but the
    accumulation; serving rows are the reference's."""
    from repro_torch.configs import ARCH_ORDER, SHAPES
    from repro_torch.launch import presets
    sizes = PRODUCTION[mesh]
    data = sizes["data"] * sizes.get("pod", 1)
    for arch in ARCH_ORDER:
        for shape in SHAPES:
            st, ref = presets.h100_settings_for(arch, shape, sizes), presets.settings_for(arch, shape)
            if SHAPES[shape].kind != "train":
                assert st == ref, (arch, shape)
                continue
            rows = SHAPES[shape].global_batch // st.accum
            assert rows % data == 0 and rows // data >= 1, (arch, mesh, st.accum)
            assert st.accum == min(ref.accum, SHAPES[shape].global_batch // data)
            assert st == dataclasses.replace(ref, accum=st.accum)


_PEAKS = r"""
import json
from repro_torch.configs import get_config
from repro_torch.core import capture
from repro_torch.launch import dryrun as dr
out = {}
for arch in ("gemma3-4b", "qwen2-vl-2b"):
    cfg = get_config(arch)
    over = {"num_layers": 2}
    if cfg.window_pattern:
        over["window_pattern"] = (cfg.window_pattern[0], 0)
    r = dr.lower_cell(arch, "train_4k", device="cpu", cfg_overrides=over)
    peak = r["trace"].per_device_memory_bytes
    with capture.peak_holders(peak) as taken:
        dr.lower_cell(arch, "train_4k", device="cpu", cfg_overrides=over)
    out[arch] = [peak, cfg.vocab_size, taken[0]]
print("PEAKS" + json.dumps(out))
"""


def test_vocab_parallel_loss_holds_no_whole_logits_chunk_at_the_peak():
    """gemma3-4b and qwen2-vl-2b train_4k at full width and 2 layers, rank 0 of
    (32, 8) on fake tensors: their fake peaks held two whole [micro-batch,
    512, vocab] fp32 tensors on every rank, ~34 and ~40 GB each (the loss's
    one-hot, built from whole targets, and its product with the logits chunk
    in the checkpointed chunk's backward).  With the targets split as the
    logits' rows first the peaks stay under 20 GB, and no tensor live at the
    peak (`capture.peak_holders`) is a [rows, 512, vocab] fp32 one larger
    than the rank's share of the micro-batch's rows."""
    from repro_torch.launch import presets
    out = run_subprocess(_PEAKS, devices=1, timeout=600)
    line = next(l for l in out.splitlines() if l.startswith("PEAKS"))
    peaks = json.loads(line[len("PEAKS"):])
    for arch, (peak, vocab, holders) in peaks.items():
        assert peak < 20e9, (arch, peak)
        rows = 256 // presets.h100_settings_for(arch, "train_4k", PRODUCTION["(32, 8)"]).accum
        assert holders, arch
        for op, scope, shape, dtype, n in holders:
            whole = len(shape) == 3 and shape[1:] == [512, vocab] and shape[0] >= rows
            assert not (whole and dtype == "torch.float32"), (arch, op, scope, shape)


_GRAD_SYNC = r"""
import dataclasses, json
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.presets import StepSettings
mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cpu")
cfg = smoke_config(ARCHS["chatglm3-6b"])
shape = ShapeSpec("t", "train", 64, 8)
out = {}
for accum in (1, 2):
    tr, _, _ = dr.trace_cell(cfg, shape, StepSettings(accum=accum, remat="full"), mesh, spec)
    out[accum] = [[e.op_name, e.kind, str(e.replica_groups), e.operand_bytes, e.multiplicity]
                  for e in tr.events if e.op_name.startswith("grad_sync/")]
    out[f"{accum}_order"] = [e.op_name.split("/")[0] for e in tr.events]
print("SYNC" + json.dumps(out))
"""


def test_grad_sync_in_backward_moves_each_micro_batch_s_gradients():
    """The train step synchronises each gradient by a hook as backward makes
    it, in every micro-batch, as the reference's compiled step does inside
    its scan over micro-batches: at accum 2 the same sites under the
    `grad_sync` scope as at accum 1, each twice; and sites of backward that
    come after the first synchronisation (a smoke chatglm3-6b step on the
    fake (2, 4))."""
    out = run_subprocess(_GRAD_SYNC, devices=1, timeout=400)
    line = next(l for l in out.splitlines() if l.startswith("SYNC"))
    got = json.loads(line[len("SYNC"):])
    one, two = ({tuple(r[:4]): r[4] for r in got[k]} for k in ("1", "2"))
    assert one and set(one) == set(two), got
    assert all(two[k] == 2 * n for k, n in one.items()), got
    for accum in ("1", "2"):
        order = got[f"{accum}_order"]
        first = order.index("grad_sync")
        assert any(o not in ("grad_sync", "optimizer") for o in order[first:]), order

