"""The port's sharding rules against the reference's, and the constraints'
no-op without a mesh.

Both packages' specs are computed in one subprocess: the reference on an
Auto-axes (2, 4) ("data", "model") jax mesh over 8 forced host devices, the
port on a (2, 4) DeviceMesh under torch's fake process group.  The port
keeps one dict per layer where the reference stacks layers, so a reference
layer spec is held without its leading `layers` entry (always None).  Lint
findings are held by code, severity, site and bytes at stake (the port's
messages name DTensor's fallback, not XLA's).
"""
import json

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.distributed import autoshard
from repro_torch.distributed.sharding import P, placements_for
from repro_torch.models import api

_SPECS = r"""
import json
import jax
import numpy as np
from jax.sharding import AxisType
from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.distributed import sharding as jsh
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh

jmesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
mesh, _ = make_host_mesh((2, 4), ("data", "model"), backend="fake", device="cpu")

def plain(tree):
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [plain(v) for v in tree]
    return [list(e) if isinstance(e, tuple) else e for e in tree]

def lint(findings):
    return [[f.detector, f.severity, f.site, f.wasted_bytes] for f in findings]

out = {}
for name in ARCHS:
    cfg, jcfg = ARCHS[name], JARCHS[name]
    shape = SHAPES["train_4k"]
    jshape = JSHAPES["train_4k"]
    dshape = SHAPES["decode_32k"]
    jdshape = JSHAPES["decode_32k"]
    out[name] = {
        "param": [plain(sh.param_pspecs(cfg, mesh)), plain(jsh.param_pspecs(jcfg, jmesh))],
        "opt": [plain(sh.opt_state_pspecs(cfg, mesh)), plain(jsh.opt_state_pspecs(jcfg, jmesh))],
        "batch": [plain(sh.batch_pspecs(cfg, shape, mesh)), plain(jsh.batch_pspecs(jcfg, jshape, jmesh))],
        "cache": [plain(sh.cache_pspecs(cfg, dshape, mesh)), plain(jsh.cache_pspecs(jcfg, jdshape, jmesh))],
        "lint": [lint(sh.lint_sharding(cfg, mesh, shape=shape)),
                 lint(jsh.lint_sharding(jcfg, jmesh, shape=jshape))],
        "serve": [sh.serve_rules_for(cfg, mesh) is sh.SERVE_RULES_REPLICATED,
                  jsh.serve_rules_for(jcfg, jmesh) is jsh.SERVE_RULES_REPLICATED],
    }
print("SPECS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def specs():
    out = run_subprocess(_SPECS, devices=8, timeout=300)
    line = next(l for l in out.splitlines() if l.startswith("SPECS"))
    return json.loads(line[len("SPECS"):])


def _unstack(ref, n_layers):
    """The reference's stacked layer specs as the port's per-layer list."""
    layers = ref["layers"]
    def strip(tree):
        if isinstance(tree, dict):
            return {k: strip(v) for k, v in tree.items()}
        assert tree[0] is None, tree     # the stacked `layers` dim is never sharded
        return tree[1:]
    return {**ref, "layers": [strip(layers)] * n_layers}


def _unstack_encdec(ref, cfg):
    out = _unstack(ref, cfg.num_layers)
    enc = _unstack({"layers": ref["enc_layers"]}, cfg.encoder_layers)["layers"]
    return {**out, "enc_layers": enc}


def _port_layout(cfg, ref):
    return _unstack_encdec(ref, cfg) if cfg.family == "encdec" else _unstack(ref, cfg.num_layers)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_pspecs_match_reference(specs, arch):
    """Every param's per-dim mesh axes, and the AdamW moments' (the same
    tree), equal the reference's on 2x4, dimension by dimension."""
    cfg = ARCHS[arch]
    port, ref = specs[arch]["param"]
    assert port == _port_layout(cfg, ref)
    (po, ro) = specs[arch]["opt"]
    assert po["m"] == po["v"] == port and po["count"] == ro["count"] == []
    assert _port_layout(cfg, ro["m"]) == po["m"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_cache_and_serve_rules_match_reference(specs, arch):
    """batch_pspecs (train_4k), cache_pspecs (decode_32k) and serve_rules_for."""
    for what in ("batch", "cache", "serve"):
        port, ref = specs[arch][what]
        assert port == ref, what


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lint_sharding_matches_reference(specs, arch):
    """The lint's findings (code, severity, site, bytes), in the same order;
    the reference stacks layers, so its per-layer findings count once for all
    layers and carry the stacked bytes."""
    cfg = ARCHS[arch]
    port, ref = specs[arch]["lint"]
    per_layer = cfg.num_layers

    def norm(findings, stacked):
        out = []
        for code, sev, site, nbytes in findings:
            parts = site.split("/")
            if not stacked and len(parts) > 2 and parts[1] in ("layers", "enc_layers") \
                    and parts[2].isdigit():
                site = "/".join(parts[:2] + parts[3:])
            out.append((code, sev, site))
        return sorted(set(out))
    assert norm(port, False) == norm(ref, True)
    assert per_layer >= 1


def test_placements_follow_the_specs():
    """placements_for: Shard(d) on the mesh dims a spec names, Replicate
    elsewhere; a dim over two axes is split in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert placements_for(P(("pod", "data"), "model"), Mesh) == [Shard(0), Shard(0), Shard(1)]
    assert placements_for(P(None, "data"), Mesh) == [Replicate(), Shard(1), Replicate()]
    assert placements_for(P(), Mesh) == [Replicate()] * 3


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x22b", "whisper-tiny"])
def test_constraints_leave_forward_unchanged_without_a_mesh(arch, monkeypatch):
    """Without `activation_sharding`, every constrain* call returns its input:
    a forward's logits equal those of a run with the calls replaced by the
    identity, bit for bit (and inside the context a plain tensor is left as
    it is)."""
    cfg = smoke_config(ARCHS[arch]).replace(compute_dtype="float32")
    params = api.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    batch = api.demo_batch(cfg, 2, 32, device="cpu")
    with torch.no_grad():
        logits, _ = api.forward(cfg, params, batch, attn_impl="naive")
        calls = []

        def identity(x, *a, **k):
            calls.append(1)
            return x
        for mod in ("layers", "transformer", "encdec", "moe", "attention", "losses"):
            m = __import__(f"repro_torch.models.{mod}", fromlist=["_"])
            for name in ("constrain", "constrain_residual", "constrain_logits"):
                if hasattr(m, name):
                    monkeypatch.setattr(m, name, identity)
        plain, _ = api.forward(cfg, params, batch, attn_impl="naive")
    assert calls
    assert torch.equal(logits, plain)
    x = torch.ones(2, 3, 4)

    class Mesh:
        mesh_dim_names = ("data", "model")
        mesh = np.empty((2, 4))
    with autoshard.activation_sharding(Mesh):
        assert autoshard.constrain_residual(x) is x
