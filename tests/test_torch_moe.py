"""The MoE FFN (GShard einsum dispatch) against the reference's `models/moe.py`.

`router_dispatch` on the same fp32 probabilities must give the same dispatch
and combine tables (equal) and aux loss (rounding); `apply_moe` on the same
input matches at the default capacity factor (with drops) and at the no-drop
capacity; prefill + decode matches forward with no drops; `BatchedServer`'s
greedy tokens match the reference's (`test_torch_serve.py`).

Tolerances, as max |port - ref| / max |ref|: fp32 2e-5, bf16 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import batch_pair, model_pair, randn, rel_err, to_np
from repro.models import api as jax_api
from repro.models import layers as JL
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro_torch.models import api, moe

TOL = {"float32": 2e-5, "bfloat16": 0.02}
DTYPES = ["float32", "bfloat16"]
MOE_ARCHS = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]


def _no_drops(cfg):
    return cfg.num_experts / cfg.top_k


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["layers"])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 2.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_dispatch_matches_reference(arch, capacity_factor):
    cfg, jcfg, _, _ = model_pair(arch, "float32", capacity_factor=capacity_factor)
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 32, cfg.num_experts)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cap = moe.capacity(cfg, 32)
    assert cap == jax_moe.capacity(jcfg, 32)
    dispatch, combine, aux = moe.router_dispatch(cfg, torch.from_numpy(probs), cap)
    jd, jc, jaux = jax_moe.router_dispatch(jcfg, jnp.asarray(probs), cap)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(combine.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    kept = dispatch.sum(dim=(2, 3))
    if capacity_factor == _no_drops(cfg):    # 2.0 for both smoke configs (E 4, top-2)
        assert bool((kept == cfg.top_k).all())
    if capacity_factor == 0.5:               # drops, on the reference's tokens
        assert bool((kept < cfg.top_k).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity_factor", ["default", "no_drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_reference(arch, capacity_factor, dtype):
    cfg, jcfg, jp, p = model_pair(arch, dtype)
    if capacity_factor == "no_drops":
        cfg = cfg.replace(capacity_factor=_no_drops(cfg))
        jcfg = jcfg.replace(capacity_factor=_no_drops(jcfg))
    x, xn = randn(np.random.default_rng(1), (2, 24, cfg.d_model), dtype)
    for group_size in (0, 8):                # one group per sequence, and 3 per sequence
        y, aux = moe.apply_moe(cfg, p["layers"][1]["moe"], x, group_size=group_size)
        jy, jaux = jax_moe.apply_moe(jcfg, _layer(jp, 1)["moe"], jnp.asarray(xn, dtype),
                                     group_size=group_size)
        assert y.dtype == x.dtype
        assert rel_err(to_np(y), jy) < TOL[dtype], group_size
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_router_is_stored_and_read_in_fp32():
    """The reference reads the router in fp32; bf16 params keep it fp32, and a
    bf16 copy routes differently on these inputs."""
    cfg, _, _, p = model_pair("mixtral-8x22b", "bfloat16")
    layer = p["layers"][0]["moe"]
    assert layer["router"].dtype == torch.float32
    assert layer["w_gate"].dtype == torch.bfloat16
    assert layer["w_gate"].shape == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    x, _ = randn(np.random.default_rng(2), (4, 64, cfg.d_model), "bfloat16")
    probs = torch.softmax(x.float() @ layer["router"], -1)
    probs16 = torch.softmax(x.float() @ layer["router"].bfloat16().float(), -1)
    assert not torch.equal(probs.topk(cfg.top_k).indices, probs16.topk(cfg.top_k).indices)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_decode_matches_forward_without_drops(arch, dtype):
    """The analogue of the reference's test of the same name, held against the
    reference's forward as well."""
    cfg, jcfg, jp, p = model_pair(arch, dtype)
    cfg = cfg.replace(capacity_factor=_no_drops(cfg))
    jcfg = jcfg.replace(capacity_factor=_no_drops(jcfg))
    B, S = 2, 16
    batch, jbatch = batch_pair(cfg, B, S)
    full, _ = api.forward(cfg, p, batch, attn_impl="naive")
    _, cache = api.prefill(cfg, p, {"tokens": batch["tokens"][:, :-1]}, attn_impl="flash",
                           cache_len=S)
    lg, _ = api.decode_step(cfg, p, cache, batch["tokens"][:, -1:], S - 1)
    assert rel_err(to_np(lg[:, 0]), to_np(full[:, -1])) < TOL[dtype]
    jfull, _ = jax_api.forward(jcfg, jp, jbatch, attn_impl="naive")
    assert rel_err(to_np(lg[:, 0]), jfull[:, -1]) < TOL[dtype]


def test_reference_bf16_moe_drops_differ_between_its_own_runs():
    """Why the bf16 forward of a MoE arch is compared at the no-drop capacity
    (`test_torch_archs.py`): at the default capacity the reference's
    scan-compiled forward and its own layers run one by one drop different
    tokens of mixtral's smoke config; the port's forward agrees with the latter."""
    cfg, jcfg, jp, p = model_pair("mixtral-8x22b", "bfloat16")
    batch, jbatch = batch_pair(cfg, 2, 16)
    jlogits, _ = jax_api.forward(jcfg, jp, jbatch, attn_impl="naive")
    x, positions = jax_transformer.embed_inputs(jcfg, jp, jbatch)
    for i, w in enumerate(jcfg.layer_windows()):
        x, _, _ = jax_transformer.apply_block(jcfg, _layer(jp, i), x, positions, w)
    eager = JL.logits_head(jcfg, jp["embed"], JL.apply_norm(jcfg, jp["final_norm"], x))
    assert rel_err(jlogits, eager) > 0.05
    logits, _ = api.forward(cfg, p, batch, attn_impl="naive")
    assert rel_err(to_np(logits), eager) < TOL["bfloat16"]
