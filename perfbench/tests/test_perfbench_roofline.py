"""The yardstick's counts against what the repo measured with them before."""
import math

import pytest

from perfbench.roofline import k1, k2, model


def test_k1_bound_at_chatglm3_shape():
    """chip_smoke.py's K1 bf16 bound at (4, 32, 2, 1024, 128), causal: 0.0348 ms."""
    assert k1.bound_s(4, 32, 2, 1024, 128) * 1e3 == pytest.approx(0.0348, abs=5e-5)


def test_k2_bound_at_falcon_mamba_shape():
    """chip_smoke.py's fused K2 bound at (4, 1024, 8192, 16), x in bf16: 0.1011 ms."""
    assert k2.bound_s(4, 1024, 8192, 16) * 1e3 == pytest.approx(0.1011, abs=5e-5)


@pytest.mark.parametrize("name", ["chatglm3-6b", "falcon-mamba-7b", "falcon-mamba-7b-l4"])
def test_model_param_count_matches_port(name):
    import json
    from perfbench.tests.helpers import ROOT
    from perfbench.harness import program
    from repro_torch.models import api
    from perfbench.reference.common import flat
    m = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())["model"]
    cfg = program.model_config({"model": m})
    # the port's N also counts the weights no matmul reads: norms, the conv, A, D, biases
    other = sum(math.prod(spec.shape) for path, spec in flat(api.abstract_params(cfg))
                if path[-1] in ("scale", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip"))
    assert model.flops_param_count(m) == api.flops_param_count(cfg) - other


def test_prefill_flops_counts_head_once_per_row():
    m = {"family": "ssm", "num_layers": 1, "d_model": 16, "expand": 2, "ssm_state": 4,
         "vocab_size": 10}
    layer = model.family(m).layer_params(m)
    assert model.prefill_flops(m, 2, 8) == 2 * layer * 16 + 2 * 16 * 10 * 2
