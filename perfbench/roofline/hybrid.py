"""A hybrid-head decoder's counts (family "hybrid", Hymba): the matmul
weights of one layer (the attention's q, k, v and o, the Mamba branch's
in_proj, x_proj, dt_proj and out_proj, the SwiGLU) and the attention's two
products over the pairs each layer's causal mask and window keep."""
from perfbench.roofline import dense, k1_window, ssm


def layer_params(m):
    """Matmul weights of one layer of the configuration `m` (its "model" block)."""
    return dense.layer_params(m) + ssm.layer_params(m)


def attention_flops(m, S, rows):
    """2·2·H·Dh per kept pair, summed over the layers' windows."""
    kept = sum(k1_window.pairs(S, w) for w in k1_window.windows(m))
    return 4 * m["num_heads"] * m["head_dim"] * kept * rows
