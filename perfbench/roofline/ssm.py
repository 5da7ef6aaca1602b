"""A Mamba-1 model's counts (family "ssm"): the matmul weights of one layer
(in_proj, x_proj, dt_proj, out_proj); it has no attention."""


def layer_params(m):
    """Matmul weights of one layer of the configuration `m` (its "model" block)."""
    d = m["d_model"]
    di, n = m["expand"] * d, m["ssm_state"]
    r = -(-d // 16)
    return d * 2 * di + di * (r + 2 * n) + r * di + di * d


def attention_flops(m, S, rows):
    return 0
