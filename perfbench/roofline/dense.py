"""A dense decoder's counts (family "dense"): the matmul weights of one layer
and causal attention's two products."""


def layer_params(m):
    """Matmul weights of one layer of the configuration `m` (its "model" block)."""
    d = m["d_model"]
    q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    mlp = (3 if m.get("glu", True) else 2) * d * m["d_ff"]
    return d * q + 2 * d * kv + q * d + mlp


def attention_flops(m, S, rows):
    """Causal attention's two products over `rows` prompts of S, every layer:
    2·2·H·Dh per kept pair."""
    return 4 * m["num_heads"] * m["head_dim"] * (S * (S + 1) // 2) * m["num_layers"] * rows
