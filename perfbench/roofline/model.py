"""Model FLOPs of a prefill and of a train step, from a configuration's sizes.

Each family's counts sit in `roofline/<family>.py` (its `layer_params` and
`attention_flops`), found by the configuration's "family".  N counts the
matmul weights a token passes through: every projection of every layer and
the LM head, no embedding gather.  A prefill runs the head on the last
position alone, so it counts 2·N_layers per prompt token, 2·D·V per row, and
the family's attention.  A train step counts 6·N per token (forward and
backward, no recomputation) with the head on every position, as the usual
model-FLOPs rule does."""
import importlib


def family(m):
    """The counts of the configuration `m`'s family."""
    return importlib.import_module(f"perfbench.roofline.{m['family']}")


def flops_param_count(m):
    """N of 6·N·tokens: the layers' matmul weights and the LM head's."""
    return m["num_layers"] * family(m).layer_params(m) + m["d_model"] * m["vocab_size"]


def prefill_flops(m, rows, S):
    """One prefill of `rows` prompts of S tokens, the head on the last position."""
    fam = family(m)
    body = 2 * m["num_layers"] * fam.layer_params(m) * rows * S
    return body + 2 * m["d_model"] * m["vocab_size"] * rows + fam.attention_flops(m, S, rows)


def train_flops(m, rows, S):
    """One train step over rows x S tokens: 6·N·tokens and attention's 3 x 2 products."""
    return 6 * flops_param_count(m) * rows * S + 3 * family(m).attention_flops(m, S, rows)
