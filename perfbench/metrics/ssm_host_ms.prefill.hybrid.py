"""The host's time in one layer's Mamba branch of the prefill step: the
port's `ssm` scope (inclusive, `models/ssm.py` `apply_ssm`: `conv`,
`ssm_params`, `scan`, `out_proj`), its mean over every layer of the
untraced requests of the window, from the port's step records
(`harness/spans.py`).  Each request must hold `num_layers` of them.  Beside
`layer_host_ms.prefill` it splits a hybrid layer's host time between its
two branches."""
from perfbench.harness import spans


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    n = ctx.model["num_layers"]
    for r in recs:
        count = r.spans.get("ssm", (0,))[0]
        if count != n:
            raise RuntimeError(f"step record {r.id} holds {count} ssm spans, {n} expected")
    return sum(spans.inclusive_ms(r, "ssm") for r in recs) / (n * len(recs))
