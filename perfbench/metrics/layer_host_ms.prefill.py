"""The host's time in one model layer of the prefill step: the port's `layer`
span (inclusive, `models/transformer.py` `_layer`), its mean over every layer
of the untraced requests of the window, from the port's step records
(`harness/spans.py`).  Each request must hold `num_layers` of them."""
from perfbench.harness import spans


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    n = ctx.model["num_layers"]
    for r in recs:
        count = r.spans.get("layer", (0,))[0]
        if count != n:
            raise RuntimeError(f"step record {r.id} holds {count} layer spans, {n} expected")
    return sum(spans.inclusive_ms(r, "layer") for r in recs) / (n * len(recs))
