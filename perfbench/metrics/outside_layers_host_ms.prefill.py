"""The host's time in the prefill step outside its layers: the port's
`prefill_step` span less its `layer` spans (inclusive), per untraced request
of the window, their mean: the embedding, the cache's stack and pad, the
final norm, the logits and the glue between (`harness/spans.py`)."""
from perfbench.harness import spans


def read(ctx):
    recs = spans.untraced(ctx)
    if recs is None:
        return None
    return sum(spans.inclusive_ms(r, "prefill_step") - spans.inclusive_ms(r, "layer")
               for r in recs) / len(recs)
