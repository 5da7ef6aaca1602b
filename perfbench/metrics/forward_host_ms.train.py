"""The host's time in the train step's `forward` spans, each micro-batch's
`loss_fn` (`launch/steps.py` `make_train_step`): their inclusive ms per
untraced step of the window, the mean over those steps, from the port's step
records (`harness/spans.py`)."""
from perfbench.harness import spans


def read(ctx):
    return spans.mean_inclusive_ms(ctx, "forward")
