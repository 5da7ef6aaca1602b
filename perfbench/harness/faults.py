"""Faults planted under the timed path, to show that `correct` catches them:
each wraps the program's step that the window drives.

Prefill steps (params, batch) -> (logits [B, 1, V], cache):
  state_unchanged  the cache comes back as it was before the prompt: zeros
  half_batch       only the first half of the rows is computed; the other
                   rows get the first half's outputs
  answer_altered   each row's answer is another: its logits rolled by one
                   token
Train steps (params, opt, batch) -> (params, opt, metrics):
  state_unchanged  the step returns params and optimizer state untouched
  half_batch       the step sees the first half of the rows (the mean is
                   taken over the rest)
  token_altered    every eighth token of each row is another token"""
from __future__ import annotations

import torch

from perfbench.reference.common import flat, unflat


def prefill(name):
    def wrap(step):
        def faulty(params, batch):
            tokens = batch["tokens"]
            if name == "half_batch":
                half = max(1, tokens.shape[0] // 2)
                logits, cache = step(params, {"tokens": tokens[:half]})
                reps = -(-tokens.shape[0] // half)
                logits = logits.repeat(reps, 1, 1)[:tokens.shape[0]]
                cache = {k: v.repeat(1, reps, *[1] * (v.ndim - 2))[:, :tokens.shape[0]]
                         for k, v in cache.items()}
                return logits, cache
            logits, cache = step(params, batch)
            if name == "state_unchanged":
                return logits, {k: torch.zeros_like(v) for k, v in cache.items()}
            if name == "answer_altered":
                return logits.roll(1, dims=-1), cache
            raise ValueError(f"no prefill fault {name!r}")
        return faulty
    return wrap


def train(name, vocab):
    def wrap(step):
        def faulty(params, opt, batch):
            tokens = batch["tokens"]
            if name == "state_unchanged":          # the step runs on copies
                copy = lambda tree: tree_map(lambda t: t.clone(), tree)  # noqa: E731
                _, _, metrics = step(copy(params), copy(opt), batch)
                return params, opt, metrics
            if name == "half_batch":
                return step(params, opt, {"tokens": tokens[:tokens.shape[0] // 2]})
            if name == "token_altered":
                t = tokens.clone()
                t[:, ::8] = (t[:, ::8] + 1) % vocab
                return step(params, opt, {"tokens": t})
            raise ValueError(f"no train fault {name!r}")
        return faulty
    return wrap


PREFILL = ("state_unchanged", "half_batch", "answer_altered")
TRAIN = ("state_unchanged", "half_batch", "token_altered")


def tree_map(fn, tree):
    return unflat(tree, {p: fn(t) for p, t in flat(tree)})
