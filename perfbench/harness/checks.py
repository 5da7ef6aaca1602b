"""The numbers that decide `correct`, each against its limit.

Serving (a prefill's outputs against the reference's, per checked request):
  logits_rel  ||l - l_ref|| / ||l_ref|| of a row's last-position logits, the
              worst row of the checked requests
  cache_rel   ||c - c_ref|| / ||c_ref|| of one layer's cache tensor (k, v, or
              conv, ssm), the worst layer and tensor; positions the program
              keeps past the prompt are held against zeros
(The served token itself is the argmax of the compared logits.  Its gap
below the reference's best logit is not compared: with random weights the
control leaves most rows' argmax alone, so it gives that gap no upper
reading; PERF.md has the readings.)
Training (the program's first steps against the reference's):
  loss_gap    |loss - loss_ref| / |loss_ref|, the worst of the checked steps
  grad_gap    | ||g|| - ||g_ref|| | of step 1's clipped gradient, per leaf,
              over the larger of the reference leaf's norm and the median
              leaf's; the worst leaf
  change_gap  the same of each leaf's change over the checked steps; leaves
              whose reference gradient is under a thousandth of the median
              leaf's are left out (they move by round-off alone)
"""
from __future__ import annotations

import statistics

import torch


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def serving(prog_logits, prog_cache, ref_logits, ref_cache):
    """Readings of one request: prog_logits [B, V], prog_cache {name: [L, B, S', ...]}
    (S' >= S), ref_logits [B, V], ref_cache {name: [per layer [B, S, ...]]}."""
    out = {"logits_rel": max(rel(p, r) for p, r in zip(prog_logits, ref_logits))}
    worst = 0.0
    for name, layers in ref_cache.items():
        for li, r in enumerate(layers):
            p = prog_cache[name][li]
            if p.shape != r.shape:            # k/v kept past the prompt: zeros there
                r = torch.nn.functional.pad(r, (0, 0, 0, 0, 0, p.shape[1] - r.shape[1]))
            worst = max(worst, rel(p, r))
    out["cache_rel"] = worst
    return out


def worst(readings):
    """The worst of each number over several requests' readings."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def leaf_gap(prog, ref, keep=None):
    med = statistics.median(ref.values())
    keys = [k for k in ref if keep is None or k in keep]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def unmoved(ref):
    """Leaves whose step-1 gradient in the reference is under a thousandth of
    the median leaf's: they move by round-off alone."""
    med = statistics.median(ref["grad1_raw"].values())
    return sorted("/".join(k) for k, g in ref["grad1_raw"].items() if g < 1e-3 * med)


def training(prog, ref):
    """prog/ref: {"loss": [...], "grad1": {path: norm}, "change": {path: norm}};
    ref also "grad1_raw"."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    moved = {k for k in ref["grad1_raw"] if "/".join(k) not in set(unmoved(ref))}
    return {"loss_gap": max(losses), "grad_gap": leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], moved)}


def judge(readings, limits):
    """(correct, {name: {"value", "limit"}}): every reading at or under its limit.
    A reading with no limit, or one that is not finite, is not correct."""
    out, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or not value == value or value > limit:
            ok = False
    return ok, out
