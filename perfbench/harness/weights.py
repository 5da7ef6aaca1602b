"""Weights from `--seed`, made on the device in a few large calls.

The tree's shapes and dtypes are the program's (`api.abstract_params`), the
numbers the benchmark's: each leaf takes the first rule of the
configuration's `init` that names it (by the leaf's own key; "*" matches
any).  Every leaf of a rule and dtype is a view into one buffer, drawn by one
generator call, then scaled leaf by leaf in place.  The same seed gives the
same bits, so the reference can make its own copy after the program ran.

Rules: "uniform_fan_in" U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (a [in, out]
matrix's fan-in is its first dim; PyTorch's default for a linear layer),
"uniform:b" U(-b, b), "normal:std", "ones", "zeros", "a_log" (log(1..N)
along the last dim: S4D-real, A = -(1..N)), "dt_inv_softplus:lo:hi:floor"
(the inverse softplus of a time step drawn log-uniform in [lo, hi] and
floored: Mamba's dt bias)."""
from __future__ import annotations

import math

import torch

from perfbench.harness.traffic import generator

CHUNK = 1 << 28          # elements a generator call fills


def rule_for(init, path):
    key = path[-1]
    return init.get(key, init["*"])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _rebuild(tree, made, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, made, path + (str(i),)) for i, v in enumerate(tree)]
    return made[path]


def _draw(buf, kind, gen):
    for s in range(0, buf.numel(), CHUNK):
        part = buf[s:s + CHUNK]
        if kind == "normal":
            part.normal_(0.0, 1.0, generator=gen)
        else:
            part.uniform_(-1.0, 1.0, generator=gen)


def make(specs, init, seed, device):
    """The weights of the tree `specs` (leaves with `.shape` and `.dtype`)."""
    plan = []
    for path, spec in _leaves(specs):
        rule = rule_for(init, path).split(":")
        plan.append((path, tuple(spec.shape), spec.dtype, rule))
    kinds = {"uniform_fan_in": "uniform", "uniform": "uniform", "normal": "normal",
             "dt_inv_softplus": "uniform"}
    made, gen = {}, generator(seed, device, 0)
    groups = {}
    for path, shape, dtype, rule in plan:
        if rule[0] in kinds:
            groups.setdefault((kinds[rule[0]], str(dtype)), []).append((path, shape, dtype, rule))
        elif rule[0] in ("ones", "zeros"):
            made[path] = (torch.ones if rule[0] == "ones" else torch.zeros)(
                shape, dtype=dtype, device=device)
        elif rule[0] == "a_log":
            a = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device).log()
            made[path] = a.expand(shape).to(dtype).contiguous()
        else:
            raise ValueError(f"init rule {':'.join(rule)!r} for {'/'.join(path)}")
    for (kind, _), members in sorted(groups.items()):
        dtype = members[0][2]
        n = sum(math.prod(m[1]) for m in members)
        buf = torch.empty(n, dtype=dtype, device=device)
        _draw(buf, kind, gen)
        off = 0
        for path, shape, _, rule in members:
            size = math.prod(shape)
            leaf = buf[off:off + size].view(shape)
            off += size
            if rule[0] == "uniform_fan_in":
                leaf.mul_(shape[0] ** -0.5)
            elif rule[0] in ("uniform", "normal"):
                leaf.mul_(float(rule[1]))
            else:                                   # dt_inv_softplus:lo:hi:floor
                lo, hi, floor = (float(x) for x in rule[1:4])
                u = leaf.float().add_(1.0).mul_(0.5)
                dt = torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))).clamp_(min=floor)
                leaf.copy_(dt + torch.log(-torch.expm1(-dt)))
            made[path] = leaf
    return _rebuild(specs, made)
