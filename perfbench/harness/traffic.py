"""The one generator every traffic mix goes through: prompt lengths and token
ids from `--seed` and the mix's data file.

Lengths come in blocks: one block holds the distribution's quantiles, rounded,
and each block is put in a balanced order drawn from the seed.  So every seed
sends the same multiset of lengths, in another order, and since every stretch
of a block covers the distribution evenly, a window that ends inside a block
holds the same work whatever the seed."""
from __future__ import annotations

import math

import numpy as np
import torch


def block_lengths(spec):
    """One block's lengths: the quantiles (j + 1/2) / block of the distribution,
    rounded to `round` and kept within [min, max]."""
    lo, hi, rnd, n = spec["min"], spec["max"], spec["round"], spec["block"]
    out = []
    for j in range(n):
        u = (j + 0.5) / n
        if spec["dist"] == "log_uniform":
            x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        elif spec["dist"] == "uniform":
            x = lo + u * (hi - lo)
        else:
            raise ValueError(f"length distribution {spec['dist']!r} not log_uniform|uniform")
        out.append(int(min(hi, max(lo, rnd * round(x / rnd)))))
    return out


def rng(seed, stream):
    """numpy's generator for one use (`stream`) of the seed."""
    return np.random.default_rng([seed & (2 ** 63 - 1), stream])


def balanced(items, r):
    """`items` (sorted) in an order whose every prefix takes from the lower
    and the upper half alike, and so on down: the halves' orders interleaved,
    the seed's generator `r` choosing which half leads where they are equal."""
    if len(items) < 2:
        return list(items)
    half = len(items) // 2
    lower, upper = balanced(items[:half], r), balanced(items[half:], r)
    first, second = (upper, lower) if len(upper) > len(lower) or r.random() < 0.5 \
        else (lower, upper)
    out = []
    for i, x in enumerate(first):
        out.append(x)
        if i < len(second):
            out.append(second[i])
    return out


def lengths(spec, seed, count):
    """The first `count` prompt lengths: blocks, each in a balanced order."""
    block = sorted(block_lengths(spec))
    r = rng(seed, 1)
    reps = -(-count // len(block))
    return [n for _ in range(reps) for n in balanced(block, r)][:count]


def sample(spec, seed, n_done):
    """Indices of finished requests to check: `seeded` drawn from the first
    `from_first` (of those finished), as the seed decides."""
    pool = min(spec["from_first"], n_done)
    k = min(spec["seeded"], pool)
    return sorted(rng(seed, 2).choice(pool, size=k, replace=False).tolist())


def generator(seed, device, stream):
    """A torch generator on `device` for one use of the seed."""
    return torch.Generator(device=device).manual_seed(((seed & (2 ** 62 - 1)) << 1 | stream)
                                                      & (2 ** 63 - 1))


def token_pool(n, vocab, seed, device):
    """n token ids in [0, vocab) from the seed, made on the device in one call."""
    return torch.randint(0, vocab, (n,), generator=generator(seed, device, 1), device=device,
                         dtype=torch.int64)
