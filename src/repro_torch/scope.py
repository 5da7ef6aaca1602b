"""Named scopes: the port's `jax.named_scope`.

`scope(name)` opens a `torch.profiler.record_function` range of that name
(what the card's profiler shows) and pushes the name onto a per-thread
stack, which the collective capture (`repro_torch.core.capture`) reads: a
dispatch mode cannot see the profiler's open ranges.  Model, loss and
optimizer code open every scope through this helper.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Tuple

from torch.profiler import record_function

_local = threading.local()
# the autograd-node metadata key under which a node's forward scope path is kept
NODE_KEY = "scope"


def current() -> Tuple[str, ...]:
    """The names of the scopes open on this thread, outermost first."""
    return tuple(getattr(_local, "names", ()))


def mark(t):
    """Record the open scope path on `t`'s autograd node, unless it has one: for
    a node made by an autograd Function (a sharding constraint, `local_map`),
    which the capture's function mode does not see made.  Returns `t`."""
    node = getattr(t, "grad_fn", None)
    if node is not None and NODE_KEY not in node.metadata:
        node.metadata[NODE_KEY] = current()
    return t


@contextmanager
def scope(name: str) -> Iterator[None]:
    names = getattr(_local, "names", None)
    if names is None:
        names = _local.names = []
    names.append(name)
    try:
        with record_function(name):
            yield
    finally:
        names.pop()
