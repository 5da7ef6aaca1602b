"""MPI/UCP attribution analogue: op_name metadata -> scope + semantic class.

ucTrace captures a call stack per UCT/UCP event and walks it upward until it
finds an MPI function.  On TPU the compiler bakes the "call stack" into each
HLO op as `metadata={op_name="jit(fn)/scope1/scope2/.../primitive"}` — our
`jax.named_scope` annotations plus the originating jax primitive.  This
module recovers:

  * `scope`     — the named_scope path (e.g. `layer/attn`),
  * `jax_prim`  — the UCP-operation analogue (psum / all_gather / dot_general
                  for GSPMD-inserted collectives),
  * `semantic`  — the MPI-function analogue (grad_sync / attention / moe / ...).
"""
from __future__ import annotations

import re
from typing import Iterable, List, Tuple

import numpy as np

from repro_torch.core.events import CollectiveEvent

# transformations wrappers that appear as path components but are not scopes
_TRANSFORM_RE = re.compile(
    r"^(jit|pjit|jvp|transpose|vmap|remat|checkpoint|custom_vjp|shard_map|"
    r"named_computation)\b")

# ordered semantic rules: (regex on scope path, collective kind or None, label)
SEMANTIC_RULES: List[Tuple[str, str, str]] = [
    (r"moe/(dispatch|router)", "", "moe_dispatch"),
    (r"moe", "all-to-all", "moe_dispatch"),
    (r"moe/combine", "", "moe_combine"),
    (r"moe", "", "moe_combine"),
    (r"(attn|cross_attn|self_attn)", "", "attention"),
    (r"ssm", "", "ssm"),
    (r"mlp", "", "ffn"),
    (r"(embed|logits|vision_stub)", "", "embed_logits"),
    (r"loss", "", "loss"),
    (r"(grad_sync|optimizer|adamw|opt_update)", "", "grad_sync"),
    (r"(data|batch)_shard", "", "data_pipeline"),
    (r"(pipeline|ppermute_ring)", "", "pipeline"),
]


def split_op_name(op_name: str) -> Tuple[str, str]:
    """op_name -> (scope_path, primitive)."""
    if not op_name:
        return "", ""
    parts = op_name.split("/")
    prim = parts[-1] if parts else ""
    scopes = []
    for part in parts[:-1]:
        if _TRANSFORM_RE.match(part):
            # keep the innermost name of wrappers like `transpose(jvp(mlp))`
            inner = re.findall(r"\(([\w\-\. ]+)\)", part)
            if inner and not _TRANSFORM_RE.match(inner[-1]):
                scopes.append(inner[-1])
            continue
        scopes.append(part)
    return "/".join(scopes), prim


DP_AXES = ("data", "pod", "fsdp", "batch", "dp", "replica")


def classify(scope: str, prim: str, kind: str, *, in_backward: bool,
             axes=(), dp_axes=DP_AXES) -> str:
    # GSPMD gradient sync: a backward-pass reduction that spans only
    # data-parallel axes is parameter-gradient synchronization no matter
    # which module's dot it was attributed to.
    if (kind in ("all-reduce", "reduce-scatter") and in_backward
            and axes and all(a in dp_axes for a in axes)):
        return "grad_sync"
    text = scope + "/" + prim
    for pattern, kind_filter, label in SEMANTIC_RULES:
        if kind_filter and kind_filter != kind:
            continue
        if re.search(pattern, text):
            return label
    if kind in ("all-reduce", "reduce-scatter") and in_backward and not scope:
        return "grad_sync"
    return "other"


def is_backward(op_name: str) -> bool:
    return "transpose(" in op_name or "/transpose" in op_name


def attribute_event(ev: CollectiveEvent, dp_axes=DP_AXES) -> None:
    scope, prim = split_op_name(ev.op_name)
    ev.scope = scope
    ev.jax_prim = prim
    ev.semantic = classify(scope, prim, ev.kind,
                           in_backward=is_backward(ev.op_name),
                           axes=ev.axes, dp_axes=dp_axes)


def attribute_all(events: Iterable[CollectiveEvent], dp_axes=DP_AXES) -> None:
    for ev in events:
        attribute_event(ev, dp_axes)


# --------------------------------------------------------------------------
# batched path: run the regex cascade once per unique vocab entry
# --------------------------------------------------------------------------

def attribute_store(store, dp_axes=DP_AXES) -> None:
    """Columnar `attribute_event`: fill scope/jax_prim/semantic in place.

    `op_name` strings are heavily repeated (one per HLO op site, but drawn
    from a small set of named-scope paths), so `split_op_name` and
    `is_backward` run once per *vocab entry* of the interned `op_name`
    column.  The semantic cascade additionally depends on (kind, axes) —
    it runs once per unique (op_name, kind, axes) code triple and
    broadcasts through the composite codes.  Field-for-field equivalent to
    `attribute_all(store.rows())` — pinned by tests/test_ingest.py.
    """
    from repro_torch.core.store import Categorical, build_remap

    n = store.n
    if n == 0:
        store.scope = Categorical.constant(0)
        store.jax_prim = Categorical.constant(0)
        store.semantic = Categorical.constant(0)
        return

    on_vocab = store.op_name.vocab
    split = [split_op_name(name) for name in on_vocab]
    backward = [is_backward(name) for name in on_vocab]
    store.scope = store.op_name.remap_table([s for s, _ in split])
    store.jax_prim = store.op_name.remap_table([p for _, p in split])

    # semantic: unique (op_name, kind, axes) triples
    nk = max(len(store.kind.vocab), 1)
    na = max(len(store.axes_tables), 1)
    combo = (store.op_name.codes.astype(np.int64) * nk
             + store.kind.codes) * na + store.axes_code
    uniq, inv = np.unique(combo, return_inverse=True)
    labels = []
    for code in uniq:
        oc, r = divmod(int(code), nk * na)
        kc, ac = divmod(r, na)
        labels.append(classify(
            split[oc][0], split[oc][1], store.kind.vocab[kc],
            in_backward=backward[oc], axes=store.axes_tables[ac],
            dp_axes=dp_axes))
    sem_map, sem_vocab = build_remap(labels)
    store.semantic = Categorical(sem_map[inv], sem_vocab)
