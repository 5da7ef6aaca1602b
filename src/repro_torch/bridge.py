"""Weight bridge between the reference's param tree and the port's.

Layouts:
  * reference: {"embed": {...}, "layers": {leaf: [L, ...]}, "final_norm": {...}}
    with every per-layer leaf stacked on a leading layer axis, matrices
    `[L, in, out]` (`repro.models.transformer.stack_meta`), all fp32; the
    encoder-decoder adds "enc_layers" (stacked the same way) and "enc_norm",
    its decoder layers hold "cross", its embed a "pos_table" and no
    "out_head" (the head is tied).
  * port: the same dicts, but "layers" and "enc_layers" are lists of
    per-layer dicts, and layer i's leaf is the reference's `[i]` slice:
    matrices stay `[in, out]` (every projection is `x @ w`), vectors `[d]`.

The reference keeps fp32 params and casts each to the compute dtype with
`.astype(dt)` where it is used; the port casts once here (default: the
compute dtype), which gives the same bits at every use; leaves the reference
reads in fp32 (`ParamMeta.dtype`: the SSM's dt_bias, a_log, d_skip, the MoE
router, the q/k norms) stay fp32.  MoE expert weights keep their expert axis:
layer i's `moe/w_gate` is the reference's `[i]`, an `[E, D, F]` tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models import meta as meta_mod

LAYER_LISTS = ("layers", "enc_layers")   # the reference stacks these on a layer axis


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def params_from_jax(np_tree, cfg, device=None, dtype=None):
    """Port params from the reference tree converted leaf by leaf with
    `np.array(...)` (a writable copy; `np.asarray` of a jax array is read-only)."""
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.compute_dtype)

    def one(path, m: meta_mod.ParamMeta):
        if path[0] in LAYER_LISTS:
            arr = _get(np_tree[path[0]], path[2:])[int(path[1])]
        else:
            arr = _get(np_tree, path)
        if tuple(arr.shape) != m.shape:
            raise ValueError(f"{'/'.join(path)}: reference shape {arr.shape}, "
                             f"port expects {m.shape}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=meta_mod.leaf_dtype(m, dtype))

    return meta_mod.tree_map_meta(one, api.model_meta(cfg))


def params_to_jax(params):
    """The reverse: the reference's stacked layout as fp32 numpy arrays."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    def stack(entries):
        if isinstance(entries[0], dict):
            return {k: stack([e[k] for e in entries]) for k in entries[0]}
        return np.stack([host(e) for e in entries])

    def rec(node):
        if isinstance(node, dict):
            return {k: (stack(v) if k in LAYER_LISTS else rec(v)) for k, v in node.items()}
        return host(node)

    return rec(params)
