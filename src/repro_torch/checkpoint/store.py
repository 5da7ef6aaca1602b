"""Checkpoints: atomic, resumable (the port of the reference's
`repro.checkpoint.store`).

Layout (one directory per step), as the reference's:

    ckpt_dir/
      step_000120/
        MANIFEST.json        # leaf keys, shapes, dtypes, the caller's extra
        arr_<idx>.npy        # one file per leaf, gathered to the host
      LATEST                 # atomically-updated pointer file

Trees are nested dicts and lists of tensors; a leaf's key is its path
("params/layers/0/attn/wq").  A step is written to `step_xxx.tmp/` and
renamed, and LATEST is replaced atomically, so a crash mid-write never
corrupts what `restore` reads.  bf16 leaves are stored as their raw bytes
(numpy has no bf16).

On a mesh every leaf is saved whole: each rank gathers each DTensor leaf
(`full_tensor`, a collective), rank 0 writes, and the ranks meet at a
barrier before `save` returns.  `restore` distributes each whole leaf with
the placements of its counterpart in `tree_like`, so a checkpoint restores
onto any mesh shape (the reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import full_tensor
from repro_torch.models.meta import tree_map


def _flatten_with_paths(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    """Atomically write a checkpoint. Returns the final directory.  Every rank of
    a process group calls it (DTensor leaves are gathered); rank 0 writes."""
    leaves = [(key, full_tensor(leaf).detach().cpu()) for key, leaf in _flatten_with_paths(tree)]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer():
        _write(ckpt_dir, final, step, leaves, extra)
    if dist.is_initialized():
        dist.barrier()
    return final


def _write(ckpt_dir: str, final: str, step: int, leaves, extra) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (key, t) in enumerate(leaves):
        fname = f"arr_{i:05d}.npy"
        if t.dtype == torch.bfloat16:
            # numpy has no bf16: the raw bytes, [..., 2] uint8; the manifest's dtype
            # restores the view on load
            arr = t.contiguous().reshape(-1).view(torch.uint8).reshape(*t.shape, 2).numpy()
        else:
            arr = t.numpy()
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"key": key, "file": fname, "shape": list(t.shape),
                                   "dtype": _dtype_name(t.dtype)})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of `tree_like` (which may name a part of what was
    saved; only its leaves are read): each leaf takes the dtype and device of its
    counterpart there, and a DTensor counterpart's mesh and placements; a leaf
    of another shape is refused."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)

    stored = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    out = []
    for key, like in _flatten_with_paths(tree_like):
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        leaf = stored[key]
        t = torch.from_numpy(np.load(os.path.join(d, leaf["file"])))
        if leaf["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16).reshape(leaf["shape"])
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
        t = t.to(device=like.device, dtype=like.dtype)
        if isinstance(like, DTensor):
            t = distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)
        out.append(t)
    it = iter(out)
    return tree_map(lambda _: next(it), tree_like), manifest["extra"]


class AsyncCheckpointer:
    """Double-buffered async writes: tensors are copied to the host at once
    (cheap); serialization runs on a worker thread so the train loop never
    blocks on disk.  `wait()` before exit or the next save; it raises what the
    last write raised."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread = None
        self._error = None

    def save(self, step: int, tree, extra=None) -> None:
        self.wait()
        # a copy even of a CPU tensor: the caller may write it in place meanwhile
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra=extra)
                prune_old(self.ckpt_dir, keep=self.keep)
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    if not _writer() or not os.path.isdir(ckpt_dir):
        return
    steps = sorted(n for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    for name in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
