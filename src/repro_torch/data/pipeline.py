"""Deterministic synthetic token pipeline (the port of the reference's
`repro.data.pipeline`).

An infinite, seekable stream: the batch of each step derives from the seed
and the step alone, through the same numpy `SeedSequence([seed, step])`
draws as the reference's, so both packages give bitwise-equal batches and a
restart at step N reproduces the batch.  Batches are numpy arrays;
`to_device` makes tensors of them, and `shard_batch` DTensors on a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import n_image_patches


@dataclass(frozen=True)
class DataConfig:
    batch_size: int
    seq_len: int
    seed: int = 1234
    # markov-ish synthetic text: token t+1 depends on token t (so a model
    # can actually reduce loss, giving the integration tests signal)
    structure: float = 0.8


class SyntheticTokens:
    """Seekable deterministic LM token stream."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.data.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, d = self.cfg, self.data
        rng = self._rng(step)
        B, S = d.batch_size, d.seq_len
        # structured stream: x_{t+1} = (a * x_t + noise) % V_eff
        v_eff = min(cfg.vocab_size, 4096)
        start = rng.integers(0, v_eff, (B, 1))
        toks = [start]
        for _ in range(S - 1):
            prev = toks[-1]
            nxt = (prev * 31 + 7) % v_eff
            mask = rng.random((B, 1)) < d.structure
            rand = rng.integers(0, v_eff, (B, 1))
            toks.append(np.where(mask, nxt, rand))
        tokens = np.concatenate(toks, axis=1).astype(np.int32)

        batch: Dict[str, np.ndarray] = {"tokens": tokens}
        if cfg.family == "encdec":
            batch["frame_embeds"] = rng.standard_normal(
                (B, cfg.source_len, cfg.d_model), dtype=np.float32)
        if cfg.family == "vlm":
            n_img = n_image_patches(cfg, S)
            batch["tokens"] = tokens[:, : S - n_img]
            batch["patch_embeds"] = rng.standard_normal(
                (B, n_img, cfg.d_model), dtype=np.float32)
            pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S))
            batch["positions"] = np.ascontiguousarray(pos)
        return batch

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


def shard_batch(batch: Dict[str, np.ndarray], mesh, placements) -> Dict[str, torch.Tensor]:
    """A host batch as DTensors on `mesh`, each leaf with its `placements[key]`
    (`sharding.placements_for` of `sharding.batch_pspecs`); with no
    placements, plain tensors on the mesh's device.  Every rank draws the same
    host batch from the seed, so each keeps its own rows and nothing is
    communicated."""
    if placements is None:
        return to_device(batch, mesh.device_type)
    return {k: distribute_tensor(torch.from_numpy(v).to(mesh.device_type), mesh,
                                 placements[k], src_data_rank=None)
            for k, v in batch.items()}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Tensors of a host batch on `device`, dtypes kept (int32 tokens index as
    they are)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
