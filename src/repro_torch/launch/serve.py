"""Batched serving loop: continuous-batching-lite prefill/decode.

Requests arrive with prompts; the scheduler packs up to `max_batch` active
sequences, prefills new arrivals, and steps decode for the whole batch.
Finished sequences free their slot for waiting requests.

This mirrors the reference `repro.launch.serve` as it is, lite semantics
included: a prompt is fed one token at a time through the decode step, with
the other slots stepped on token 0; `decode_round` decodes every active slot
at the largest active position.  For the ssm and hybrid families those
token-0 steps also advance the other slots' SSM state (the reference's
behaviour; its recurrent state has no position to mask by).  Neither kernel
is on this path (as in the reference): decode attention is naive and the SSM
decode step is one recurrence update.  The prefill step factory launches them.
The vlm family serves text only here: a decode step with no `positions` turns
every m-rope section by the token's position, as the reference's does.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --requests 4 --max-new 8            # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
        --smoke --device cpu                # --arch: every decoder-only arch (--help)

whisper-tiny, the encoder-decoder, is refused here as in the reference; it
serves through `api.prefill` and `api.decode_step`.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import api as model_api
from repro_torch.models import transformer


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [P] int
    max_new: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


# the reference's serve driver targets the decoder-only families; the
# encoder-decoder serves through api.prefill and api.decode_step
SERVABLE = sorted(name for name, c in ARCHS.items() if c.family != "encdec")


class BatchedServer:
    """Slot-based batched decoder over one static-length decode cache."""

    def __init__(self, cfg, params, *, max_batch=8, cache_len=512):
        if cfg.family == "encdec":
            raise NotImplementedError(f"{cfg.name}: the batched server targets decoder-only "
                                      "families, as the reference's does")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.device = params["embed"]["in_table"].device
        self.cache = transformer.init_cache(cfg, max_batch, cache_len,
                                            windowed=False, device=self.device)
        self.pos = np.zeros(max_batch, np.int64)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # per-slot positions: decode uses one shared position (slots are
        # kept position-aligned by the scheduler in this lite implementation)
        self._decode = make_decode_step(cfg)

    def _step(self, tok: np.ndarray, pos: int) -> np.ndarray:
        logits, self.cache = self._decode(self.params, self.cache,
                                          torch.from_numpy(tok).to(self.device), pos)
        return logits[:, 0].float().cpu().numpy()

    def prefill_into_slot(self, slot: int, req: Request):
        """Run the prompt through decode steps (aligned-batch lite path)."""
        self.slots[slot] = req
        self.pos[slot] = 0
        for t in req.prompt:
            tok = np.zeros((self.max_batch, 1), np.int64)
            tok[slot, 0] = t
            logits = self._step(tok, int(self.pos[slot]))
            self.pos[slot] += 1
        req._last_logits = logits[slot]

    def decode_round(self) -> None:
        active = [i for i, r in enumerate(self.slots) if r and not r.done]
        if not active:
            return
        tok = np.zeros((self.max_batch, 1), np.int64)
        for i in active:
            r = self.slots[i]
            tok[i, 0] = r.generated[-1] if r.generated else int(np.argmax(r._last_logits))
        lg = self._step(tok, int(max(self.pos[i] for i in active)))
        for i in active:
            r = self.slots[i]
            r.generated.append(int(np.argmax(lg[i])))
            self.pos[i] += 1
            if len(r.generated) >= r.max_new or self.pos[i] >= self.cache_len - 1:
                r.done = True
                self.slots[i] = None

    def run(self, requests: List[Request]) -> None:
        """Serve `requests` to completion, filling free slots in arrival order."""
        queue = list(requests)
        while queue or any(self.slots):
            for slot in range(self.max_batch):
                if self.slots[slot] is None and queue:
                    self.prefill_into_slot(slot, queue.pop(0))
            self.decode_round()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=SERVABLE)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    device = resolve_device(args.device)
    params = model_api.init_params(cfg, 0, device=device)
    server = BatchedServer(cfg, params, max_batch=args.max_batch,
                           cache_len=max(64, args.prompt_len + args.max_new + 2))

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len), args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    server.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in reqs)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}: {len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    for r in reqs[:2]:
        print(f"  req {r.rid}: {r.prompt[:4].tolist()}... -> {r.generated[:8]}")


if __name__ == "__main__":
    main()
