"""Batched serving with the PyTorch port: continuous-batching-lite over a
small LM (the reference's `examples/serve_lm.py`).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch hymba-1.5b --requests 6 \
        [--device cpu]

The arch's smoke config with seed-0 weights, served by `BatchedServer`.
"""
import argparse

import numpy as np

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import api


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(ARCHS[args.arch])
    params = api.init_params(cfg, 0, device=dev)
    server = BatchedServer(cfg, params, max_batch=args.max_batch,
                           cache_len=args.prompt_len + args.max_new + 4)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len,
                                    dtype=np.int32), args.max_new)
            for i in range(args.requests)]
    queue = list(reqs)
    rounds = 0
    while queue or any(server.slots):
        for slot in range(server.max_batch):
            if server.slots[slot] is None and queue:
                r = queue.pop(0)
                print(f"[serve] admitting request {r.rid} into slot {slot}")
                server.prefill_into_slot(slot, r)
        server.decode_round()
        rounds += 1
    print(f"[serve] done in {rounds} decode rounds")
    for r in reqs:
        print(f"  req {r.rid}: prompt {list(r.prompt[:4])}... "
              f"-> generated {r.generated}")


if __name__ == "__main__":
    main()
