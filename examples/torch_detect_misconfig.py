"""Fig 7 walkthrough on the PyTorch port: catch a silent sharding
misconfiguration.

    PYTHONPATH=src python examples/torch_detect_misconfig.py              # on the card
    PYTHONPATH=src python examples/torch_detect_misconfig.py --device cpu

Two numerically identical programs (the reference's
`examples/detect_misconfig.py`): 8 MLP layers whose activations are
constrained to be split over `data` before each layer; one has a stale
annotation on alternate layers that constrains them onto `model` instead.
Both train fine; only the captured wire pattern shows the activations
ping-ponging across the mesh every layer.  Each step runs forward, backward
and the gradients' reduction to the weights' layout (as the reference's
`value_and_grad` returns them) as rank 0 of a (2, 4) ("data", "model")
DeviceMesh under torch's fake process group, captured by
`repro_torch.core.trace_step`.
"""
import argparse

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.core import detect, trace_step
from repro_torch.core.report import top_contenders_table
from repro_torch.device import resolve_device
from repro_torch.distributed.autoshard import activation_sharding, constrain_to
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.scope import scope

L, B, S, D, F = 8, 8, 256, 512, 1024
GOOD = (Shard(0), Replicate())          # the batch dim over data
BAD = (Replicate(), Shard(0))           # the stale annotation: the batch dim over model


def make_step(bug: bool):
    def step(w1, w2, x):
        h = x
        for i in range(L):
            with scope("layer"):
                h = constrain_to(h, BAD if (bug and i % 2 == 1) else GOOD)
                with scope("mlp"):
                    z = torch.nn.functional.silu(torch.einsum("bsd,df->bsf", h, w1[i]))
                    h = h + torch.einsum("bsf,fd->bsd", z, w2[i])
        with scope("loss"):
            loss = (h.float() ** 2).mean()
        grads = torch.autograd.grad(loss, (w1, w2))
        # each gradient to its weight's layout: the sum over `data` (the batch split)
        with scope("grad_sync"):
            grads = [g.redistribute(w.device_mesh, w.placements) for g, w in zip(grads, (w1, w2))]
        return loss, grads
    return step


def capture(label: str, mesh, spec, device):
    """One forward + backward step of `label` ("good" or "bad"), captured."""
    gen = torch.Generator().manual_seed(0)

    def placed(shape, placements, grad):
        t = (torch.randn(shape, generator=gen) * 0.02).to(torch.bfloat16).to(device)
        return distribute_tensor(t, mesh, placements, src_data_rank=None).requires_grad_(grad)

    w1 = placed((L, D, F), (Replicate(), Shard(2)), True)
    w2 = placed((L, F, D), (Replicate(), Shard(1)), True)
    x = placed((B, S, D), GOOD, False)
    with activation_sharding(mesh):
        return trace_step(make_step(label == "bad"), (w1, w2, x), mesh, spec, label=label)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh, spec = make_host_mesh((2, 4), ("data", "model"), backend="fake", device=dev.type)
    for label in ("good", "bad"):
        tr = capture(label, mesh, spec, dev)
        print(f"\n=== {label} config ===")
        print(top_contenders_table(tr))
        print(f"modeled collective time: {tr.total_est_time_s()*1e6:.0f} us, "
              f"wire {tr.total_wire_bytes()/1e6:.1f} MB")
        for f in detect.run_all(tr, expected_axes={"grad_sync": "data",
                                                   "ffn": "model"})[:5]:
            print(" ", f)


if __name__ == "__main__":
    main()
