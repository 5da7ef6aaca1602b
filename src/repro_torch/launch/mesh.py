"""Device meshes for the port (after the reference's `launch/mesh.py`).

`make_host_mesh` returns a `torch.distributed` DeviceMesh and the matching
`core.topology.MeshSpec`.  Three backends:
  * `fake`: torch's fake process group; this one process stands as rank 0
    of the whole mesh.  Collectives write nothing, so a step runs one
    rank's compute and dispatches every collective (what the capture
    records), but gathered values are not real;
  * `gloo`: one real CPU process per rank (the caller starts them, e.g.
    with `torch.multiprocessing`), for values on the CPU;
  * `nccl`: one process per card (a one-card machine runs world size 1).
The process group is created here when none exists; `gloo` and `nccl` read
the rank, world size and rendezvous address from the caller (arguments, or
the `RANK`/`WORLD_SIZE`/`MASTER_ADDR`/`MASTER_PORT` environment).

`make_production_mesh` is the dry-run's H100 production mesh under the fake
group: (32, 8) ("data", "model") over 256 cards, 32 DGX nodes with their 8
GPUs on `model` (NVLink) and `data` across nodes (InfiniBand), or (2, 32, 8)
("pod", "data", "model") over 512.  Not the reference's TPU (16, 16): the
port's production cells are its own (`core.topology.MeshSpec.single_pod`).
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.topology import MeshSpec
from repro_torch.device import resolve_device

BACKEND_DEVICE = {"fake": None, "gloo": "cpu", "nccl": "cuda"}


def _init_group(backend: str, world: int, rank, init_method) -> None:
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"the process group has {dist.get_world_size()} ranks, "
                             f"the mesh needs {world}")
        return
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        return
    kw = {} if init_method is None else {"init_method": init_method}
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, world_size=world, **kw)


def make_host_mesh(shape=(2, 4), axes=("data", "model"), *, backend: str = "fake",
                   device: str = None, rank: int = None, init_method: str = None):
    """(DeviceMesh, MeshSpec) of `shape` over `axes`.  `device` is where the
    tensors live: "cpu" or "cuda" (default: "cuda" for nccl, "cpu" for gloo;
    `fake` takes either, the card unless "cpu" is asked for)."""
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"backend {backend!r} not in {sorted(BACKEND_DEVICE)}")
    device = device or BACKEND_DEVICE[backend] or resolve_device(None).type
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    _init_group(backend, math.prod(shape), rank, init_method)
    mesh = init_device_mesh(device, shape, mesh_dim_names=axes)
    return mesh, MeshSpec(shape, axes)


def make_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    return MeshSpec.multi_pod() if multi_pod else MeshSpec.single_pod()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production DeviceMesh under the fake process group, this process
    standing as rank 0, on `device` (the card unless "cpu" is asked for).  A
    fake group of another size is replaced; any other group raises."""
    spec = make_mesh_spec(multi_pod=multi_pod)
    if dist.is_initialized() and dist.get_world_size() != spec.num_devices:
        if dist.get_backend() != "fake":
            raise ValueError(f"a {dist.get_backend()} group of {dist.get_world_size()} ranks "
                             f"is open; the production mesh needs a fake one")
        dist.destroy_process_group()
    mesh, _ = make_host_mesh(spec.shape, spec.axes, backend="fake",
                             device=resolve_device(device).type)
    return mesh


def parse_mesh(text: str):
    """"DxM" -> (D, M) for the ("data", "model") mesh."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {text!r} is not DxM (e.g. 2x4)") from None
    return d, m
