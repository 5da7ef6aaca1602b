"""Ranks of a `gloo` process group for tests/test_torch_dist.py.

    python tests/_torch_dist_worker.py step OUT_DIR D M PORT

starts D*M processes (spawn), each rank r of a (D, M) ("data", "model")
mesh.  Each loads the fp32 params, batch and settings the test wrote to
OUT_DIR/inputs.pt, runs one sharded `make_train_step`, checks that
`shard_batch` gave it its own rows, and rank 0 writes the whole params,
moments and metrics to OUT_DIR/sharded.pt.
"""
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def step_rank(rank: int, out_dir: str, shape, port: int) -> None:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import sharding
    from repro_torch.distributed.autoshard import activation_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.meta import tree_map
    from repro_torch.optim import adamw

    mesh, _ = make_host_mesh(shape, ("data", "model"), backend="gloo", rank=rank,
                             init_method=f"tcp://localhost:{port}")
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    cfg, oc, st, host = inp["cfg"], inp["opt_cfg"], inp["settings"], inp["batch"]
    B, S = host["tokens"].shape
    params = sharding.distribute_params(inp["params"], mesh,
                                        sharding.param_placements(cfg, mesh))
    specs = sharding.batch_pspecs(cfg, ShapeSpec("t", "train", S, B), mesh)
    batch = shard_batch(host, mesh, {k: sharding.placements_for(s, mesh)
                                     for k, s in specs.items()})
    # shard_batch: this rank holds its own rows of the host batch
    rows = B // mesh.size(0)
    d = mesh.get_local_rank("data")
    local = batch["tokens"].to_local().numpy()
    assert (local == host["tokens"][d * rows:(d + 1) * rows]).all(), "shard_batch rows"

    opt = adamw.init(oc, params)
    with activation_sharding(mesh, seq_shard=st.seq_shard):
        params, opt, metrics = make_train_step(cfg, oc, st)(params, opt, batch)
        whole = {"params": tree_map(sharding.full_tensor, params),
                 "m": tree_map(sharding.full_tensor, opt["m"]),
                 "v": tree_map(sharding.full_tensor, opt["v"]),
                 "metrics": {k: float(sharding.full_tensor(v)) for k, v in metrics.items()}}
    if rank == 0:
        torch.save(whole, os.path.join(out_dir, "sharded.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, out_dir, d, m, port = sys.argv[1:6]
    shape = (int(d), int(m))
    if mode != "step":
        raise SystemExit(f"unknown mode {mode!r}")
    mp.start_processes(step_rank, args=(out_dir, shape, int(port)), nprocs=shape[0] * shape[1],
                       start_method="spawn")
