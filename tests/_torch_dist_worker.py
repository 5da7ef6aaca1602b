"""Ranks of a `gloo` process group for tests/test_torch_dist.py and
tests/test_torch_moe_ep.py.

    python tests/_torch_dist_worker.py MODE OUT_DIR D M PORT

starts D*M processes (spawn), each rank r of a (D, M) ("data", "model")
mesh.  MODE is
  * `step`: each rank loads the fp32 params, batch and settings the test
    wrote to OUT_DIR/inputs.pt, runs one sharded `make_train_step`, checks
    that `shard_batch` gave it its own rows, and rank 0 writes the whole
    params, moments and metrics to OUT_DIR/sharded.pt;
  * `moe`: each rank loads the MoE config, fp32 weights and x [B, S, D] from
    OUT_DIR/moe_inputs.pt, places the weights by the training rules and x's
    rows over `data`, and runs `models.moe.apply_moe` with each
    (name, dispatch, dtype, backward) of `MOE_RUNS`: the backward is of
    mean(y^2) + 0.01 * aux.  Rank 0 writes each run's whole y, aux and
    gradients (x's and the weights') to OUT_DIR/moe.pt;
  * `decode`: each rank loads the cases of OUT_DIR/decode_inputs.pt (a
    config, its fp32 params, a prompt, the positions to decode at), prefills
    on plain tensors, places the params by the serving rules and the cache
    by `sharding.cache_pspecs` (its sequence split over the mesh), and
    decodes each position on the mesh; rank 0 writes the whole logits of
    every step to OUT_DIR/decode.pt;
  * `collectives` (D*M = 8): each rank loads OUT_DIR/coll_inputs.pt and runs
    every `distributed.algorithms` all-reduce on its shard of each payload
    (on an (8,) ("data",) mesh over `data`, and on a (2, 4) ("data", "model")
    mesh over `model`; the (8,) case also with a DTensor), then `ppermute`
    with the inputs' pairs: its output, the gradient of sum(sin(y) * w)
    and whether each bad pair table raised.  Each rank writes
    OUT_DIR/coll_{rank}.pt;
  * `pipeline` (D*M = 4): each rank loads the cases of OUT_DIR/pipe_inputs.pt
    (stage weights [P, L, D, D], micro-batches [M, mb, D], the mesh) and runs
    `distributed.pipeline.pipeline_apply` with a tanh stage of L layers, the
    weights as plain tensors and as a DTensor placed Shard(0) on `model`.
    Each rank writes OUT_DIR/pipe_{rank}.pt;
  * `capture`: each rank loads the config, fp32 params, host batch and
    settings of OUT_DIR/capture_inputs.pt, runs one sharded train step under
    `core.trace_step` (`capture_step`) and writes the trace as a capture dump,
    OUT_DIR/host{rank:03d}_step000.jsonl, as a running job's ranks do.
"""
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def free_port() -> int:
    """A free localhost port for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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


MOE_RUNS = (("sort", "sort", torch.float32, True), ("einsum", "einsum", torch.float32, True),
            ("sort_bf16", "sort", torch.bfloat16, False))


def moe_rank(rank: int, out_dir: str, shape, port: int) -> None:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import sharding
    from repro_torch.distributed.autoshard import activation_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.meta import tree_map_meta
    from repro_torch.models.moe import apply_moe, moe_meta

    mesh, _ = make_host_mesh(shape, ("data", "model"), backend="gloo", rank=rank,
                             init_method=f"tcp://localhost:{port}")
    inp = torch.load(os.path.join(out_dir, "moe_inputs.pt"), weights_only=False)
    cfg = inp["cfg"]
    sizes = sharding.mesh_axis_sizes(mesh)
    specs = tree_map_meta(lambda _p, m: sharding.spec_for(m.shape, m.logical,
                                                          sharding.TRAIN_RULES, sizes),
                          moe_meta(cfg))
    out = {}
    for name, dispatch, dtype, backward in MOE_RUNS:
        params = {k: distribute_tensor(v, mesh, sharding.placements_for(specs[k], mesh),
                                       src_data_rank=None).requires_grad_(backward)
                  for k, v in inp["params"].items()}
        x = distribute_tensor(inp["x"].to(dtype), mesh, [Shard(0), Replicate()],
                              src_data_rank=None).requires_grad_(backward)
        with activation_sharding(mesh):
            y, aux = apply_moe(cfg.replace(moe_dispatch=dispatch), params, x)
            if backward:
                ((y.float() ** 2).mean() + 0.01 * aux).backward()
            res = {"y": sharding.full_tensor(y).detach().float(),
                   "aux": float(sharding.full_tensor(aux))}
            if backward:
                res["grads"] = {k: t.grad.full_tensor() for k, t in
                                [("x", x)] + sorted(params.items())}
        out[name] = res
    if rank == 0:
        torch.save(out, os.path.join(out_dir, "moe.pt"))
    dist.barrier()
    dist.destroy_process_group()


def decode_cache(case):
    """A case's starting cache on plain tensors: a prefill of its prompt padded to
    `cache_len`, or zeros (`transformer.init_cache`)."""
    from repro_torch.models import api, transformer
    cfg, B = case["cfg"], case["B"]
    if "prompt" in case:
        with torch.no_grad():
            return api.prefill(cfg, case["params"], case["prompt"], cache_len=case["cache_len"])[1]
    return transformer.init_cache(cfg, B, case["cache_len"], windowed=case["windowed"],
                                  dtype=torch.float32, device="cpu")


def decode_rank(rank: int, out_dir: str, shape, port: int) -> None:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.distributed.autoshard import activation_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.meta import tree_map

    mesh, _ = make_host_mesh(shape, ("data", "model"), backend="gloo", rank=rank,
                             init_method=f"tcp://localhost:{port}")
    cases = torch.load(os.path.join(out_dir, "decode_inputs.pt"), weights_only=False)
    out = {}
    for name, case in cases.items():
        cfg = case["cfg"]
        dshape = ShapeSpec("d", "decode", case["cache_len"], case["B"], case["windowed"])
        specs = sharding.cache_pspecs(cfg, dshape, mesh)
        cache = tree_map(lambda t, s: sharding.distribute_params(
            t, mesh, sharding.placements_for(s, mesh)), decode_cache(case), specs)
        params = sharding.distribute_params(case["params"], mesh, sharding.param_placements(
            cfg, mesh, sharding.serve_rules_for(cfg, mesh)))
        logits = []
        with torch.no_grad(), activation_sharding(mesh):
            for pos, tok in case["steps"]:
                lg, cache = api.decode_step(cfg, params, cache, tok, pos)
                logits.append(sharding.full_tensor(lg))
        k, seq_dim = (cache[0]["k"], 1) if isinstance(cache, list) else (cache["k"], 2)
        out[name] = {"logits": logits, "seq_split": [p.is_shard(seq_dim) for p in k.placements]}
    if rank == 0:
        torch.save(out, os.path.join(out_dir, "decode.pt"))
    dist.barrier()
    dist.destroy_process_group()


def collectives_rank(rank: int, out_dir: str, shape, port: int) -> None:
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.distributed.algorithms import ALGORITHMS, allreduce_fn
    from repro_torch.distributed.ppermute import ppermute
    from repro_torch.launch.mesh import make_host_mesh

    inp = torch.load(os.path.join(out_dir, "coll_inputs.pt"), weights_only=False)
    out = {}
    for name, (mshape, axes, axis) in inp["meshes"].items():
        mesh, _ = make_host_mesh(mshape, axes, backend="gloo", rank=rank,
                                 init_method=f"tcp://localhost:{port}")
        x = torch.from_numpy(inp["x"][name])
        rows = x.shape[0] // mesh.size(axes.index(axis))
        i = mesh.get_local_rank(axis)
        local = x[i * rows:(i + 1) * rows].contiguous()
        for alg in ALGORITHMS:
            out[name, alg] = allreduce_fn(alg, mesh, axis)(local)
            if len(mshape) == 1:
                dt = DTensor.from_local(local, mesh, [Shard(0)])
                y = allreduce_fn(alg, mesh, axis)(dt)
                out[name, alg, "dtensor"] = (y.to_local(), y.placements == dt.placements)
    group = dist.group.WORLD
    x = torch.from_numpy(inp["p_x"][rank]).requires_grad_(True)
    y = ppermute(x, inp["pairs"], group)
    (torch.sin(y) * torch.from_numpy(inp["p_w"][rank])).sum().backward()
    out["ppermute"] = (y.detach(), x.grad)
    raised = []
    for bad in inp["bad_pairs"]:
        try:
            ppermute(x.detach(), bad, group)
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["raised"] = raised
    torch.save(out, os.path.join(out_dir, f"coll_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def pipeline_rank(rank: int, out_dir: str, shape, port: int) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_host_mesh

    def stage(w, h):
        for wi in w:
            h = torch.tanh(h @ wi)
        return h

    cases = torch.load(os.path.join(out_dir, "pipe_inputs.pt"), weights_only=False)
    out = {}
    for name, case in cases.items():
        mesh, _ = make_host_mesh(case["mesh"], case["axes"], backend="gloo", rank=rank,
                                 init_method=f"tcp://localhost:{port}")
        w, x = torch.from_numpy(case["w"]), torch.from_numpy(case["x"])
        plain = pipeline_apply(stage, w, x, mesh, axis="model")
        i = mesh.get_local_rank("model")
        placements = [Shard(0) if a == "model" else Replicate() for a in case["axes"]]
        wd = DTensor.from_local(w[i:i + 1].contiguous(), mesh, placements)
        sharded = pipeline_apply(lambda p, h: stage(p["w"], h), {"w": wd}, x, mesh,
                                 axis="model")
        out[name] = (plain, sharded)
    torch.save(out, os.path.join(out_dir, f"pipe_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def capture_step(mesh, spec, inp):
    """The trace of one train step of `inp` (config, fp32 params, host batch,
    settings) on `mesh`: the params placed by the training rules, the batch
    by its specs.  Used by the `capture` ranks and by the fake-group capture
    the tests hold them against."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import trace_step
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import sharding
    from repro_torch.distributed.autoshard import activation_sharding
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg, oc, st, host = inp["cfg"], inp["opt_cfg"], inp["settings"], inp["batch"]
    B, S = host["tokens"].shape
    params = sharding.distribute_params(inp["params"], mesh,
                                        sharding.param_placements(cfg, mesh))
    specs = sharding.batch_pspecs(cfg, ShapeSpec("t", "train", S, B), mesh)
    batch = shard_batch(host, mesh, {k: sharding.placements_for(s, mesh)
                                     for k, s in specs.items()})
    with activation_sharding(mesh, seq_shard=st.seq_shard):
        return trace_step(make_train_step(cfg, oc, st), (params, adamw.init(oc, params), batch),
                          mesh, spec, label="smoke")


def capture_rank(rank: int, out_dir: str, shape, port: int) -> None:
    from repro_torch.core.dump import capture_path, write_capture
    from repro_torch.launch.mesh import make_host_mesh

    mesh, spec = make_host_mesh(shape, ("data", "model"), backend="gloo", rank=rank,
                                init_method=f"tcp://localhost:{port}")
    inp = torch.load(os.path.join(out_dir, "capture_inputs.pt"), weights_only=False)
    write_capture(capture_step(mesh, spec, inp), capture_path(out_dir, rank, 0), mesh=spec)
    dist.barrier()
    dist.destroy_process_group()


MODES = {"step": step_rank, "moe": moe_rank, "decode": decode_rank,
         "collectives": collectives_rank, "pipeline": pipeline_rank,
         "capture": capture_rank}

if __name__ == "__main__":
    mode, out_dir, d, m, port = sys.argv[1:6]
    shape = (int(d), int(m))
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode!r}")
    mp.start_processes(MODES[mode], args=(out_dir, shape, int(port)),
                       nprocs=shape[0] * shape[1], start_method="spawn")
