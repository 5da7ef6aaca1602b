"""The dry-run: every (arch x shape) cell's step on the H100 production mesh,
captured, priced and attributed without a cluster (the port of the
reference's `launch/dryrun.py`).

    python -m repro_torch.launch.dryrun --arch all --shape all [--both-meshes]
        [--tables] [--whatif] [--html DIR] [--out FILE] [--device cpu]
        [--serve-fsdp on|off] [--hsdp]

The reference lowers and compiles each cell's jitted step for 256 or 512
placeholder devices and parses the collectives out of the compiled HLO.
Here one process stands as rank 0 of the production mesh
(`launch.mesh.make_production_mesh`: (32, 8) or (2, 32, 8) under torch's
fake process group) and runs the cell's step once, at full width and full
depth, on fake tensors (`FakeTensorMode`, on the card unless `--device cpu`):
nothing is allocated, no collective moves, and `core.trace_step` records
every collective the step dispatches, the rank's FLOPs and bytes, and its
peak of live tensor bytes.  Each cell is the reference's step (the same
rule table, inputs and model FLOPs) at the H100 row of its settings
(`presets.h100_settings_for`: the reference's `settings_for` row with the
accumulation capped so that each micro-batch splits over every data rank).

`lower_cell` returns the reference's keys but `compile_s`, `compiled` and
`parse_s`: nothing is compiled, and the capture is the trace.  Its
`memory_ms` (and `dominant`, `mfu_bound`) read the capture's fused byte
count (`hlo_gb`: pointwise chains taken as fused regions, the counterpart
of XLA's fused bytes accessed); `hlo_gb_unfused` and `memory_ms_unfused`
are every eager op's bytes counted one by one (`core.capture`).  `lower_s`
is the fake run's seconds.  `mem_model_gb` is the reference's analytic HBM
model (`analytic_memory_bytes`), held against the H100's 80 GB for
`fits_hbm`; `mem_gb_per_dev` the capture's fake peak (where the reference
prints XLA's CPU `memory_analysis()`).  The mesh's size is the fake group's
world size: no environment variable is set at import.

`--serve-fsdp` and `--hsdp` force the rule table, as the reference's
`StepSettings.serve_fsdp`/`hsdp` do when a caller sets them (its
`examples/diff_configs.py`): serving weights FSDP-split over the data axes
(on) or replicated over them (off) where `auto` decides by their size, and
training weights split within a pod and replicated across pods.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from contextlib import nullcontext
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_ORDER, SHAPE_ORDER, SHAPES, get_config, shape_applicable
from repro_torch.core.capture import trace_step
from repro_torch.core.report import semantic_table, to_html, to_json, top_contenders_table
from repro_torch.core.roofline import decode_model_flops, roofline, train_model_flops
from repro_torch.core.topology import H100, MeshSpec
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.launch import presets, steps
from repro_torch.launch.mesh import make_mesh_spec, make_production_mesh
from repro_torch.models import api as model_api
from repro_torch.models.meta import leaves, tree_map
from repro_torch.optim import adamw


def analytic_memory_bytes(cfg, shape, st, mesh, rules) -> Dict[str, float]:
    """Per-device HBM model at declared dtypes, the reference's: sharded params,
    optimizer moments, gradient accumulator and live gradient, layer-boundary
    remat saves, KV caches and activations, plus 15% working-set slack.
    `mesh` is a DeviceMesh or a `MeshSpec`."""
    sizes = sh.mesh_axis_sizes(mesh)
    param_elems = sum(_local_count(m.shape, s, sizes) for m, s in
                      zip(leaves(model_api.model_meta(cfg)),
                          leaves(sh.param_pspecs(cfg, mesh, rules))))
    out: Dict[str, float] = {}
    B, S = shape.global_batch, shape.seq_len
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    if shape.kind == "train":
        pbytes = param_elems * 4                       # fp32 masters
        opt_b = 2 * param_elems * (2 if st.opt_state_dtype == "bfloat16" else 4)
        accum_b = param_elems * (2 if st.accum_dtype == "bfloat16" else 4) \
            if st.accum > 1 else 0
        grad_b = param_elems * 4                       # live grad during update
        tok_local = max(B // dp, 1) * S // max(st.accum, 1)
        saves = cfg.num_layers * tok_local * cfg.d_model * 2
        if st.seq_shard:
            saves //= max(sizes.get("model", 1), 1)
        if cfg.family == "encdec":
            saves += cfg.encoder_layers * max(B // dp, 1) * cfg.source_len * cfg.d_model * 2
        out.update(params=pbytes, opt=opt_b, accum=accum_b, grad=grad_b, saves=saves)
    else:
        out["params"] = param_elems * 2                # bf16 serving weights
        if shape.kind == "decode":
            cache = model_api.cache_specs(cfg, shape)
            cps = sh.cache_pspecs(cfg, shape, mesh)
            centries = [cache] if isinstance(cache, dict) else cache
            cpss = [cps] if isinstance(cps, dict) else cps
            out["cache"] = float(sum(_local_count(spec.shape, especs[k], sizes) * spec.dtype.itemsize
                                     for entry, especs in zip(centries, cpss)
                                     for k, spec in entry.items()))
        else:  # prefill: caches produced as outputs + activations
            tok_local = max(B // dp, 1) * S
            kvb = cfg.num_layers * tok_local * cfg.kv_dim * 2 * 2
            out["cache"] = kvb / max(sizes.get("model", 1), 1) if cfg.family != "ssm" else 0.0
            out["acts"] = tok_local * cfg.d_model * 2 * 4
    total = sum(out.values())
    out["total_with_slack"] = total * 1.15
    return out


def _local_count(shape, spec, sizes) -> int:
    """Elements of one rank's shard of a tensor of `shape` placed by `spec`."""
    div = 1
    for part in spec:
        for a in ((part,) if isinstance(part, str) else (part or ())):
            div *= sizes[a]
    return int(np.prod(shape)) // max(div, 1)


def cache_gathers(trace, cfg, shape, mesh):
    """The all-gather sites of a decode trace's attention whose input is one
    rank's shard of a k/v cache leaf (a gather of the cache; the capture
    records an all-gather's gathered bytes, its group times its input);
    `mesh` a DeviceMesh or `MeshSpec`.  Empty when decode reads the cache
    where it lies."""
    sizes = sh.mesh_axis_sizes(mesh)
    specs, pspecs = model_api.cache_specs(cfg, shape), sh.cache_pspecs(cfg, shape, mesh)
    entries = [(specs, pspecs)] if isinstance(specs, dict) else list(zip(specs, pspecs))
    shard = {_local_count(e[k].shape, p[k], sizes) * e[k].dtype.itemsize
             // (cfg.num_layers if isinstance(specs, dict) else 1)
             for e, p in entries for k in e if k in ("k", "v")}
    return [e for e in trace.events if e.kind == "all-gather" and "attn_decode" in e.op_name
            and e.operand_bytes // e.group_size in shard]


def _serve_rules(cfg, mesh, st):
    if st.serve_fsdp is None:
        return sh.serve_rules_for(cfg, mesh)
    return sh.SERVE_RULES_FSDP if st.serve_fsdp else sh.SERVE_RULES_REPLICATED


def abstract_opt_state(params_abs, state_dtype: str):
    """AdamW's state as `CacheSpec`s: m and v in `state_dtype`, the int32 count."""
    dt, spec = getattr(torch, state_dtype), type(next(leaves(params_abs)))
    return {"m": tree_map(lambda p: spec(p.shape, dt), params_abs),
            "v": tree_map(lambda p: spec(p.shape, dt), params_abs),
            "count": spec((), torch.int32)}


def cell_rules(cfg, shape, st, mesh):
    """The rule table the cell places its params by."""
    if shape.kind == "train":
        return sh.TRAIN_RULES_HSDP if st.hsdp else sh.TRAIN_RULES
    return _serve_rules(cfg, mesh, st)


def _placed(specs, mesh, pspecs, fake: bool, fill):
    """`specs` as DTensors placed by `pspecs`: empty ones on fake tensors, else
    `fill(path-free spec tree)`'s values distributed."""
    placements = tree_map(lambda s: sh.placements_for(s, mesh), pspecs)
    if fake:
        return model_api.empty_dtensors(specs, mesh, placements)
    return sh.distribute_params(fill(), mesh, placements)


def _cell_inputs(cfg, shape, st, mesh, *, fake: bool, seed: int):
    """(step, args, model FLOPs) of the cell.  On fake tensors every input is an
    empty DTensor; otherwise params come from `seed` (`sharding.init_params`),
    the batch from `api.demo_batch`, and the decode cache is zeros."""
    rules = cell_rules(cfg, shape, st, mesh)
    B, S, dev = shape.global_batch, shape.seq_len, mesh.device_type
    p_dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    pspecs = sh.param_pspecs(cfg, mesh, rules)
    if fake:
        params = _placed(model_api.abstract_params(cfg, p_dtype), mesh, pspecs, True, None)
    else:
        params = sh.init_params(cfg, seed, mesh, dtype=p_dtype, rules=rules)
    n_flops = model_api.flops_param_count(cfg)
    if shape.kind in ("train", "prefill"):
        bspecs = model_api.batch_specs(cfg, shape)
        batch = _placed(bspecs, mesh, sh.batch_pspecs(cfg, shape, mesh), fake, lambda: {
            k: v.to(bspecs[k].dtype) for k, v in
            model_api.demo_batch(cfg, B, S, seed=seed, device=dev).items()})
        if shape.kind == "train":
            opt_cfg = adamw.AdamWConfig(state_dtype=st.opt_state_dtype)
            if fake:
                ospecs = abstract_opt_state(model_api.abstract_params(cfg, p_dtype),
                                            st.opt_state_dtype)
                opt = {k: _placed(ospecs[k], mesh, pspecs, True, None) for k in ("m", "v")}
                opt["count"] = torch.zeros((), dtype=torch.int32, device=dev)
            else:
                opt = adamw.init(opt_cfg, params)
            return (steps.make_train_step(cfg, opt_cfg, st), (params, opt, batch),
                    train_model_flops(n_flops, B * S))
        return (steps.make_prefill_step(cfg, st), (params, batch),
                decode_model_flops(n_flops, B * S))
    dspecs = model_api.decode_input_specs(cfg, shape)
    cache = _placed(dspecs["cache"], mesh, sh.cache_pspecs(cfg, shape, mesh), fake,
                    lambda: tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                                     dspecs["cache"]))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, 1), dtype=np.int32)).to(dev)
    # the step that fills the cache's last slot (the reference traces an abstract pos)
    args = [params, cache, tokens, S - 1]
    if cfg.family == "vlm":
        args.append(torch.full((3, B, 1), S - 1, dtype=torch.int32, device=dev))
    return steps.make_decode_step(cfg), tuple(args), decode_model_flops(n_flops, B)


def trace_cell(cfg, shape, st, mesh, spec: MeshSpec, *, fake: bool = True, seed: int = 0,
               label: Optional[str] = None):
    """Run the cell's step once as rank 0 of `mesh` (a DeviceMesh) under
    `core.trace_step`, inside `activation_sharding` (sequence-sharded residuals
    when `st.seq_shard` on a train step), on fake tensors or on real ones from
    `seed`.  Returns (trace, model FLOPs, seconds of the run)."""
    label = label or f"{cfg.name}/{shape.name}/{'x'.join(map(str, spec.shape))}"
    with torch.no_grad():          # the inputs are made outside the step's autograd
        mode = _fake_mode() if fake else nullcontext()
        with mode:
            step, args, model_flops = _cell_inputs(cfg, shape, st, mesh, fake=fake, seed=seed)
    t0 = time.perf_counter()
    with mode, activation_sharding(mesh, seq_shard=st.seq_shard and shape.kind == "train"):
        trace = trace_step(step, args, mesh, spec, label=label, hw=H100)
    return trace, model_flops, time.perf_counter() - t0


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    # plain tensors the step meets (the mesh's rank table, constants) are taken as they are
    return FakeTensorMode(allow_non_fake_inputs=True)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               settings: Optional[presets.StepSettings] = None, mesh=None,
               mesh_spec: Optional[MeshSpec] = None,
               cfg_overrides: Optional[Dict[str, Any]] = None, device=None) -> Dict[str, Any]:
    """Trace one (arch x shape x mesh) cell on fake tensors; return its row and
    its trace (`"trace"`).  `mesh` defaults to the production mesh on `device`
    (the card unless "cpu"), `settings` to the H100 row on that mesh
    (`presets.h100_settings_for`).  The row has the reference's keys but
    `compile_s` and `compiled`: nothing is compiled."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        mesh_spec = make_mesh_spec(multi_pod=multi_pod)
    if mesh_spec is None:
        raise ValueError("a mesh passed in needs its mesh_spec")
    st = settings or presets.h100_settings_for(arch, shape_name, sh.mesh_axis_sizes(mesh))
    name = "x".join(map(str, mesh_spec.shape))
    trace, model_flops, secs = trace_cell(cfg, shape, st, mesh, mesh_spec,
                                          label=f"{arch}/{shape_name}/{name}")
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": name,
                              "lower_s": round(secs, 2)}
    result.update(roofline(trace, H100, model_flops=model_flops).row())
    # the roofline's memory term reads the fused count; the unfused one beside it
    result["hlo_gb"] = trace.hlo_bytes / 1e9
    result["hlo_gb_unfused"] = trace.hlo_bytes_unfused / 1e9
    result["memory_ms_unfused"] = trace.hlo_bytes_unfused / H100.hbm_bw * 1e3
    result["collective_bytes_per_dev"] = trace.total_collective_bytes()
    result["coll_overlap_ms"] = round(trace.overlapped_est_time_s() * 1e3, 3)
    result["n_collectives"] = int(sum(e.multiplicity for e in trace.events))
    mem_model = analytic_memory_bytes(cfg, shape, st, mesh, cell_rules(cfg, shape, st, mesh))
    result["mem_model_gb"] = round(mem_model["total_with_slack"] / 1e9, 2)
    result["fits_hbm"] = bool(mem_model["total_with_slack"] <= H100.hbm_per_chip)
    result["trace"] = trace
    return result


def run_cli(argv=None):
    ap = argparse.ArgumentParser(description="multi-node dry-run on the H100 production mesh")
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="JSON results path (append)")
    ap.add_argument("--html", default=None, help="write HTML trace report dir")
    ap.add_argument("--tables", action="store_true",
                    help="print top-contenders + semantic tables")
    ap.add_argument("--whatif", action="store_true",
                    help="sweep the default what-if scenario grid over each trace and print "
                         "a baseline-vs-best roofline overlay (core.whatif, hardwareless)")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--serve-fsdp", choices=("auto", "on", "off"), default="auto",
                    help="serving weights FSDP-split over data (on), replicated (off), or "
                         "split only where they do not fit replicated (auto)")
    ap.add_argument("--hsdp", action="store_true",
                    help="train weights split within a pod, replicated across pods")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live: the card (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)       # no card and no --device cpu: raise before any cell

    archs = list(ARCH_ORDER) if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPE_ORDER) if args.shape in (None, "all") else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    rows = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                st = presets.h100_settings_for(arch, shape_name,
                                               sh.mesh_axis_sizes(make_mesh_spec(multi_pod=mp)))
                if args.accum:
                    st = dataclasses.replace(st, accum=args.accum)
                if args.remat:
                    st = dataclasses.replace(st, remat=args.remat)
                if args.grad_compression:
                    st = dataclasses.replace(st, grad_compression=args.grad_compression)
                st = dataclasses.replace(
                    st, hsdp=args.hsdp,
                    serve_fsdp={"auto": None, "on": True, "off": False}[args.serve_fsdp])
                try:
                    r = lower_cell(arch, shape_name, multi_pod=mp, settings=st,
                                   device=args.device)
                except Exception as e:  # a failed cell is reported; the sweep goes on
                    traceback.print_exc()
                    print(f"FAIL  {arch:24s} {shape_name:12s} "
                          f"{type(e).__name__}: {str(e)[:200]}", flush=True)
                    rows.append({"arch": arch, "shape": shape_name,
                                 "failed": f"{type(e).__name__}: {str(e)[:300]}"})
                    continue
                if "skipped" in r:
                    print(f"SKIP  {arch:24s} {shape_name:12s} {r['skipped']}", flush=True)
                    rows.append(r)
                    continue
                tr = r.pop("trace")
                print(f"OK    {arch:24s} {shape_name:12s} mesh={r['mesh']:9s} "
                      f"mem={r['mem_model_gb']:6.2f}GB(model)/"
                      f"{r['mem_gb_per_dev']:7.2f}GB(fake peak) "
                      f"fits={'Y' if r['fits_hbm'] else 'N'} "
                      f"comp={r['compute_ms']:9.2f}ms "
                      f"hbm={r['memory_ms']:9.2f}ms(fused)/{r['memory_ms_unfused']:9.2f}ms "
                      f"coll={r['collective_ms']:9.2f}ms "
                      f"dom={r['dominant']:10s} mfu_bound={r['mfu_bound']:.3f} "
                      f"useful={r['useful_ratio']:.2f} "
                      f"n_coll={r['n_collectives']} "
                      f"(fake run {r['lower_s']}s)", flush=True)
                spec = make_mesh_spec(multi_pod=mp)
                if args.tables:
                    print(top_contenders_table(tr))
                    print(semantic_table(tr))
                if args.whatif:
                    from repro_torch.core import whatif
                    from repro_torch.core.roofline import scenario_overlay_table
                    results = whatif.sweep(tr.store, spec)
                    rf = roofline(tr, H100, model_flops=r["model_gflops"] * 1e9)
                    print(scenario_overlay_table(rf, results))
                    best = results[0] if results else None
                    if best is not None and best.saved_s > 0:
                        print(f"      best config: {best.scenario.name} "
                              f"saves {whatif.fmt_time(best.saved_s)}/step "
                              f"({best.speedup:.2f}x collective) — "
                              f"{best.scenario.description}")
                        r["whatif_best"] = best.scenario.name
                        r["whatif_saved_ms"] = round(best.saved_s * 1e3, 3)
                if args.html:
                    os.makedirs(args.html, exist_ok=True)
                    name = f"{arch}_{shape_name}_{r['mesh']}"
                    with open(os.path.join(args.html, name + ".html"), "w") as f:
                        f.write(to_html(tr, spec))
                    with open(os.path.join(args.html, name + ".json"), "w") as f:
                        f.write(to_json(tr))
                rows.append(r)
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        with open(args.out, "w") as f:
            json.dump(existing + rows, f, indent=1, default=str)
    return rows


if __name__ == "__main__":
    rows = run_cli()
    raise SystemExit(1 if any("failed" in r for r in rows) else 0)
