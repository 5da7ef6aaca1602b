"""Synthetic trace generation — controlled workloads for sessions/benches
(a copy of the reference's `core/synth.py` priced on the H100 model).  The
reference's HLO-text generators (`synthetic_hlo`, `corrupt_hlo`, the
`write_*_dump` writers) become generators of the port's capture dumps
(`core.dump`): the port captures traces, it parses no HLO.

The paper's comparison experiments need *many* traces from *different*
configurations.  On hardwareless CI we synthesize them: random-but-seeded
collective mixes laid out on a real `MeshSpec`, run through the real cost
model and attribution pipeline, so every derived field (link class, wire
bytes, protocol regime, semantic class) is produced by the same code paths
a captured trace exercises.  Sites, kinds, groups, bytes and multiplicities
for a seed are the reference's; link names and prices are the H100's.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import attribution, costmodel
from repro_torch.core.events import CollectiveEvent, Trace
from repro_torch.core.topology import H100, Hardware, MeshSpec

# (kind, scope path, relative weight) — a train-step-shaped mix
_SITE_MIX: Tuple[Tuple[str, str, float], ...] = (
    ("all-reduce", "layer/mlp", 3.0),
    ("all-reduce", "opt_update", 2.0),
    ("all-gather", "layer/attn", 2.0),
    ("reduce-scatter", "opt_update", 1.5),
    ("all-to-all", "layer/moe/dispatch", 1.0),
    ("all-gather", "embed", 0.5),
    ("all-reduce", "loss", 0.5),
)

_BYTE_CHOICES = np.array([1 << 10, 1 << 14, 1 << 18, 1 << 21,
                          1 << 24, 1 << 26], dtype=np.int64)
_MULT_CHOICES = np.array([1, 1, 1, 4, 12], dtype=np.int64)


def _axis_groups(mesh: MeshSpec, axis_idx: int):
    """All replica groups spanning exactly mesh axis `axis_idx`."""
    ids = np.arange(mesh.num_devices).reshape(mesh.shape)
    ids = np.moveaxis(ids, axis_idx, -1).reshape(-1, mesh.shape[axis_idx])
    return [list(map(int, row)) for row in ids]


def synthetic_trace(label: str, mesh: MeshSpec, hw: Hardware = H100,
                    n_sites: int = 1000, seed: int = 0,
                    backward_fraction: float = 0.4,
                    axis_weights: Optional[Sequence[float]] = None) -> Trace:
    """Build an annotated `Trace` of `n_sites` synthetic collective sites.

    `axis_weights` biases which mesh axis each collective spans (defaults
    to uniform) — e.g. weight the `data` axis to mimic a DP-heavy run.
    """
    rng = np.random.default_rng(seed)
    kinds = np.array([m[0] for m in _SITE_MIX])
    scopes = np.array([m[1] for m in _SITE_MIX])
    weights = np.array([m[2] for m in _SITE_MIX])
    mix = rng.choice(len(_SITE_MIX), size=n_sites, p=weights / weights.sum())
    axes_p = None
    if axis_weights is not None:
        axes_p = np.asarray(axis_weights, dtype=float)
        axes_p = axes_p / axes_p.sum()
    axis_pick = rng.choice(len(mesh.axes), size=n_sites, p=axes_p)
    nbytes = rng.choice(_BYTE_CHOICES, size=n_sites)
    mults = rng.choice(_MULT_CHOICES, size=n_sites)
    backward = rng.random(n_sites) < backward_fraction

    groups_by_axis = [_axis_groups(mesh, i) for i in range(len(mesh.shape))]
    events = []
    for i in range(n_sites):
        kind, scope = kinds[mix[i]], scopes[mix[i]]
        groups = groups_by_axis[axis_pick[i]]
        wrap = "transpose(core_fn)/" if backward[i] else ""
        op_name = f"jit(train_step)/{wrap}{scope}/{_PRIM_FOR.get(kind, 'psum')}"
        events.append(CollectiveEvent(
            name=f"{kind}.{i}",
            kind=kind,
            async_start=bool(rng.random() < 0.25),
            operand_bytes=int(nbytes[i]),
            result_bytes=int(nbytes[i]),
            dtype="bf16",
            replica_groups=groups,
            group_size=len(groups[0]),
            num_groups=len(groups),
            op_name=op_name,
            computation="main" if not backward[i] else "scan_body",
            multiplicity=int(mults[i]),
            channel_id=i + 1))
    for ev in events:
        costmodel.annotate_event(ev, mesh, hw)
    attribution.attribute_all(events)
    return Trace(label=label, mesh_shape=mesh.shape, mesh_axes=mesh.axes,
                 num_devices=mesh.num_devices, events=events)


_PRIM_FOR = {
    "all-reduce": "psum",
    "all-gather": "all_gather",
    "reduce-scatter": "psum_scatter",
    "all-to-all": "all_to_all",
    "collective-permute": "ppermute",
}


# --------------------------------------------------------------------------
# ground-truth buggy traces — precision/recall workloads for commcheck
# --------------------------------------------------------------------------

# bug name -> the commcheck finding code it must produce
COMM_BUGS = {
    "deadlock_order": "deadlock_order",
    "group_coverage": "group_coverage",
    "channel_collision": "channel_collision",
    "shape_mismatch": "shape_mismatch",
    "degenerate_group": "degenerate_group",
    "sharding_mismatch": "group_mesh_mismatch",
}


def inject_comm_bugs(mesh: Optional[MeshSpec] = None, hw: Hardware = H100,
                     n_sites: int = 64, seed: int = 0,
                     bugs: Sequence[str] = tuple(COMM_BUGS)):
    """A clean synthetic trace with labeled communication bugs spliced in.

    Returns `(trace, labels)` where `labels` maps each injected bug name
    to the commcheck finding code it must trigger (see `COMM_BUGS`).  The
    clean background sites come from `synthetic_trace` (unique channels,
    full-coverage axis groups), so every finding the analyzer reports is
    attributable to an injection — the ground truth for precision tests.
    """
    if mesh is None:
        mesh = MeshSpec((2, 4), ("data", "model"))
    nd = mesh.num_devices
    devs = list(range(nd))
    base = synthetic_trace("buggy", mesh, hw, n_sites=n_sites, seed=seed)
    events = list(base.events)
    ch = n_sites + 1000     # channel space disjoint from the clean sites

    def mk(name, kind, groups, channel, nbytes=1 << 22, dtype="f32"):
        return CollectiveEvent(
            name=name, kind=kind, async_start=False,
            operand_bytes=nbytes, result_bytes=nbytes, dtype=dtype,
            replica_groups=groups, group_size=len(groups[0]),
            num_groups=len(groups),
            op_name=f"jit(train_step)/bug/{name}/{_PRIM_FOR.get(kind, 'psum')}",
            computation="main", channel_id=channel)

    injected = []
    if "deadlock_order" in bugs:
        # two matched all-reduces: half the devices see an extra instance
        injected += [
            mk("bug.deadlock.a", "all-reduce", [devs[:nd // 2]], ch),
            mk("bug.deadlock.b", "all-reduce", [devs], ch),
        ]
    if "group_coverage" in bugs:
        injected.append(
            mk("bug.coverage", "all-reduce", [devs[:nd // 2]], ch + 1,
               nbytes=1 << 21))
    if "channel_collision" in bugs:
        injected += [
            mk("bug.collide.ar", "all-reduce", [devs], ch + 2,
               nbytes=1 << 20),
            mk("bug.collide.ag", "all-gather", [devs], ch + 2,
               nbytes=1 << 20),
        ]
    if "shape_mismatch" in bugs:
        injected += [
            mk("bug.shape.a", "all-reduce", [devs], ch + 3, nbytes=1 << 19),
            mk("bug.shape.b", "all-reduce", [devs], ch + 3, nbytes=1 << 18),
        ]
    if "sharding_mismatch" in bugs:
        # ragged groups: the spec carved the mesh into uneven pieces
        injected.append(
            mk("bug.ragged", "all-reduce", [devs[:3], devs[3:]], ch + 4,
               nbytes=1 << 17))
    if "degenerate_group" in bugs:
        injected.append(
            mk("bug.degenerate", "all-reduce", [[d] for d in devs], ch + 5,
               nbytes=1 << 16))

    for ev in injected:
        costmodel.annotate_event(ev, mesh, hw)
    events += injected
    attribution.attribute_all(events)
    trace = Trace(label="buggy", mesh_shape=mesh.shape, mesh_axes=mesh.axes,
                  num_devices=nd, events=events)
    return trace, {b: COMM_BUGS[b] for b in bugs}


def misconfigured_trace(n_sites: int = 400, seed: int = 3
                        ) -> Tuple[Trace, MeshSpec, str]:
    """A workload whose mesh factorization is the (planted) bug.

    Every collective spans the first axis of a `(2, 8) ("pod", "data")`
    mesh — bulk grad-sync traffic riding InfiniBand between two 8-GPU
    nodes (`pod` rides IB; `data`, one node's 8 GPUs, NVLink).  The same
    device groups stay inside one NVLink axis under the transposed
    factorization `(8, 2) ("data", "pod")` (device ids 0 and 8 are pod
    neighbors under the first mapping but data neighbors under the
    second), so the fix is purely a mesh reshape: no payload changes.

    Returns `(trace, mesh, fix)` where `fix` is the scenario name
    `whatif.default_scenarios(mesh)` gives that reshape — a sweep must
    rank it first (the ground truth for tests and the docs example).
    """
    mesh = MeshSpec((2, 8), ("pod", "data"))
    trace = synthetic_trace("misconfigured", mesh, n_sites=n_sites,
                            seed=seed, axis_weights=(1.0, 0.0))
    return trace, mesh, "mesh:data,pod"


# --------------------------------------------------------------------------
# capture dumps — the inputs of batch ingest and the watch daemon
# --------------------------------------------------------------------------

DUMP_MESH = MeshSpec((2, 4), ("data", "model"))


def synthetic_capture(n_sites: int = 1000, seed: int = 0,
                      mesh: MeshSpec = DUMP_MESH, hw: Hardware = H100,
                      label: str = "synthetic") -> str:
    """The capture-dump text (`core.dump`) of `synthetic_trace(label, mesh,
    hw, n_sites=n_sites, seed=seed)`: what a rank running that workload
    would write, the counterpart of the reference's `synthetic_hlo`."""
    from repro_torch.core.dump import capture_text
    return capture_text(synthetic_trace(label, mesh, hw, n_sites=n_sites, seed=seed),
                        mesh)


# every injector `corrupt_capture` supports (the reference's six); the chaos
# tests iterate this matrix, so a new failure mode added here is exercised
# everywhere automatically
CORRUPT_MODES = ("truncate", "splice", "dup_lines", "drop_lines",
                 "mangle_rg", "binary")

_GARBAGE = ("@@@ CORRUPT <<<%%%>>> \x01\x02 not-a-capture-line ((((\n"
            '{"format": "TRUNCATED HEADER\n')


def corrupt_capture(text: str, mode: str, seed: int = 0,
                    at: Optional[int] = None) -> Union[str, bytes]:
    """Damage a capture dump the way fleet ingest sees damage (the
    reference's `corrupt_hlo`, on the port's dump).

    Modes (see `CORRUPT_MODES`):
      * `truncate`   — cut the text at character `at` (default: a seeded
        offset), the half-written dump;
      * `splice`     — insert a block of garbage lines at `at` (default:
        seeded), the interleaved-writer / corrupted-block case;
      * `dup_lines`  — duplicate a random ~10% of lines (a retrying writer);
      * `drop_lines` — delete a random ~10% of lines (lost writes);
      * `mangle_rg`  — corrupt the first row's `replica_groups` (a device id
        that is not a number) so the row is refused on its content while
        its line stays JSON;
      * `binary`     — splice invalid UTF-8 bytes and return `bytes` (even
        salvage cannot decode it: the input is quarantined).

    Returns the damaged dump as `str` (`bytes` for `binary`), deterministic
    in `(text, mode, seed, at)`.
    """
    rng = np.random.default_rng(seed)
    if mode == "truncate":
        k = int(at) if at is not None \
            else int(rng.integers(1, max(len(text), 2)))
        return text[:k]
    if mode == "splice":
        k = int(at) if at is not None \
            else int(rng.integers(0, max(len(text), 1)))
        return text[:k] + _GARBAGE + text[k:]
    if mode in ("dup_lines", "drop_lines"):
        lines = text.splitlines(keepends=True)
        pick = rng.random(len(lines)) < 0.1
        out = []
        for keep, line in zip(pick, lines):
            if mode == "dup_lines":
                out.append(line)
                if keep:
                    out.append(line)
            elif not keep:
                out.append(line)
        return "".join(out)
    if mode == "mangle_rg":
        m = re.search(r'"replica_groups":\[\[(\d+)', text)
        if m is None:
            raise ValueError("capture has no row with replica_groups to mangle")
        return text[:m.start(1)] + '"' + m.group(1) + 'x"' + text[m.end(1):]
    if mode == "binary":
        k = int(at) if at is not None \
            else int(rng.integers(0, max(len(text), 1)))
        return text[:k].encode() + b"\xff\xfe\x00\xc3\x28garbage\xff" \
            + text[k:].encode()
    raise ValueError(f"unknown corruption mode {mode!r} "
                     f"(have {CORRUPT_MODES})")


def _write(path: str, data: Union[str, bytes]) -> str:
    from repro_torch.core.persist import atomic_open
    with atomic_open(path, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    return path


def write_corrupt_dump(root: str, modes: Sequence[str] = CORRUPT_MODES,
                       sites_per_file: int = 120, seed: int = 0,
                       prefix: str = "corrupt") -> List[str]:
    """One damaged capture per injector mode under `root`: a
    `synthetic_capture` (seed `seed + i`) through `corrupt_capture`, named
    `{prefix}_{mode}.jsonl`, each landed atomically.  Returns the paths."""
    os.makedirs(root, exist_ok=True)
    return [_write(os.path.join(root, f"{prefix}_{mode}.jsonl"),
                   corrupt_capture(synthetic_capture(sites_per_file, seed=seed + i),
                                   mode, seed=seed + i))
            for i, mode in enumerate(modes)]


def write_capture_dump(root: str, n_files: int = 3, sites_per_file: int = 200,
                       seed: int = 0, prefix: str = "module",
                       start: int = 0) -> List[str]:
    """A dump directory of `n_files` synthetic captures (seeds `seed+start
    ..`) named `{prefix}_{i:04d}.jsonl`, the input the watch daemon tails.
    `start` offsets the numbering and the seed, so a second call extends the
    directory with new captures (the grows-mid-run case).  Each file lands
    atomically.  Returns the paths in order."""
    os.makedirs(root, exist_ok=True)
    return [_write(os.path.join(root, f"{prefix}_{i:04d}.jsonl"),
                   synthetic_capture(sites_per_file, seed=seed + i))
            for i in range(start, start + n_files)]


def write_fleet_dump(root: str, n_hosts: int = 4, steps: int = 1,
                     sites_per_file: int = 120, seed: int = 0) -> List[str]:
    """A fleet-shaped dump: one synthetic capture per host x step, named
    `host{h:03d}_step{s:03d}.jsonl` (the naming `session.label_meta`
    reads), seed `seed + h * steps + s`, each landed atomically.  Returns the
    paths, hosts outer, steps inner."""
    from repro_torch.core.dump import capture_path
    os.makedirs(root, exist_ok=True)
    return [_write(capture_path(root, h, s),
                   synthetic_capture(sites_per_file, seed=seed + h * steps + s))
            for h in range(n_hosts) for s in range(steps)]
