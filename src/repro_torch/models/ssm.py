"""Mamba-1 selective SSM block (falcon-mamba / hymba mamba heads).

The port of the reference's `repro.models.ssm`.  The reference runs the
recurrence as an XLA chunked `associative_scan` on the discretised inputs
a_bar = exp(delta·A) and bx = (delta·x)·B, two [B, S, di, N] fp32 tensors
(`_ssm_inputs`), and leaves its Pallas kernel to direct calls.  Here the
full-sequence path (`apply_ssm`) launches K2's fused entry point once per
call on the whole sequence (`kernels.ops.mamba_scan_fused`: the CUDA kernel
on the card, its plain version on the CPU), from delta, x, A, B and C
(`_ssm_params`): the kernel makes a_bar and bx in registers, so neither
[B, S, di, N] tensor exists; the final state for the decode cache comes
from the same launch.  Training passes `scan_impl="plain"` for a
differentiable scan in plain PyTorch on a_bar and bx, chunked as the
reference's (`scan_chunked`: an associative scan within chunks of 256
steps, the state carried from chunk to chunk, each chunk recomputed in
backward), not the kernel's sequential plain version, whose S Python steps
a step on a mesh would dispatch one by one.  With `cfg.ssm_inloop` the plain
path discretises inside each chunk instead, as the reference's in-loop scan
does (`scan_inloop`): autograd then keeps delta, x, B and C ([B, S, di] and
[B, S, N]) and the carried states, and no [B, S, di, N] tensor or gradient
outlives one chunk.  The kernel path is already that form, whatever the flag.

On a mesh (DTensor inputs) each scan runs per rank under `local_map`:
the fused kernel and the in-loop scan on delta, x and A sharded on the
channel dim `di` over `model` (`_params_local`), the plain scan on a_bar
and bx sharded so (`_scan_local`), as `in_proj` and the `ssm` cache shard
the channels; B and C are whole over `model`.  The recurrence
is independent per (b, d, n), so each rank's scan of its own channels is
exact and needs no collective.

Decode carries (conv_state [B, d_conv-1, d_inner] fp32, ssm_state
[B, d_inner, N] fp32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.autoshard import (constrain_or_whole, constrain_to, current_mesh,
                                               role_placements)
from repro_torch.kernels import ops as kops
from repro_torch.models.meta import ParamMeta
from repro_torch.scope import scope, span


def dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def ssm_meta(cfg):
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, dt_rank(cfg)
    return {
        "in_proj": ParamMeta((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamMeta((cfg.d_conv, di), (None, "inner"), scale=0.5),
        "conv_b": ParamMeta((di,), ("inner",), init="zeros"),
        "x_proj": ParamMeta((di, r + 2 * n), ("inner", None)),
        "dt_w": ParamMeta((r, di), (None, "inner")),
        "dt_bias": ParamMeta((di,), ("inner",), init="constant", scale=-4.6,
                             dtype="float32"),
        "a_log": ParamMeta((di, n), ("inner", None), init="a_log", dtype="float32"),
        "d_skip": ParamMeta((di,), ("inner",), init="ones", dtype="float32"),
        "out_proj": ParamMeta((di, d), ("inner", "embed")),
    }


def _ssm_params(cfg, p, xc):
    """The scan's inputs before discretisation. xc [B, S, di] (post-conv,
    post-silu).

    Returns (delta [B,S,di], A [di,N], B [B,S,N], C [B,S,N]), all fp32.
    """
    r, n = dt_rank(cfg), cfg.ssm_state
    proj = xc @ p["x_proj"].to(xc.dtype)
    if isinstance(proj, DTensor):
        # the row-parallel product's partial sum over `model` reduced here, as
        # GSPMD does: torch 2.11's DTensor cannot add a channel-split tensor to
        # what comes of a partial one
        proj = constrain_or_whole(proj, ("batch", None, None))
    dt_raw, b_ssm, c_ssm = proj.split([r, n, n], dim=-1)
    delta = F.softplus((dt_raw @ p["dt_w"].to(xc.dtype)).float()
                       + p["dt_bias"].float())                   # [B,S,di]
    a = -torch.exp(p["a_log"].float())                           # [di,N]
    return delta, a, b_ssm.float(), c_ssm.float()


def _discretise(delta, x, a, b):
    """a_bar = exp(delta * A) and bx = (delta * x) * B, [B,S,di,N] fp32, from
    delta and x [B,S,di] (x fp32), A [di,N] and B [B,S,N]."""
    a_bar = (delta[..., None] * a).exp_()
    bx = (delta * x)[..., None] * b[..., None, :]
    return a_bar, bx


def _ssm_inputs(cfg, p, xc):
    """Common pre-scan computation. xc [B, S, di] (post-conv, post-silu).

    Returns (a_bar, bx, c) in fp32 with
      a_bar [B,S,di,N] = exp(delta * A), bx [B,S,di,N], c [B,S,N].
    """
    delta, a, b, c = _ssm_params(cfg, p, xc)
    return (*_discretise(delta, xc.float(), a, b), c)


def _conv1d_causal(cfg, p, x, conv_state=None):
    """Depthwise causal conv over S. x [B,S,di] -> [B,S,di].

    conv_state [B, d_conv-1, di] prepends history (decode).
    """
    dc = cfg.d_conv
    if conv_state is None:
        pad = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    w = p["conv_w"].to(x.dtype)                                  # [dc, di]
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(dc))
    return out + p["conv_b"].to(x.dtype)


SCAN_CHUNK = 256          # the reference's `apply_ssm(chunk=256)`


def _combine(a1, b1, a2, b2):
    """The recurrence's associative combine, (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """even[:, 0], odd[:, 0], even[:, 1], ... along dim 1 (even as long as odd
    or one longer)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return out if even.shape[1] == n else torch.cat([out, even[:, n:]], dim=1)


def _assoc_scan(a, b):
    """The inclusive scan of `_combine` along dim 1, as `jax.lax.associative_scan`
    computes it (the reference's): adjacent pairs combined, their scan taken
    recursively, the even positions filled in from it.  O(C) work in log2(C)
    levels, against C log2(C) for doubling."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _assoc_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    k = odd_a.shape[1] - (n % 2 == 0)
    even_a, even_b = _combine(odd_a[:, :k], odd_b[:, :k], a[:, 2::2], b[:, 2::2])
    return (_interleave(torch.cat([a[:, :1], even_a], dim=1), odd_a),
            _interleave(torch.cat([b[:, :1], even_b], dim=1), odd_b))


def _chunk_scan(a, bx, c, h0):
    """One chunk, as the reference's `_chunk_scan`: the associative combine
    scanned along the chunk (`_assoc_scan`), the carried state h0 (None before
    the first chunk) applied, then the readout.  Returns (y, the chunk's last
    state, apart from the chunk's storage)."""
    a, bx = _assoc_scan(a, bx)
    h = bx if h0 is None else a * h0[:, None] + bx
    return torch.einsum("bsdn,bsn->bsd", h, c), h[:, -1].clone()


def _carried(chunk_fn, per_step, fixed, return_state, chunk):
    """`chunk_fn(*per_step chunks, *fixed, h)` over chunks of `chunk` steps
    (halved until it divides S), the state carried from chunk to chunk, each
    chunk under `torch.utils.checkpoint`; the chunks' y concatenated."""
    S = per_step[0].shape[1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    h, ys = None, []
    for s0 in range(0, S, chunk):
        part = slice(s0, s0 + chunk)
        y, h = checkpoint(chunk_fn, *(t[:, part] for t in per_step), *fixed, h,
                          use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return (y, h) if return_state else y


def scan_chunked(a_bar, bx, c, *, return_state=False, chunk=SCAN_CHUNK):
    """The scan of `kernels.ref.mamba_scan_ref` (same arguments and results,
    S >= 1), differentiable, chunked as the reference's `apply_ssm`: chunks of
    `chunk` steps (halved until it divides S), each an associative scan, the
    state carried between them.  Each chunk runs under
    `torch.utils.checkpoint`, so autograd keeps its inputs and carried state
    and backward recomputes its scan, one chunk at a time: about the memory
    of the sequential loop, not the scan's levels over the whole sequence."""
    return _carried(_chunk_scan, (a_bar, bx, c), (), return_state, chunk)


def _discretised_chunk(delta, x, b, c, a, h0):
    return _chunk_scan(*_discretise(delta, x, a, b), c, h0)


def scan_inloop(delta, x, a, b, c, *, return_state=False, chunk=SCAN_CHUNK):
    """`scan_chunked` of `_discretise(delta, x, a, b)` and c, each chunk's a_bar
    and bx made inside its checkpoint (the reference's `ssm_inloop`): autograd
    keeps delta, x [B,S,di], b, c [B,S,N], A and the carried states, and
    backward makes one chunk's [B, C, di, N] terms at a time.  The same
    function as the whole-sequence discretisation, element by element."""
    return _carried(_discretised_chunk, (delta, x, b, c), (a,), return_state, chunk)


def _scan_local(scan_fn, a_bar, bx, c, return_state):
    """`scan_fn` on each rank's shards of DTensor a_bar/bx (batch over the data
    axes, di over `model`) and c (batch alone): see the module's docstring.
    c's gradient is partial over the axes that split di (each rank reads c
    for its own channels only)."""
    mesh = current_mesh() or a_bar.device_mesh
    ab_pl = role_placements(a_bar.shape, ("batch", None, "model", None)) or \
        (Replicate(),) * mesh.ndim
    c_pl = tuple(pl if pl.is_shard(0) else Replicate() for pl in ab_pl)
    a_bar, bx, c = constrain_to(a_bar, ab_pl), constrain_to(bx, ab_pl), constrain_to(c, c_pl)
    y_pl = ab_pl                                   # [B, S, di]: dims 0 and 2 as a_bar's
    h_pl = tuple(type(pl)(1) if pl.is_shard(2) else pl for pl in ab_pl)   # [B, di, N]
    c_grad = tuple(Partial() if a.is_shard(2) else pl for a, pl in zip(ab_pl, c_pl))

    def core(al, bl, cl):
        return scan_fn(al, bl, cl, return_state=return_state)
    return local_map(core, out_placements=(list(y_pl), list(h_pl)) if return_state else list(y_pl),
                     in_placements=(ab_pl, ab_pl, c_pl),
                     in_grad_placements=(ab_pl, ab_pl, c_grad),
                     device_mesh=mesh)(a_bar, bx, c)


def _as_placed(t, placements):
    """DTensor t on `placements`: as it is where it has them already, so that
    its gradient leaves as autograd makes it, else through `constrain_to`."""
    return t if tuple(t.placements) == tuple(placements) else constrain_to(t, placements)


def _params_local(scan_fn, delta, x, a, b, c, return_state, grads=False):
    """`scan_fn(delta, x, a, b, c, return_state=...)` on each rank's shards of
    DTensor delta and x (batch over the data axes, di over `model`), A (di
    over `model`), and B and C (batch alone): see the module's docstring.
    With `grads`, the gradients' placements: A's and B's and C's are partial
    over the axes their forward placements leave whole but the scan splits
    (A's over the batch's, B's and C's over di's).  delta, x and C are
    constrained as `_scan_local` constrains a_bar, bx and c; A and B, which
    the whole-sequence path discretises outside its `local_map`, keep their
    placements, so their partial gradients are reduced where that path
    reduces them (A's with its parameter's gradient, B's with the x_proj
    product's): the in-loop step makes the same collectives."""
    mesh = current_mesh() or delta.device_mesh
    d_pl = role_placements(delta.shape, ("batch", None, "model")) or \
        (Replicate(),) * mesh.ndim
    a_pl = tuple(Shard(0) if pl.is_shard(2) else Replicate() for pl in d_pl)
    bc_pl = tuple(pl if pl.is_shard(0) else Replicate() for pl in d_pl)
    ins = [constrain_to(delta, d_pl), constrain_to(x, d_pl), _as_placed(a, a_pl),
           _as_placed(b, bc_pl), constrain_to(c, bc_pl)]
    h_pl = tuple(Shard(1) if pl.is_shard(2) else pl for pl in d_pl)   # [B, di, N]
    kw = {}
    if grads:
        a_grad = tuple(Partial() if d.is_shard(0) else a for d, a in zip(d_pl, a_pl))
        bc_grad = tuple(Partial() if d.is_shard(2) else pl for d, pl in zip(d_pl, bc_pl))
        kw["in_grad_placements"] = (d_pl, d_pl, a_grad, bc_grad, bc_grad)

    def core(dl, xl, al, bl, cl):
        return scan_fn(dl, xl, al, bl, cl, return_state=return_state)
    return local_map(core, out_placements=(list(d_pl), list(h_pl)) if return_state else list(d_pl),
                     in_placements=(d_pl, d_pl, a_pl, bc_pl, bc_pl), device_mesh=mesh,
                     **kw)(*ins)


def apply_ssm(cfg, p, x, *, return_state=False, scan_impl="kernel"):
    """Full-sequence selective SSM. x [B,S,D] -> [B,S,D].

    `scan_impl`: "kernel" runs K2's fused entry point
    (`kernels.ops.mamba_scan_fused`, forward only: it raises inside autograd);
    "plain" runs `scan_chunked` on a_bar and bx, differentiable, which
    training passes down, as the reference never trains through its kernel
    either; with `cfg.ssm_inloop`, `scan_inloop` on delta, x, A, B and C.
    The flag leaves "kernel" as it is: the fused kernel makes each step's
    a_bar and bx in registers, which is the in-loop form already.  With
    `return_state`, returns (out, {"conv", "ssm"}): the last d_conv-1 inputs
    of the conv in fp32 (zeros before the sequence's start) and the scan's
    final state, from the same scan as `out`.
    """
    if scan_impl not in ("kernel", "plain"):
        raise ValueError(f"scan_impl {scan_impl!r} not in kernel|plain")
    with scope("ssm"):
        dt = x.dtype
        with span("conv"):
            x_in, z = (x @ p["in_proj"].to(dt)).chunk(2, dim=-1)
            xc = F.silu(_conv1d_causal(cfg, p, x_in))
        if scan_impl == "kernel":
            with span("ssm_params"):
                delta, a, b, c = _ssm_params(cfg, p, xc)
            with span("scan"):
                if isinstance(delta, DTensor):
                    scan = _params_local(kops.mamba_scan_fused, delta, xc, a, b, c,
                                         return_state)
                else:
                    scan = kops.mamba_scan_fused(delta, xc, a, b, c, return_state=return_state)
        elif cfg.ssm_inloop:
            with span("ssm_params"):
                delta, a, b, c = _ssm_params(cfg, p, xc)
            with span("scan"):
                if isinstance(delta, DTensor):
                    scan = _params_local(scan_inloop, delta, xc.float(), a, b, c, return_state,
                                         grads=True)
                else:
                    scan = scan_inloop(delta, xc.float(), a, b, c, return_state=return_state)
        else:
            with span("ssm_params"):
                a_bar, bx, c = _ssm_inputs(cfg, p, xc)
            with span("scan"):
                if isinstance(a_bar, DTensor):
                    scan = _scan_local(scan_chunked, a_bar, bx, c, return_state)
                else:
                    scan = scan_chunked(a_bar, bx, c, return_state=return_state)
            del a_bar, bx                  # 2 x [B,S,di,N] fp32: free before the rest
        y, h_last = scan if return_state else (scan, None)
        with span("out_proj"):
            y = y + xc.float() * p["d_skip"].float()
            out = (y.to(dt) * F.silu(z)) @ p["out_proj"].to(dt)
    if not return_state:
        return out
    keep, S = cfg.d_conv - 1, x.shape[1]
    conv = x_in[:, max(0, S - keep):].float()
    if S < keep:        # (torch 2.11's DTensor cannot pad by nothing)
        conv = F.pad(conv, (0, 0, keep - S, 0))
    return out, {"conv": conv, "ssm": h_last}


def init_ssm_state(cfg, batch, *, device=None):
    di = cfg.d_inner
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
    }


def decode_ssm(cfg, p, x, state):
    """Single-token SSM step. x [B,1,D] -> ([B,1,D], new_state).

    `state` ({"conv", "ssm"}) is not modified; the caller writes the new state
    where it keeps it.
    """
    with scope("ssm_decode"):
        dt = x.dtype
        x_in, z = (x @ p["in_proj"].to(dt)).chunk(2, dim=-1)     # [B,1,di]
        xc = F.silu(_conv1d_causal(cfg, p, x_in, conv_state=state["conv"]))
        new_conv = torch.cat([state["conv"][:, 1:], x_in.to(state["conv"].dtype)], dim=1)
        a_bar, bx, c = _ssm_inputs(cfg, p, xc)                   # [B,1,di,N]
        h = a_bar[:, 0] * state["ssm"] + bx[:, 0]                # [B,di,N]
        y = torch.einsum("bdn,bn->bd", h, c[:, 0])[:, None, :]   # [B,1,di]
        y = y + xc.float() * p["d_skip"].float()
        out = (y.to(dt) * F.silu(z)) @ p["out_proj"].to(dt)
        return out, {"conv": new_conv, "ssm": h}
