"""Mamba-1 selective scan: build, ctypes binding and wrappers.

The kernels are `csrc/mamba_scan.cu` (CUDA C++ for sm_90a), the port's
replacement for the reference's Pallas kernel `repro/kernels/mamba_scan.py`.
It is compiled with `nvcc` at first use into `build/repro_torch/` of the
checkout the package runs from and loaded with ctypes (`build.py`).  Two
entry points:

* `mamba_scan(a_bar, bx, c)`: the Pallas kernel's function, on the
  discretised inputs [B, S, Di, N] (custom op `repro_torch::mamba_scan`);
* `mamba_scan_fused(dt, x, a, b, c, delta_bias, d_skip, z)`: the same
  scan with the discretisation (`delta = softplus(dt + delta_bias)`,
  `a_bar = exp(delta·A)`, `bx = (delta·x)·B`) made in registers, from
  [B, S, Di] and [B, S, N] inputs, so that neither [B, S, Di, N] tensor
  exists, and the gated output (y + D·x)·silu(z) written where y is: the
  Mamba mixer's elementwise work on either side of the scan, as the
  upstream selective-scan kernel's `delta_bias`, `D` and `z` arguments do
  it (custom op `repro_torch::mamba_scan_fused`).  It scans time in chunks
  where one pass would not fill the card (`scan_chunks`).  The model's
  prefill runs it.

Each wrapper takes a CPU tensor to its plain version (`ref.py`) and a CUDA
tensor to its kernel; it never falls back from one to the other.  They are
forward only, and raise when autograd would record them (grad mode on and an
input that requires grad) rather than return an output without a gradient.

Training has its own entry point and source, `csrc/mamba_scan_train.cu`
(built apart, so the prefill runs the same binary whatever training needs):

* `mamba_scan_train(delta, x, a, b, c)`: `mamba_scan_fused`'s scan on delta
  after its softplus, y before the gate (fp32), differentiable (custom op `repro_torch::mamba_scan_train`, its autograd
  registered).  The forward kernel also writes the state at the start of
  every chunk of `train_chunk(N)` steps, [B, S/chunk, Di, N] fp32, which
  with its inputs is all it keeps for backward; the backward op
  (`repro_torch::mamba_scan_train_bwd`) recomputes each chunk's states
  from there and walks it in reverse.  A CPU tensor takes the plain
  training scan (`ref.scan_inloop`, whose values and gradients it gives
  bit for bit); `ref.mamba_scan_train_bwd_ref` is the backward's plain
  model.

Each custom op's CUDA implementation is the launch, and its fake
implementation gives its outputs' shapes, so that a step on fake tensors
(`FakeTensorMode`, the dry-run's, on any device) runs through it with no
launch counted; the fused entry point launches directly on a plain CUDA
tensor with no dispatch mode on (`build.eager`), past the op's dispatcher.
The FLOPs of each are counted as `torch.utils.flop_counter`
counts its plain version (the readout's products, 2·B·S·Di·N, and their
gradients, 4·B·S·Di·N; the recurrence and the discretisation are
elementwise).  `launches` counts the calls that launched any kernel,
`kernel_launches` each entry point's ("unfused", "fused", "train_fwd",
"train_bwd"), `chunks` the chunks of time over the fused entry point's
calls (one a call that takes one pass: more chunks than calls is the
chunked-time branch); `ops.launch_counts` reads them.
"""
from __future__ import annotations

import ctypes
import functools
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import (mamba_scan_fused_ref, mamba_scan_ref, scan_inloop,
                                     train_chunk)

SOURCE = _build.PACKAGE / "csrc" / "mamba_scan.cu"
TRAIN_SOURCE = _build.PACKAGE / "csrc" / "mamba_scan_train.cu"
MAX_STATE = 32
# the fused kernel's channels a block (csrc/mamba_scan.cu's FT), and the fewest timesteps
# a chunk of time takes
CHANNELS_PER_BLOCK, MIN_CHUNK = 128, 128

launches = 0   # kernel launches; a run zeroes it to count one path's launches
# the same launches, by entry point
kernel_launches = {"unfused": 0, "fused": 0, "train_fwd": 0, "train_bwd": 0}
chunks = 0     # chunks of time over the fused entry point's launches


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.repro_mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.repro_mamba_scan_fused_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def scan_chunks(B, S, Di, N, sm_count) -> int:
    """How many chunks of time the fused kernel scans in parallel.  One pass
    has B·ceil(Di/128) blocks of one thread per channel; where that leaves
    fewer than 1.5 blocks an SM, time is split until there are ~4.5 (of the
    6 an SM holds at the kernel's 36 KB of shared memory), each chunk at
    least MIN_CHUNK steps.  The constants are fitted to an H100 at the three
    path shapes: falcon-mamba-7b's (4, 1024, 8192, 16) ran fastest unsplit
    (1.94 blocks an SM), hymba-1.5b's (4, 2048, 3200, 16) at 6 chunks and
    its rank shard (2, 2048, 800, 16) at 16-24 (N does not enter: the
    states live in each thread's registers)."""
    blocks = B * -(-Di // CHANNELS_PER_BLOCK)
    if blocks >= 1.5 * sm_count or S < 2 * MIN_CHUNK:
        return 1
    return max(1, min(-(-int(4.5 * sm_count) // blocks), S // MIN_CHUNK))


def _check(a_bar, bx, c):
    if not (a_bar.device == bx.device == c.device):
        raise ValueError(f"a_bar, bx, c on different devices: "
                         f"{a_bar.device}, {bx.device}, {c.device}")
    if not (a_bar.dtype == bx.dtype == c.dtype == torch.float32):
        raise TypeError(f"kernel takes float32 a_bar/bx/c, got "
                        f"{a_bar.dtype}, {bx.dtype}, {c.dtype}")
    if a_bar.ndim != 4 or bx.shape != a_bar.shape or c.shape != (*a_bar.shape[:2],
                                                                  a_bar.shape[3]):
        raise ValueError(f"bad shapes a_bar {tuple(a_bar.shape)}, bx {tuple(bx.shape)}, "
                         f"c {tuple(c.shape)}")
    if not 1 <= a_bar.shape[3] <= MAX_STATE:
        raise ValueError(f"state size N={a_bar.shape[3]} not in 1..{MAX_STATE}")


def mamba_scan(a_bar, bx, c, *, return_state=False):
    """a_bar/bx [B,S,Di,N], c [B,S,N] fp32 -> y [B,S,Di] fp32 (and h_S [B,Di,N]).

    h_t = a_t * h_{t-1} + bx_t from h_0 = 0;  y_t[d] = sum_n h_t[d,n] * c_t[n].
    Non-contiguous inputs are copied to contiguous ones first.
    """
    _check(a_bar, bx, c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a_bar, bx, c)):
        raise RuntimeError("mamba_scan has no backward: its output would carry no gradient; "
                           "train through the training entry point, mamba_scan_train")
    if a_bar.device.type == "cpu" and not isinstance(a_bar, FakeTensor):
        return mamba_scan_ref(a_bar, bx, c, return_state=return_state)
    if a_bar.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mamba_scan runs on cpu or cuda, not {a_bar.device}")
    y, h = torch.ops.repro_torch.mamba_scan(a_bar, bx, c, bool(return_state))
    return (y, h) if return_state else y


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=(), device_types="cuda")
def _mamba_scan(a_bar: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                return_state: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The launch on the current stream.  Returns (y, h_S), h_S empty [0] when
    `return_state` is False (the kernel then writes no state)."""
    global launches
    B, S, Di, N = a_bar.shape
    a_bar, bx, c = a_bar.contiguous(), bx.contiguous(), c.contiguous()
    y = torch.empty((B, S, Di), dtype=torch.float32, device=a_bar.device)
    h = torch.empty((B, Di, N) if return_state else (0,), dtype=torch.float32,
                    device=a_bar.device)
    if B == 0 or Di == 0:
        return y, h
    with torch.cuda.device(a_bar.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_mamba_scan_fwd(
            a_bar.data_ptr(), bx.data_ptr(), c.data_ptr(), y.data_ptr(),
            h.data_ptr() if return_state else None, B, S, Di, N, stream)
    if err != 0:
        raise RuntimeError(f"mamba scan kernel launch failed: cudaError {err}")
    launches += 1
    kernel_launches["unfused"] += 1
    return y, h


@_mamba_scan.register_fake
def _(a_bar, bx, c, return_state):
    B, S, Di, N = a_bar.shape
    return (a_bar.new_empty((B, S, Di)),
            a_bar.new_empty((B, Di, N) if return_state else (0,)))


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _flops(a_shape, *_args, **_kwargs) -> int:
    B, S, Di, N = a_shape
    return 2 * B * S * Di * N


def _check_scan(delta, x, a, b, c, delta_dtype=torch.float32):
    """Raise on what the kernels do not take: delta in `delta_dtype`."""
    ts = (delta, x, a, b, c)
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"delta, x, a, b, c on different devices: {[t.device for t in ts]}")
    if not all(t.dtype == torch.float32 for t in (a, b, c)) or delta.dtype != delta_dtype or \
            x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes {delta_dtype} delta, float32 a/b/c and float32 or "
                        f"bfloat16 x, got {[t.dtype for t in ts]}")
    if delta.ndim != 3 or x.shape != delta.shape or a.ndim != 2 or a.shape[0] != delta.shape[2] \
            or b.shape != (*delta.shape[:2], a.shape[1]) or c.shape != b.shape:
        raise ValueError(f"bad shapes delta {tuple(delta.shape)}, x {tuple(x.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    if not 1 <= a.shape[1] <= MAX_STATE:
        raise ValueError(f"state size N={a.shape[1]} not in 1..{MAX_STATE}")


def _check_fused(dt, x, a, b, c, delta_bias, d_skip, z):
    """`_check_scan` with dt in x's dtype, and the gate's arguments."""
    _check_scan(dt, x, a, b, c, delta_dtype=x.dtype)
    if {delta_bias.device, d_skip.device, z.device} != {dt.device}:
        raise ValueError("delta_bias, d_skip and z not on dt's device")
    if delta_bias.dtype != torch.float32 or d_skip.dtype != torch.float32 or z.dtype != x.dtype:
        raise TypeError(f"kernel takes float32 delta_bias/d_skip and z in x's dtype, got "
                        f"{delta_bias.dtype}, {d_skip.dtype}, {z.dtype}")
    if delta_bias.shape != (dt.shape[2],) or d_skip.shape != delta_bias.shape or \
            z.shape != dt.shape:
        raise ValueError(f"bad shapes delta_bias {tuple(delta_bias.shape)}, d_skip "
                         f"{tuple(d_skip.shape)}, z {tuple(z.shape)} for dt {tuple(dt.shape)}")


def mamba_scan_fused(dt, x, a, b, c, delta_bias, d_skip, z, *, return_state=False):
    """dt/x/z [B,S,Di], a [Di,N], b/c [B,S,N], delta_bias/d_skip [Di] -> y
    [B,S,Di] in x's dtype (and h_S [B,Di,N] fp32).

    delta = softplus(dt + delta_bias), a_bar = exp(delta·a), bx =
    (delta·x)·b, h_t = a_bar_t·h_{t-1} + bx_t from h_0 = 0, s_t[d] =
    sum_n h_t[d,n]·c_t[n], y = (s + x·d_skip)·silu(z): the Mamba mixer from
    its raw dt projection to its gated output, in fp32, rounded where the
    mixer's ops round (s + x·d_skip and silu(z) to x's dtype, then their
    product).  dt, x and z are fp32 or bf16 alike (widened in registers);
    everything else is fp32.  z is read in place where its last dim is
    contiguous (the gate half of `in_proj`'s output); other non-contiguous
    inputs are copied to contiguous ones first.
    """
    _check_fused(dt, x, a, b, c, delta_bias, d_skip, z)
    ts = (dt, x, a, b, c, delta_bias, d_skip, z)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("mamba_scan_fused has no backward: its output would carry no "
                           "gradient; train through the training entry point, "
                           "mamba_scan_train")
    if dt.device.type == "cpu" and not isinstance(dt, FakeTensor):
        return mamba_scan_fused_ref(*ts, return_state=return_state)
    if dt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mamba_scan_fused runs on cpu or cuda, not {dt.device}")
    y, h = _launch_fused(*ts, bool(return_state)) if _build.eager(dt) else \
        torch.ops.repro_torch.mamba_scan_fused(*ts, bool(return_state))
    return (y, h) if return_state else y


def _launch_fused(dt, x, a, b, c, delta_bias, d_skip, z, return_state):
    """The launch(es) on the current stream: one pass, or two where time is
    chunked (`scan_chunks`).  Returns (y, h_S), h_S empty [0] when
    `return_state` is False."""
    global launches, chunks
    B, S, Di = dt.shape
    N = a.shape[1]
    dt, x, a, b, c, delta_bias, d_skip = (t.contiguous()
                                          for t in (dt, x, a, b, c, delta_bias, d_skip))
    if z.stride(2) != 1:
        z = z.contiguous()
    dev = dt.device
    y = torch.empty((B, S, Di), dtype=x.dtype, device=dev)
    h = torch.empty((B, Di, N) if return_state else (0,), dtype=torch.float32, device=dev)
    if B == 0 or Di == 0:
        return y, h
    parts = scan_chunks(B, S, Di, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    chunk = max(1, -(-S // parts))
    parts = max(1, -(-S // chunk))
    scratch = (torch.empty((2, parts - 1, B, Di, N), dtype=torch.float32, device=dev)
               if parts > 1 else None)
    with torch.cuda.device(dev):
        err = _lib().repro_mamba_scan_fused_fwd(
            dt.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(), h.data_ptr() if return_state else None,
            scratch.data_ptr() if scratch is not None else None, delta_bias.data_ptr(),
            d_skip.data_ptr(), z.data_ptr(), z.stride(0), z.stride(1), B, S, Di, N, chunk,
            _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"fused mamba scan kernel launch failed: cudaError {err}")
    launches += 1
    chunks += parts
    kernel_launches["fused"] += 1
    return y, h


@torch.library.custom_op("repro_torch::mamba_scan_fused", mutates_args=(), device_types="cuda")
def _mamba_scan_fused(dt: torch.Tensor, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, delta_bias: torch.Tensor, d_skip: torch.Tensor,
                      z: torch.Tensor, return_state: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return _launch_fused(dt, x, a, b, c, delta_bias, d_skip, z, return_state)


@_mamba_scan_fused.register_fake
def _(dt, x, a, b, c, delta_bias, d_skip, z, return_state):
    B, S, Di = dt.shape
    return (dt.new_empty((B, S, Di), dtype=x.dtype),
            dt.new_empty((B, Di, a.shape[1]) if return_state else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.mamba_scan_fused)
def _fused_flops(dt_shape, x_shape, a_shape, *_args, **_kwargs) -> int:
    B, S, Di = dt_shape
    return 2 * B * S * Di * a_shape[1]


@functools.cache
def _train_lib() -> ctypes.CDLL:
    lib = _build.load(TRAIN_SOURCE)
    fn = lib.repro_mamba_scan_train_chunk
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    bad = [n for n in range(1, MAX_STATE + 1) if fn(n) != train_chunk(n)]
    if bad:
        raise RuntimeError(f"{TRAIN_SOURCE.name}'s chunk differs from train_chunk at N={bad}")
    fn = lib.repro_mamba_scan_train_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.repro_mamba_scan_train_bwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 14
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def mamba_scan_train(delta, x, a, b, c, *, return_state=False):
    """`mamba_scan_fused`'s scan, on delta after its softplus and without the
    gate (y fp32), differentiable: the training entry point.  On the card the
    custom op `repro_torch::mamba_scan_train` (its backward a kernel too); on
    CPU tensors the plain training scan, `ref.scan_inloop` on x widened to
    fp32, whose values and gradients it is."""
    _check_scan(delta, x, a, b, c)
    if delta.device.type == "cpu" and not isinstance(delta, FakeTensor):
        return scan_inloop(delta, x.float(), a, b, c, return_state=return_state)
    if delta.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mamba_scan_train runs on cpu or cuda, not {delta.device}")
    y, h, _ = torch.ops.repro_torch.mamba_scan_train(delta, x, a, b, c, bool(return_state))
    return (y, h) if return_state else y


def _states_shape(delta, a):
    B, S, Di = delta.shape
    N = a.shape[1]
    return (B, -(-S // train_chunk(N)), Di, N)


@torch.library.custom_op("repro_torch::mamba_scan_train", mutates_args=(), device_types="cuda")
def _mamba_scan_train(delta: torch.Tensor, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, return_state: bool
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward launch on the current stream.  Returns (y, h_S, states):
    h_S empty [0] when `return_state` is False, states the state at the
    start of every chunk of `train_chunk(N)` steps, [B, S/chunk, Di, N]."""
    global launches
    B, S, Di = delta.shape
    N = a.shape[1]
    delta, x, a, b, c = (t.contiguous() for t in (delta, x, a, b, c))
    dev = delta.device
    y = torch.empty((B, S, Di), dtype=torch.float32, device=dev)
    h = torch.zeros((B, Di, N) if return_state else (0,), dtype=torch.float32, device=dev)
    states = torch.empty(_states_shape(delta, a), dtype=torch.float32, device=dev)
    if B == 0 or S == 0 or Di == 0:
        return y, h, states
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _train_lib().repro_mamba_scan_train_fwd(
            delta.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(), h.data_ptr() if return_state else None,
            states.data_ptr(), B, S, Di, N, stream)
    if err != 0:
        raise RuntimeError(f"mamba scan training forward launch failed: cudaError {err}")
    launches += 1
    kernel_launches["train_fwd"] += 1
    return y, h, states


@_mamba_scan_train.register_fake
def _(delta, x, a, b, c, return_state):
    B, S, Di = delta.shape
    return (delta.new_empty((B, S, Di)),
            delta.new_empty((B, Di, a.shape[1]) if return_state else (0,)),
            delta.new_empty(_states_shape(delta, a)))


@torch.library.custom_op("repro_torch::mamba_scan_train_bwd", mutates_args=(),
                         device_types="cuda")
def _mamba_scan_train_bwd(delta: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor, states: torch.Tensor,
                          dy: torch.Tensor, dh: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The backward launches on the current stream: the kernel, then the fixed-
    order sum of its partials.  `dh` is h_S's gradient, or empty [0] where
    h_S has none.  Returns (ddelta, dx in x's dtype, dA, dB, dC)."""
    global launches
    B, S, Di = delta.shape
    N = a.shape[1]
    delta, x, a, b, c, states, dy = (t.contiguous() for t in (delta, x, a, b, c, states, dy))
    dh = dh.contiguous() if dh.numel() else None
    dev = delta.device
    if B == 0 or S == 0 or Di == 0:
        return (torch.zeros_like(delta), torch.zeros_like(x), torch.zeros_like(a),
                torch.zeros_like(b), torch.zeros_like(c))
    ddelta = torch.empty_like(delta)
    dx = torch.empty_like(x)
    da, db, dc = torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
    da_part = torch.empty((B, Di, N), dtype=torch.float32, device=dev)
    blocks = -(-Di // 32)          # the backward kernel's channels a block
    dbc_part = torch.empty((2, blocks, B, S, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _train_lib().repro_mamba_scan_train_bwd(
            delta.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), states.data_ptr(), dy.data_ptr(),
            dh.data_ptr() if dh is not None else None, ddelta.data_ptr(), dx.data_ptr(),
            da.data_ptr(), db.data_ptr(), dc.data_ptr(), da_part.data_ptr(),
            dbc_part[0].data_ptr(), dbc_part[1].data_ptr(), B, S, Di, N, stream)
    if err != 0:
        raise RuntimeError(f"mamba scan training backward launch failed: cudaError {err}")
    launches += 1
    kernel_launches["train_bwd"] += 1
    return ddelta, dx, da, db, dc


@_mamba_scan_train_bwd.register_fake
def _(delta, x, a, b, c, states, dy, dh):
    return (torch.empty_like(delta), torch.empty_like(x), torch.empty_like(a),
            torch.empty_like(b), torch.empty_like(c))


def _train_setup_context(ctx, inputs, output):
    delta, x, a, b, c, _ = inputs
    ctx.save_for_backward(delta, x, a, b, c, output[2])
    ctx.mark_non_differentiable(output[2])
    ctx.set_materialize_grads(False)


def _train_backward(ctx, dy, dh, _dstates):
    delta, x, a, b, c, states = ctx.saved_tensors
    if dy is None:
        dy = torch.zeros_like(delta)
    if dh is None:
        dh = delta.new_empty((0,))
    grads = torch.ops.repro_torch.mamba_scan_train_bwd(delta, x, a, b, c, states, dy, dh)
    return (*grads, None)


torch.library.register_autograd("repro_torch::mamba_scan_train", _train_backward,
                                setup_context=_train_setup_context)


@register_flop_formula(torch.ops.repro_torch.mamba_scan_train)
def _train_flops(delta_shape, x_shape, a_shape, *_args, **_kwargs) -> int:
    B, S, Di = delta_shape
    return 2 * B * S * Di * a_shape[1]


@register_flop_formula(torch.ops.repro_torch.mamba_scan_train_bwd)
def _train_bwd_flops(delta_shape, x_shape, a_shape, *_args, **_kwargs) -> int:
    B, S, Di = delta_shape
    return 4 * B * S * Di * a_shape[1]
