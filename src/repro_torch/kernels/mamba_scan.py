"""Mamba-1 selective scan: build, ctypes binding and wrapper.

The kernel is `csrc/mamba_scan.cu` (CUDA C++ for sm_90a), the port's
replacement for the reference's Pallas kernel `repro/kernels/mamba_scan.py`.
It is compiled with `nvcc` at first use into `build/repro_torch/` of the
checkout the package runs from and loaded with ctypes (`build.py`).

`mamba_scan` takes a CPU tensor to the plain version (`ref.py`) and a CUDA
tensor to the kernel; it never falls back from one to the other.  It is
forward only, and raises when autograd would record it (grad mode on and an
input that requires grad) rather than return an output without a gradient.

The kernel is the custom op `repro_torch::mamba_scan`: its CUDA
implementation is the launch, and its fake implementation gives y and, when
asked, h_S, so that a step on fake tensors (`FakeTensorMode`, the dry-run's,
on any device) runs through it with no launch counted.  Its FLOPs are
counted as `torch.utils.flop_counter` counts the plain version (its readout
products, 2·B·S·Di·N; the recurrence is elementwise).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import mamba_scan_ref

SOURCE = _build.PACKAGE / "csrc" / "mamba_scan.cu"
MAX_STATE = 32

launches = 0   # kernel launches; a run zeroes it to count one path's launches


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.repro_mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
                           "train with apply_ssm(scan_impl='plain')")
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
