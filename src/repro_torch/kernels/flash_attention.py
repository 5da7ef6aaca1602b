"""Flash attention forward: build, ctypes binding and kernel-layout wrapper.

The kernels are `csrc/flash_attention.cu` (CUDA C++ for sm_90a), the port's
replacement for the reference's Pallas kernel `repro/kernels/flash_attention.py`.
It is compiled with `nvcc` at first use into `build/repro_torch/` of the
checkout the package runs from and loaded with ctypes (`build.py`).

One C entry point runs one of two kernels, by the rule `kernel_for` states:
bf16 runs on the tensor cores (wgmma fed by TMA) at any head dim up to 256,
zero-padded in shared memory to 64, 128 or 256, and float32 on the tensor
cores too, in 3xTF32 (mma.sync on operands split into two TF32 parts, fed by
cp.async).  TMA needs 16-byte aligned bases and strides, so a bf16 call that
breaks that raises here, with the reason, rather than run the other kernel.

`flash_attention` takes a CPU tensor to the plain version (`ref.py`) and a
CUDA tensor to the kernel; it never falls back from one to the other.  It is
forward only, and raises when autograd would record it (grad mode on and an
input that requires grad) rather than return an output without a gradient.

The kernel is the custom op `repro_torch::flash_attention_fwd`: its CUDA
implementation is the launch, and its fake implementation gives the output's
shape, dtype and layout, so that a step on fake tensors (`FakeTensorMode`,
the dry-run's, on any device) runs through it with no launch counted.  Its
FLOPs are counted as `torch.utils.flop_counter` counts the plain version's
two products, 4·B·H·Sq·Skv·D.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import flash_attention_ref

SOURCE = _build.PACKAGE / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0   # kernel launches; a run zeroes it to count one path's launches
# the same launches, by kernel
kernel_launches = {"tensor_core": 0, "tensor_core_fp32": 0}


def kernel_for(dtype, head_dim) -> str:
    """Which kernel a CUDA call runs, as `repro_flash_attention_fwd` dispatches:
    bf16 on the tensor cores by wgmma (`tensor_core`), float32 (held to 2e-5,
    which one TF32 product cannot meet) on the tensor cores in 3xTF32
    (`tensor_core_fp32`)."""
    if dtype == torch.bfloat16 and head_dim <= MAX_HEAD_DIM:
        return "tensor_core"
    return "tensor_core_fp32"


def tma_problem(name, t):
    """Why TMA cannot load `t` [B, heads, S, D] (bf16), or None: its base and every
    stride of a dim longer than 1 must be multiples of 16 bytes."""
    if t.data_ptr() % 16:
        return f"{name} starts at an address that is not 16-byte aligned ({t.data_ptr():#x})"
    for dim in range(3):
        if t.shape[dim] > 1 and (t.stride(dim) * t.element_size()) % 16:
            return (f"{name} has a stride of {t.stride(dim)} elements in dim {dim}, "
                    f"not a multiple of 16 bytes (strides {t.stride()})")
    return None


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, strides {t.stride()}")


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, scale=None):
    """q [B,H,Sq,D], k/v [B,K,Skv,D] -> [B,H,Sq,D]; any strides with a unit last-dim stride.

    KV head of query head h is h // (H/K); causal masks k > q + q_offset; a
    window > 0 masks q - k >= window; `scale` defaults to D**-0.5.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (neither has the reference's "
                           "kernel): its output would carry no gradient; train with "
                           "attn_impl naive, blocked or auto")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    window = int(window) if window else 0
    if q_offset < 0 or window < 0:
        raise ValueError(f"q_offset {q_offset} and window {window} must be >= 0")
    if q.device.type == "cpu" and not isinstance(q, FakeTensor):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, bool(causal), window,
                                                     int(q_offset), float(scale))


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                         window: int, q_offset: int, scale: float) -> torch.Tensor:
    """The launch: one of the two kernels (`kernel_for`) on the current stream."""
    global launches
    B, H, Sq, D = q.shape
    K, Skv = k.shape[1], k.shape[2]
    kernel = kernel_for(q.dtype, D)
    if kernel == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            problem = tma_problem(name, t)
            if problem:
                raise ValueError(f"the tensor-core kernel loads by TMA: {problem}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if B == 0 or Sq == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            B, H, K, Sq, Skv, D,
            *(t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)),
            int(causal), window, q_offset, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash attention {kernel} kernel launch failed: cudaError {err}")
    launches += 1
    kernel_launches[kernel] += 1
    return out


@_flash_attention_fwd.register_fake
def _(q, k, v, causal, window, q_offset, scale):
    B, H, Sq, D = q.shape
    return q.new_empty((B, Sq, H, D)).transpose(1, 2)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops(q_shape, k_shape, *_args, **_kwargs) -> int:
    B, H, Sq, D = q_shape
    return 4 * B * H * Sq * k_shape[2] * D
