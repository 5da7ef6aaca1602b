#!/usr/bin/env python3
"""K2's fused entry point at each chunk count, at the serving paths' shapes, on
one CUDA card: the C entry point called with each chunk length (the wrapper
takes `kernels.mamba_scan.scan_chunks`' count), its time by CUDA events and its
largest error against the plain version (y and h_S; dt, x and z in bf16, z the
gate half of an in_proj output):

    python3 scripts/torch_scan_chunks.py

The readings that `scan_chunks`' constants are fitted to.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import mamba_scan as ms, ref  # noqa: E402

COUNTS = (1, 2, 3, 4, 6, 8, 11, 16, 24, 32)


def launch(dt, x, a, b, c, bias, d_skip, z, chunk):
    B, S, Di = dt.shape
    N = a.shape[1]
    y = torch.empty((B, S, Di), dtype=x.dtype, device="cuda")
    h = torch.empty((B, Di, N), device="cuda")
    scratch = torch.empty((2, max(-(-S // chunk) - 1, 1), B, Di, N), device="cuda")
    err = ms._lib().repro_mamba_scan_fused_fwd(
        dt.data_ptr(), x.data_ptr(), 1, a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), h.data_ptr(), scratch.data_ptr(), bias.data_ptr(), d_skip.data_ptr(),
        z.data_ptr(), z.stride(0), z.stride(1), B, S, Di, N, chunk,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cudaError {err}")
    return y, h


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_chunks: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, Di, N in cs.SCAN_PATH_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        z = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        dt = (z(B, S, Di) - 1.0).bfloat16()
        a = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32) * (0.1 * z(Di, N)).exp()
        x, b, c = z(B, S, Di).bfloat16(), z(B, S, N), z(B, S, N)
        ins = (dt, x, a, b, c, 0.5 * z(Di), z(Di), z(B, S, 2 * Di).bfloat16()[..., Di:])
        want_y, want_h = ref.mamba_scan_fused_ref(*ins, return_state=True)
        rule = ms.scan_chunks(B, S, Di, N, sms)
        for chunks in COUNTS:
            chunk = -(-S // chunks)
            y, h = launch(*ins, chunk)
            err = max(float((y.float() - want_y.float()).abs().max()),
                      float((h - want_h).abs().max()))
            ms_ = cs.cuda_ms(torch, lambda: launch(*ins, chunk), 10)
            print(f"{(B, S, Di, N)} chunks {chunks} (rule {rule}) chunk {chunk}: "
                  f"{ms_:.4f} ms, max abs err {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
