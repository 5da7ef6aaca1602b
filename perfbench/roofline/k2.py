"""K2, the fused selective scan (`csrc/mamba_scan.cu`, `mamba_scan_fused`):
operations and bytes of one call, from its shape.

Per (b, t, d, n): delta·A, exp, the recurrence's multiply and add, ·B, the
readout's multiply and add (7); per (b, t, d): delta·x.  Bytes: delta (fp32),
x (bf16), A, B, C read once; y [B,S,Di] and the final state [B,Di,N] (fp32)
written once.  The bound is the larger of operations over the float32 peak
outside the tensor cores and bytes over HBM's rate."""
from perfbench.roofline import peaks


def counts(B, S, Di, N):
    flops = 7 * B * S * Di * N + B * S * Di
    nbytes = (4 * B * S * Di + 2 * B * S * Di + 4 * Di * N + 2 * 4 * B * S * N
              + 4 * B * S * Di + 4 * B * Di * N)
    return flops, nbytes


def bound_s(B, S, Di, N):
    flops, nbytes = counts(B, S, Di, N)
    return max(flops / peaks.FP32_SIMT_FLOPS, nbytes / peaks.HBM_BYTES)
