"""K1, the flash-attention forward (`csrc/flash_attention.cu`): operations and
bytes of one causal call, from its shape.

Operations are the two products on the pairs the causal mask keeps, 4·D per
pair and head; bytes are q, k, v (bf16) read once and the output written
once.  The bound is the larger of operations over the bf16 peak and bytes
over HBM's rate."""
from perfbench.roofline import peaks


def causal_pairs(S):
    """(query, key) pairs that a causal mask keeps over S positions."""
    return S * (S + 1) // 2


def counts(B, H, K, S, D):
    """(operations, bytes) of one call on q [B,H,S,D] and k/v [B,K,S,D]."""
    flops = 4 * D * B * H * causal_pairs(S)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * K * S * D)
    return flops, nbytes


def bound_s(B, H, K, S, D):
    flops, nbytes = counts(B, H, K, S, D)
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
