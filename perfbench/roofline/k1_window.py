"""K1 (`csrc/flash_attention.cu`) on a call with a causal mask and a window:
operations and bytes from its shape and window.

Operations are the two products on the (query, key) pairs the mask keeps,
4·D per pair and head; a window w keeps key j for query i where
0 <= i - j < w, w = 0 none but the causal mask.  Bytes are `roofline/k1.py`'s:
q, k, v (bf16) read once and the output written once.  The bound is the
larger of operations over the bf16 peak and bytes over HBM's rate."""
from perfbench.roofline import k1, peaks


def windows(m):
    """Each layer's window in the configuration `m` (its "model" block): its
    `window_pattern`, else its one `window` in every layer (0: global)."""
    return list(m.get("window_pattern") or [m.get("window", 0)] * m["num_layers"])


def pairs(S, w):
    """(query, key) pairs kept over S positions by the causal mask and window w."""
    if w == 0 or w >= S:
        return k1.causal_pairs(S)
    return w * (w + 1) // 2 + (S - w) * w


def counts(B, H, K, S, D, w):
    """(operations, bytes) of one call on q [B,H,S,D] and k/v [B,K,S,D], window w."""
    return 4 * D * B * H * pairs(S, w), k1.counts(B, H, K, S, D)[1]


def bound_s(B, H, K, S, D, w):
    flops, nbytes = counts(B, H, K, S, D, w)
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
