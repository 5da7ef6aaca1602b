"""GQA attention: projections, full/blocked softmax paths, KV-cache decode.

Three compute paths, as in the reference `repro.models.attention`:
  * ``naive``   — materialize [.., S, S] scores (small seqs / decode)
  * ``blocked`` — online softmax over KV chunks in plain PyTorch
  * ``flash``   — the CUDA kernel (`repro_torch.kernels.ops`), the
                  counterpart of the reference's ``pallas``; on a CPU tensor
                  it runs the kernel's plain version.
``auto`` never selects ``flash`` (the kernel is forward-only), as in the
reference.  Keys are cached post-RoPE.  The encoder-decoder adds a
bidirectional self-attention and cross-attention against the encoder
memory's K/V, computed once (`encode_memory_kv`) and cached for decode.

On a mesh (DTensor q/k/v), the softmax core runs on each rank's own batch
rows and heads (`_attend_local`, through `local_map`): attention does not
mix them, so the core needs no collective, and DTensor's einsum, which
flattens batch and head dims into one, cannot take both sharded in every
torch the port runs on.

Decode on a mesh reads a cache whose sequence dim is sharded (over `model`,
and over `data` too when the batch is 1: `sharding.cache_pspecs`).  The new
key and value are written by the rank whose shard holds the slot, in its
local tensor, with no collective (`_write_slot`); each rank attends over its
own keys, and the partial softmaxes are combined across the axes that split
the sequence by all-reduces of their max, sums and weighted values
(`_decode_attend_local`).  Neither gathers the cache.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.autoshard import (constrain, constrain_or_whole,
                                               constrain_residual, current_axes,
                                               current_mesh, local_shape_and_offset,
                                               role_placements)
from repro_torch.models.layers import apply_rope, rms_norm_head
from repro_torch.models.meta import ParamMeta
from repro_torch.scope import mark, scope, span

NEG_INF = -1e30


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (chunking non-power-of-2 seqs)."""
    cap = max(1, min(cap, n))
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


def attention_meta(cfg):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    m = {
        "wq": ParamMeta((d, qd), ("embed", "heads")),
        "wk": ParamMeta((d, kvd), ("embed", "kv_heads")),
        "wv": ParamMeta((d, kvd), ("embed", "kv_heads")),
        "wo": ParamMeta((qd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:   # read in fp32 by `rms_norm_head`
        m["q_norm"] = ParamMeta((cfg.head_dim,), (None,), init="ones", dtype="float32")
        m["k_norm"] = ParamMeta((cfg.head_dim,), (None,), init="ones", dtype="float32")
    return m


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous.  On the card, the
    attention core's backward can hand a projection a strided gradient
    (qwen3-moe's k: [B, S, Dh] laid out [B, Dh, S]), and DTensor on torch
    2.11 views it, where a reshape would copy, back to the matmul's
    [B*S, n], which fails."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        # a clone: a DTensor reports its global layout as contiguous, so
        # `contiguous()` would leave the local tensor as it is
        if isinstance(grad, DTensor) and not grad.to_local().is_contiguous():
            return grad.clone(memory_format=torch.contiguous_format)
        return grad


def _heads(t, n_heads: int, dh: int):
    """[B, S, n_heads * dh] -> [B, S, n_heads, dh].  On a mesh, the projection's
    columns may only be split over `model`, and only when it divides the heads:
    where it does not (chatglm3-6b: 2 kv heads on 4) they are gathered over
    `model` first (the fallback to replication the rules intend), and where
    another axis splits them (a micro-batch too small for `data`, whose
    product DTensor then splits on its columns over `data`) they are brought
    to heads over `model`."""
    if isinstance(t, DTensor):
        t = mark(_ContiguousGrad.apply(t))
        whole = n_heads % (current_axes() or {}).get("model", 1)
        elsewhere = any(pl.is_shard(2) and axis != "model"
                        for pl, axis in zip(t.placements, t.device_mesh.mesh_dim_names))
        if whole or elsewhere:
            t = constrain_or_whole(t, ("batch", None, None if whole else "model"))
    return t.reshape(*t.shape[:2], n_heads, dh)


def merge_heads(out):
    """[B, S, H, dh] -> [B, S, H * dh].  On a mesh the merged gradient that comes
    back from the output projection must split into heads again, which it can
    only do split over `model` where that divides the heads.  Where `model`
    does not (whisper-tiny: 6 on 8), `out` is whole over it while the
    projection's rows are split; where the batch is whole over `data` (a
    micro-batch smaller than it), DTensor splits that gradient over `data`.
    In both cases the gradient is brought back to `out`'s layout first (a
    constraint that is a no-op in forward)."""
    merged = out.reshape(*out.shape[:2], -1)
    if isinstance(out, DTensor):
        whole = out.shape[2] % (current_axes() or {}).get("model", 1)
        rows = role_placements(merged.shape, ("batch", None, None))
        if whole or rows is None:
            merged = constrain_or_whole(merged, ("batch", None, None if whole else "model"))
    return merged


def project_qkv(cfg, p, x_q, x_kv, positions_q, positions_kv):
    """Project and rope. x_q [B,Sq,D], x_kv [B,Skv,D] -> q[B,Sq,H,Dh], k/v[B,Skv,K,Dh]."""
    with span("qkv"):
        dt = x_q.dtype
        H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = _heads(x_q @ p["wq"].to(dt), H, Dh)
        k = _heads(x_kv @ p["wk"].to(dt), K, Dh)
        v = _heads(x_kv @ p["wv"].to(dt), K, Dh)
        if cfg.qk_norm:
            q = rms_norm_head(q, p["q_norm"])
            k = rms_norm_head(k, p["k_norm"])
        if positions_q is not None:
            q = apply_rope(cfg, q, positions_q)
        if positions_kv is not None:
            k = apply_rope(cfg, k, positions_kv)
        return q, k, v


def _mask_bias(q_idx, k_idx, *, causal: bool, window) -> torch.Tensor:
    """Additive bias [.., Sq, Skv] from index grids (fp32); window 0 = full."""
    ok = torch.ones(torch.broadcast_shapes(q_idx.shape, k_idx.shape),
                    dtype=torch.bool, device=q_idx.device)
    if causal:
        ok &= k_idx <= q_idx
    if window:
        ok &= (q_idx - k_idx) < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def attend_naive(cfg, q, k, v, *, causal=True, window=0, q_offset=0,
                 kv_valid_len=None):
    """q [B,Sq,H,Dh], k/v [B,Skv,K,Dh] -> [B,Sq,H,Dh].

    Scores are fp32 products of the working-dtype inputs (the reference's
    `preferred_element_type=float32`); probabilities are cast back to v's dtype.
    """
    B, Sq, H, Dh = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores * (cfg.head_dim ** -0.5)
    q_idx = (torch.arange(Sq, device=q.device) + q_offset)[:, None]
    k_idx = torch.arange(Skv, device=q.device)[None, :]
    bias = _mask_bias(q_idx, k_idx, causal=causal, window=window)
    if kv_valid_len is not None:
        bias = bias + torch.where(k_idx < kv_valid_len, 0.0, NEG_INF)
    probs = torch.softmax(scores + bias, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, Dh)


def attend_blocked(cfg, q, k, v, *, causal=True, window=0, q_offset=0,
                   kv_chunk=1024):
    """Online softmax over KV chunks (plain PyTorch, memory-bounded).

    Computes every (q, kv-chunk) pair with masking; the kernel skips fully
    masked tiles.
    """
    B, Sq, H, Dh = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    kv_chunk = largest_divisor_leq(Skv, min(kv_chunk, Skv))
    qg = q.reshape(B, Sq, K, G, Dh).float()
    q_idx = (torch.arange(Sq, device=q.device) + q_offset)[:, None]
    scale = cfg.head_dim ** -0.5
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, Dh), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, kv_chunk):
        kj = k[:, start:start + kv_chunk]
        vj = v[:, start:start + kv_chunk]
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kj.float()) * scale
        k_idx = (torch.arange(kv_chunk, device=q.device) + start)[None, :]
        scores = scores + _mask_bias(q_idx, k_idx, causal=causal, window=window)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(vj.dtype), vj).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)


def _local_heads(k, n_q_heads: int, group: int, model_rank: int):
    """This rank's kv heads when q's heads are split over `model` and k's are
    whole (K does not divide the axis): the heads of q's local groups."""
    if k.shape[2] * group == n_q_heads:
        return k
    if group % n_q_heads:
        raise ValueError(f"{n_q_heads} local q heads straddle GQA groups of {group}")
    first = model_rank * n_q_heads // group
    return k[:, :, first:first + 1]


def _attend_local(cfg, q, k, v, **kw):
    """`attend` on each rank's batch rows and heads of DTensor q/k/v: q and k/v
    are constrained to (batch, -, heads over `model`, -) (k/v whole over
    `model` when K does not divide it) and the core runs on the local shards."""
    roles = ("batch", None, "model", None)
    q, k, v = constrain(q, roles), constrain(k, roles), constrain(v, roles)
    mesh = current_mesh() or q.device_mesh
    rank = mesh.get_local_rank("model") if "model" in mesh.mesh_dim_names else 0
    group = cfg.num_heads // cfg.num_kv_heads

    def core(ql, kl, vl):
        kl, vl = (_local_heads(t, ql.shape[2], group, rank) for t in (kl, vl))
        return attend(cfg, ql, kl, vl, **kw)

    # where k/v are whole over a dim that splits q's heads, each rank reads only
    # its own kv heads: their gradient there is a partial sum over that dim
    kv_grad = [Partial() if kp.is_replicate() and qp.is_shard() else kp
               for kp, qp in zip(k.placements, q.placements)]
    return mark(local_map(core, out_placements=list(q.placements),
                          in_placements=(q.placements, k.placements, v.placements),
                          in_grad_placements=(q.placements, kv_grad, kv_grad),
                          device_mesh=mesh)(q, k, v))


def attend(cfg, q, k, v, *, causal=True, window=0, q_offset=0, impl="auto",
           kv_valid_len=None):
    if isinstance(q, DTensor):
        return _attend_local(cfg, q, k, v, causal=causal, window=window, q_offset=q_offset,
                             impl=impl, kv_valid_len=kv_valid_len)
    if impl == "auto":
        big = q.shape[1] * k.shape[1] > (1 << 22) or k.shape[1] > 2048
        impl = "blocked" if big and kv_valid_len is None else "naive"
    if impl == "flash":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(cfg, q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    if impl == "blocked":
        return attend_blocked(cfg, q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    if impl != "naive":
        raise ValueError(f"attn impl {impl!r} not in auto|naive|blocked|flash")
    return attend_naive(cfg, q, k, v, causal=causal, window=window,
                        q_offset=q_offset, kv_valid_len=kv_valid_len)


def apply_attention(cfg, p, x, positions, *, causal=True, window=0, impl="auto"):
    """Self-attention over x [B,S,D] (the encoder's, bidirectional with causal=False)."""
    with scope("attn"):
        q, k, v = project_qkv(cfg, p, x, x, positions, positions)
        out = attend(cfg, q, k, v, causal=causal, window=window, impl=impl)
        return constrain_residual(merge_heads(out) @ p["wo"].to(x.dtype))


def apply_cross_attention(cfg, p, x, memory_kv):
    """Queries from x [B,Sq,D] against the encoder memory's (k, v) [B,Sm,K,Dh],
    unmasked; the attention is always `auto`, as in the reference."""
    with scope("cross_attn"):
        dt = x.dtype
        B, Sq, _ = x.shape
        q = _heads(x @ p["wq"].to(dt), cfg.num_heads, cfg.head_dim)
        k, v = memory_kv
        out = attend(cfg, q, k, v, causal=False, window=0, impl="auto")
        return constrain_residual(merge_heads(out) @ p["wo"].to(dt))


def encode_memory_kv(cfg, p, memory):
    """Cross-attention (k, v) [B,Sm,K,Dh] from the encoder output [B,Sm,D]."""
    dt = memory.dtype
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    return _heads(memory @ p["wk"].to(dt), K, Dh), _heads(memory @ p["wv"].to(dt), K, Dh)


# --------------------------------------------------------------------------
# decode (single new token against a cache)
# --------------------------------------------------------------------------

def decode_positions(cfg, B: int, pos: int, device) -> torch.Tensor:
    """The rope ids of a decode step at `pos`: [B, 1], or [3, B, 1] for m-rope.

    The reference passes [B, 1] ids to its m-rope, which reads rows 0, 1 and 2
    of them (clamped to row B-1 when B < 3): each row holds pos, so every
    section turns by pos, as [3, B, 1] ids of pos do.
    """
    shape = (3, B, 1) if cfg.rope == "mrope" else (B, 1)
    return torch.full(shape, pos, dtype=torch.int32, device=device)


def decode_attention(cfg, p, x, cache_k, cache_v, pos: int, *, window=0,
                     windowed_cache=False, positions=None):
    """One-token self-attention against a KV cache.

    x [B, 1, D]; pos the current position (int); cache_k/v [B, Sc, K, Dh], Sc
    the full length or, with `windowed_cache`, the window (a ring buffer).
    `positions` overrides the rope ids ([B, 1], or [3, B, 1] for m-rope).
    Writes the new key and value into the caches IN PLACE at slot `pos`
    (`pos % Sc` for the ring; the reference returns updated copies and
    donates the old buffers) and returns (out [B,1,D], cache_k, cache_v).
    """
    with scope("attn_decode"):
        dt = x.dtype
        B, Sc = x.shape[0], cache_k.shape[1]
        if positions is None:
            positions = decode_positions(cfg, B, pos, x.device)
        q, k_new, v_new = project_qkv(cfg, p, x, x, positions, positions)
        slot = pos % Sc if windowed_cache else pos
        if isinstance(cache_k, DTensor):
            _write_slot(cache_k, k_new[:, 0], slot)
            _write_slot(cache_v, v_new[:, 0], slot)
            out = _decode_attend_local(cfg, q, cache_k, cache_v, pos, window=window,
                                       ring=windowed_cache)
        else:
            cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
            cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
            if windowed_cache:
                # ring buffer: once warm every slot holds a key inside the window
                # (keys carry their rope, so slot order does not matter); before
                # that, the slots past pos are masked as not yet written
                out = attend_naive(cfg, q, cache_k.to(dt), cache_v.to(dt), causal=False,
                                   window=None, kv_valid_len=min(pos + 1, Sc))
            else:
                # slot index == absolute position, so causal + window masking
                # with q_offset=pos covers validity too (k_idx <= pos)
                out = attend_naive(cfg, q, cache_k.to(dt), cache_v.to(dt),
                                   causal=True, window=window, q_offset=pos)
        y = out.reshape(B, 1, -1) @ p["wo"].to(dt)
        return y, cache_k, cache_v


def _seq_shard(cache):
    """(global offset, length) of this rank's keys in a DTensor cache [B, Sc, K, Dh],
    and the mesh dims that split the sequence."""
    local, offset = local_shape_and_offset(cache.shape, cache.device_mesh, cache.placements)
    dims = [d for d, pl in enumerate(cache.placements) if pl.is_shard(1)]
    return offset[1], local[1], dims


def _batch_placements(cache):
    """A per-row tensor's placements beside the cache: its batch split as the
    cache's, whole on every other mesh dim."""
    return tuple(Shard(0) if pl.is_shard(0) else Replicate() for pl in cache.placements)


def _write_slot(cache, new, slot: int):
    """Write new [B, K, Dh] at sequence position `slot` of the DTensor cache
    [B, Sc, K, Dh], in place, on the rank whose shard holds the slot; the
    other ranks write nothing.  `new` is first made whole on every rank that
    shares the cache's rows (a gather of its heads over `model`: one key,
    not the cache)."""
    lo, n, _ = _seq_shard(cache)
    pl = _batch_placements(cache)
    new = new.to(cache.dtype).redistribute(cache.device_mesh, pl)

    def write(cl, nl):
        if lo <= slot < lo + n:
            cl[:, slot - lo] = nl
        return cl
    local_map(write, out_placements=list(cache.placements), in_placements=(cache.placements, pl),
              device_mesh=cache.device_mesh)(cache, new)


def _decode_attend_local(cfg, q, cache_k, cache_v, pos: int, *, window=0, ring=False):
    """One query token q [B,1,H,Dh] (a DTensor) against the DTensor cache, per
    rank over its own keys: the masks of `decode_attention` (a ring's valid
    slots, or causal + window at q_offset pos) on the keys' global positions,
    a local softmax in fp32, then the max, the sums and the weighted values
    all-reduced over the mesh dims that split the sequence.  Returns
    [B,1,H,Dh] in q's dtype, its batch split as the cache's."""
    mesh, dt = cache_k.device_mesh, q.dtype
    lo, n, seq_dims = _seq_shard(cache_k)
    pl = _batch_placements(cache_k)
    q = q.redistribute(mesh, pl)
    scale = cfg.head_dim ** -0.5

    def core(ql, kl, vl):
        B, _, H, Dh = ql.shape
        K = kl.shape[2]
        k_idx = (torch.arange(n, device=ql.device) + lo)[None, :]
        if ring:
            bias = torch.where(k_idx < min(pos + 1, cache_k.shape[1]), 0.0, NEG_INF)
        else:
            bias = _mask_bias(torch.tensor([[pos]], device=ql.device), k_idx, causal=True,
                              window=window)
        qg = ql.reshape(B, 1, K, H // K, Dh).float()
        s = torch.einsum("bskgd,btkd->bkgst", qg, kl.float()) * scale + bias.float()
        m = s.amax(dim=-1, keepdim=True)
        for d in seq_dims:
            m = funcol.all_reduce(m, "max", (mesh, d))
        e = torch.exp(s - m)
        den = e.sum(dim=-1, keepdim=True)
        num = torch.einsum("bkgst,btkd->bkgsd", e, vl.float())
        for d in seq_dims:
            den = funcol.all_reduce(den, "sum", (mesh, d))
            num = funcol.all_reduce(num, "sum", (mesh, d))
        out = (num / den).permute(0, 3, 1, 2, 4).reshape(B, 1, H, Dh)
        return out.to(dt)
    return local_map(core, out_placements=list(pl), in_placements=(pl, cache_k.placements,
                                                             cache_v.placements),
                     device_mesh=mesh)(q, cache_k, cache_v)
