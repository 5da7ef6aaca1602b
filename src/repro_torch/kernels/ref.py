"""Plain PyTorch versions of the kernels (the CPU path and the allclose oracle),
the plain model of the training scan's forward and backward kernels, and the
plain differentiable scans (`scan_chunked`, `scan_inloop`): the training
entry point's CPU path and the model's training scan on CPU tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0, scale=None):
    """q [B,H,Sq,D], k/v [B,K,Skv,D] -> [B,H,Sq,D] (fp32 softmax).

    KV head of query head h is h // (H/K).  Masked scores are -1e30.
    """
    H, Sq, D = q.shape[1], q.shape[2], q.shape[3]
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    qi = (torch.arange(Sq, device=q.device) + q_offset)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window and window > 0:
        ok &= (qi - ki) < window
    s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def mamba_scan_ref(a_bar, bx, c, *, return_state=False):
    """Sequential scan: h_t = a_t * h_{t-1} + bx_t from h_0 = 0; y_t[d] = <h_t[d], c_t>.

    a_bar/bx [B,S,Di,N] fp32, c [B,S,N] fp32 -> y [B,S,Di] fp32, and with
    `return_state` also h_S [B,Di,N].  Differentiable: training runs it (on a
    mesh too, where the steps' outputs are stacked, not written into a buffer).
    """
    B, S, Di, N = a_bar.shape
    h = torch.zeros((B, Di, N), dtype=torch.float32, device=a_bar.device)
    ys = []
    for t in range(S):
        h = a_bar[:, t] * h + bx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, Di), dtype=torch.float32, device=a_bar.device))
    return (y, h) if return_state else y


def mamba_scan_fused_ref(delta, x, a, b, c, delta_bias=None, d_skip=None, z=None, *,
                         return_state=False):
    """The discretisation as the model's `_ssm_inputs` makes it, then
    `mamba_scan_ref`: a_bar = exp(delta·a), bx = (delta·x)·b.

    delta/x [B,S,Di] (x any float), a [Di,N], b/c [B,S,N] fp32 -> y [B,S,Di]
    fp32, and with `return_state` also h_S [B,Di,N].  With `delta_bias`,
    `d_skip` and `z`, all three, the fused kernel's call, in the mixer's
    order of ops: delta is the raw dt projection, widened, `+ delta_bias`,
    softplus; after the scan `y + x·d_skip` in fp32, rounded to x's dtype,
    `* silu(z)`."""
    gate = (delta_bias, d_skip, z)
    if any(t is not None for t in gate) and any(t is None for t in gate):
        raise ValueError("the gate takes delta_bias, d_skip and z together")
    if delta_bias is not None:
        delta = F.softplus(delta.float() + delta_bias.float())
    a_bar = (delta[..., None] * a).exp()
    bx = (delta * x.float())[..., None] * b[..., None, :]
    y, h = mamba_scan_ref(a_bar, bx, c, return_state=True)
    if z is not None:
        y = (y + x.float() * d_skip.float()).to(x.dtype) * F.silu(z)
    return (y, h) if return_state else y


def train_chunk(N: int) -> int:
    """Timesteps a saved state of the training scan covers at state size N
    (`csrc/mamba_scan_train.cu`'s chunk_of): min(32, 256 / P), P = N rounded
    up to a power of two, at least 4, so that a warp's recomputed chunk of
    states takes 32 KB of shared memory."""
    p = 4
    while p < N:
        p *= 2
    return min(32, 256 // p)


def _train_step(delta, x, a, b, t, h):
    """h_t from h_{t-1}, as the training kernels make it; also (a_bar_t, delta_t·x_t)."""
    dt = delta[:, t, :, None]
    ab = torch.exp(dt * a)
    dtx = dt * x[:, t, :, None]
    return ab * h + dtx * b[:, t, None, :], ab, dtx


def mamba_scan_train_ref(delta, x, a, b, c):
    """The training forward's plain version: `mamba_scan_fused_ref`'s y and
    h_S, and the state at the start of every chunk of `train_chunk(N)` steps,
    [B, ceil(S / chunk), Di, N], in delta's dtype (x widened to it)."""
    B, S, Di = delta.shape
    chunk = train_chunk(a.shape[1])
    x = x.to(delta.dtype)
    h = delta.new_zeros((B, Di, a.shape[1]))
    ys, starts = [], []
    for t in range(S):
        if t % chunk == 0:
            starts.append(h)
        h = _train_step(delta, x, a, b, t, h)[0]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h, torch.stack(starts, dim=1)


def mamba_scan_train_bwd_ref(delta, x, a, b, c, states, dy, dh=None):
    """The training backward's plain model, as its kernel computes it: for each
    chunk, last to first, the chunk's states recomputed from its saved start
    (`states`, from `mamba_scan_train_ref`), then time stepped backwards with
    g_t = dy_t·C_t + a_bar_{t+1}·g_{t+1} (g_{S-1} also takes dh, the gradient
    of h_S).  Returns (ddelta, dx in x's dtype, dA, dB, dC)."""
    B, S, Di = delta.shape
    chunk = train_chunk(a.shape[1])
    xw = x.to(delta.dtype)
    g = dh.clone() if dh is not None else delta.new_zeros((B, Di, a.shape[1]))
    ddelta, dx = torch.empty_like(delta), torch.empty_like(delta)
    da, db, dc = torch.zeros_like(a), torch.empty_like(b), torch.empty_like(c)
    for ck in reversed(range(states.shape[1])):
        t0, t1 = ck * chunk, min(S, (ck + 1) * chunk)
        hs = [states[:, ck]]                     # the state before each step of the chunk
        for t in range(t0, t1 - 1):
            hs.append(_train_step(delta, xw, a, b, t, hs[-1])[0])
        for t in reversed(range(t0, t1)):
            hp = hs[t - t0]
            ht, ab, dtx = _train_step(delta, xw, a, b, t, hp)
            gt = g + dy[:, t, :, None] * c[:, t, None, :]
            dc[:, t] = torch.einsum("bdn,bd->bn", ht, dy[:, t])
            db[:, t] = (gt * dtx).sum(1)
            sgb = (gt * b[:, t, None, :]).sum(-1)            # d(delta_t·x_t)
            gha = gt * hp * ab                                # d(a_bar_t)·a_bar_t
            da += (gha * delta[:, t, :, None]).sum(0)
            ddelta[:, t] = (gha * a).sum(-1) + xw[:, t] * sgb
            dx[:, t] = delta[:, t] * sgb
            g = gt * ab
    return ddelta, dx.to(x.dtype), da, db, dc


def _discretise(delta, x, a, b):
    """a_bar = exp(delta * A) and bx = (delta * x) * B, [B,S,di,N] fp32, from
    delta and x [B,S,di] (x fp32), A [di,N] and B [B,S,N]."""
    a_bar = (delta[..., None] * a).exp_()
    bx = (delta * x)[..., None] * b[..., None, :]
    return a_bar, bx


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
    """The scan of `mamba_scan_ref` (same arguments and results,
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
