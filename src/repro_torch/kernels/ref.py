"""Plain PyTorch versions of the kernels (the CPU path and the allclose oracle)."""
from __future__ import annotations

import torch


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


def mamba_scan_fused_ref(delta, x, a, b, c, *, return_state=False):
    """The discretisation as the model's `_ssm_inputs` makes it, then
    `mamba_scan_ref`: a_bar = exp(delta·a), bx = (delta·x)·b.

    delta/x [B,S,Di] (x any float), a [Di,N], b/c [B,S,N] fp32 -> y [B,S,Di]
    fp32, and with `return_state` also h_S [B,Di,N]."""
    a_bar = (delta[..., None] * a).exp()
    bx = (delta * x.float())[..., None] * b[..., None, :]
    return mamba_scan_ref(a_bar, bx, c, return_state=return_state)
