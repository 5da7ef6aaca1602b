"""What the family references share: float32 with TF32 off, the float8
control's matmul, RMSNorm, the next-token loss and AdamW.

`prec` is "fp32" (the reference), or one of two controls, the reference
computed one precision below the served bfloat16, rounding to float8 e4m3
with one scale per tensor and passing gradients straight through:
  "fp8"       every tensor that the program holds in its compute dtype: each
              matmul's operands and output (the product accumulated in
              float32, as an fp8 GEMM does), the residual stream after the
              embedding and after each layer's add, the convolution's output
  "fp8_gemm"  only the matmuls' operands: the GEMMs moved to float8, the
              shortcut nearest to hand on the H100"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """Float32 matmuls and convolutions without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


PRECISIONS = ("fp32", "fp8", "fp8_gemm")


def act(x, prec):
    """x as the precision holds an activation: rounded in "fp8", else itself."""
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r} not one of {PRECISIONS}")
    return _Fp8Round.apply(x) if prec == "fp8" else x


def mm(x, w, prec):
    """x @ w in float32, w read from its stored dtype; the operands rounded in
    both controls, the output in "fp8"."""
    if prec == "fp8_gemm":
        return _Fp8Round.apply(x) @ _Fp8Round.apply(w.float())
    return act(act(x, prec) @ act(w.float(), prec), prec)


def rms_norm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def next_token_loss(logits, tokens):
    """Mean negative log-likelihood of each next token; the last position,
    which has none, left out."""
    lf = logits.float()
    nll = torch.logsumexp(lf, -1) - lf.gather(-1, tokens.roll(-1, 1)[..., None]).squeeze(-1)
    return nll[:, :-1].mean()


def flat(tree, path=()):
    """[(path, leaf)] of a dict/list tree, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flat(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in flat(v, path + (str(i),))]
    return [(path, tree)]


def unflat(tree, values, path=()):
    if isinstance(tree, dict):
        return {k: unflat(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [unflat(v, values, path + (str(i),)) for i, v in enumerate(tree)]
    return values[path]


def lr_at(opt, count):
    """Linear warm-up to `lr`, then a cosine to `min_lr_ratio` of it."""
    warm = min(count / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((count - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * warm * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def train(family, m, weights, batches, opt, accum, prec="fp32", steps=3):
    """`steps` AdamW steps of `family`'s loss from `weights` (float32 leaves) on
    `batches` ([B, S] token ids each, split into `accum` micro-batches of rows).
    Returns {"loss": [per step], "grad1": {path: norm of step 1's clipped
    gradient}, "grad1_raw": {path: its norm before clipping}, "change":
    {path: norm of the leaves' change over the steps}}."""
    leaves = flat(weights)
    params = {p: t.detach().float().clone().requires_grad_() for p, t in leaves}
    start = {p: t.detach().clone() for p, t in params.items()}
    mom = {p: torch.zeros_like(t) for p, t in params.items()}
    vel = {p: torch.zeros_like(t) for p, t in params.items()}
    out = {"loss": []}
    with exact_fp32():
        for step in range(steps):
            grads = {p: torch.zeros_like(t) for p, t in params.items()}
            total = 0.0
            for micro in batches[step].chunk(accum, dim=0):
                loss = family.loss(m, unflat(weights, params), micro, prec)
                for p, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
                    grads[p] += g / accum
                total += float(loss.detach()) / accum
            out["loss"].append(total)
            gnorm = math.sqrt(sum(float(g.pow(2).sum()) for g in grads.values()))
            clip = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0) if opt["clip_norm"] else 1.0
            count = step + 1
            lr = lr_at(opt, count)
            bc1, bc2 = 1 - opt["beta1"] ** count, 1 - opt["beta2"] ** count
            with torch.no_grad():
                for p, t in params.items():
                    g = grads[p] * clip
                    mom[p].mul_(opt["beta1"]).add_(g, alpha=1 - opt["beta1"])
                    vel[p].mul_(opt["beta2"]).add_(g * g, alpha=1 - opt["beta2"])
                    upd = (mom[p] / bc1) / ((vel[p] / bc2).sqrt() + opt["eps"])
                    t.sub_(lr * (upd + opt["weight_decay"] * t))
            if step == 0:
                out["grad1"] = {p: float(g.norm()) * clip for p, g in grads.items()}
                out["grad1_raw"] = {p: float(g.norm()) for p, g in grads.items()}
            del grads
    out["change"] = {p: float((t.detach() - start[p]).norm()) for p, t in params.items()}
    return out


def silu(x):
    return F.silu(x)
