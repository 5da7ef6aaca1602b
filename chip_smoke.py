#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device  — the card's name and power limit, as nvidia-smi reports them
  2. build   — nvcc builds every kernel from src/repro_torch/csrc into build/repro_torch
  3. kernels — each kernel against its plain PyTorch version on the card, at the
               reference's test shapes (the tests' tolerances) and at the serving
               path's shape (max abs error 1e-2); bf16 outputs element by element
               within two bf16 rounding steps; kernel, plain, library and bound times
  4. serving — full-width chatglm3-6b (28 layers, seed-0 random bf16 weights):
               4 prompts of 1024 tokens through make_prefill_step(attn_impl="flash"),
               then 16 greedy make_decode_step steps; 28 kernel launches per prefill;
               prefill logits against attn_impl="naive" and prefill + one decode
               against forward's last logits, asserted in fp32 compute at full width
               (relative error < 2e-5) and reported in bf16
  5. server  — BatchedServer at full width answers 4 requests
  6. a JSON line of every ported kernel, then the JSON result line.
Without a CUDA device, or outside a checkout of the repo, it exits non-zero and
prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM data sheet, dense
PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3, bytes/s
FP32_TOL = 2e-5       # relative; the port's fp32 parity tolerance against the reference
# bf16 outputs, element by element: kernel and plain version both compute in fp32
# and round once to bf16, so they may differ by one bf16 step, at most 2^-7 of the
# value (plus the fp32 difference near zero, ~1e-6 in the fp32 cases); the limit
# is two such steps
BF16_STEP, BF16_FLOOR, BF16_MAX_STEPS = 2.0 ** -7, 1e-5, 2.0
# B, H, K, S, D, causal, window, dtype, tol: the serving path's shape, and the
# reference's FLASH_CASES (tests/test_kernels.py) with their tolerances.  The path
# shape's max abs limit is set from its readings: error 0.0039 (one bf16 step at
# values in [0.5, 1)) against a median |output| of ~0.05
PATH_SHAPE = (4, 32, 2, 1024, 128, True, 0, "bfloat16", 1e-2)
FLASH_CASES = [
    (1, 2, 2, 256, 128, True, 0, "float32", 2e-5),
    (2, 4, 2, 256, 128, True, 64, "float32", 2e-5),
    (1, 2, 1, 512, 128, False, 0, "float32", 2e-5),
    (1, 6, 3, 256, 256, True, 0, "float32", 2e-5),
    (1, 4, 4, 128, 128, True, 0, "bfloat16", 3e-2),
    (1, 2, 2, 384, 128, True, 128, "bfloat16", 3e-2),
]


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters):
    """Mean device time of fn over `iters` back-to-back calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel(torch, a, b):
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-6))


def device_breakdown(torch, fn):
    """Device time of fn() by kernel group, from a torch.profiler trace.

    busy_ms sums kernel durations (one stream: they do not overlap); idle is
    the share of the span from the first kernel's start to the last one's end
    in which no kernel ran.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    starts, ends = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        dur = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        if "flash_fwd_kernel" in name:
            groups["flash_attention"] += dur
        elif any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
            groups["matmul"] += dur
        else:
            groups["other"] += dur
        starts.append(e.time_range.start)
        ends.append(e.time_range.end)
    check(starts, "profiler saw no device activity")
    busy = sum(groups.values())
    span = (max(ends) - min(starts)) / 1e3
    return dict(busy_ms=busy, span_ms=span, idle_share=1 - busy / span,
                **{f"{k}_ms": v for k, v in groups.items()})


def flash_case(torch, F, fa, ref, case, seed, q_offset=0, layout="bhsd"):
    """Kernel vs plain version on one shape; returns a result dict."""
    B, H, K, S, D, causal, window, dtype, tol = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Sq = S - q_offset
    shapes = ((B, H, Sq, D), (B, K, S, D), (B, K, S, D))
    if layout == "bshd":   # model layout, read in place through transposed views
        q, k, v = (torch.randn((s[0], s[2], s[1], s[3]), generator=gen, device="cuda",
                               dtype=torch.float32).to(dt).transpose(1, 2) for s in shapes)
    else:
        q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=torch.float32).to(dt)
                   for s in shapes)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    plain = ref.flash_attention_ref(q, k, v, **kw)
    diff = (out.float() - plain.float()).abs()
    err = float(diff.max())
    check(torch.isfinite(out).all().item(), f"non-finite kernel output {case}")
    check(err < tol, f"kernel vs plain {case} q_offset={q_offset}: {err} >= {tol}")
    steps = None
    if dt == torch.bfloat16:
        steps = float((diff / (BF16_STEP * plain.float().abs() + BF16_FLOOR)).max())
        check(steps <= BF16_MAX_STEPS,
              f"kernel vs plain {case}: {steps} bf16 steps apart > {BF16_MAX_STEPS}")

    # library yardstick: SDPA on the same inputs with KV expanded to H heads
    G = H // K
    ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    qi = torch.arange(Sq, device="cuda")[:, None] + q_offset
    ki = torch.arange(S, device="cuda")[None, :]
    mask = torch.ones((Sq, S), dtype=torch.bool, device="cuda")
    if causal:
        mask &= ki <= qi
    if window:
        mask &= (qi - ki) < window
    if causal and not window and q_offset == 0:
        lib = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
    else:
        lib = lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask)  # noqa: E731
    lib_err = float((lib().float() - plain.float()).abs().max())

    iters = 20 if S * Sq * B * H < (1 << 28) else 10
    kernel_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), iters)
    plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), iters)
    library_ms = cuda_ms(torch, lib, iters)
    flops = 4 * D * B * H * int(mask.sum())                 # QK^T and PV on unmasked pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return dict(case=list(case[:8]), q_offset=q_offset, layout=layout, max_abs_err=err,
                tol=tol, bf16_steps=steps, median_abs_out=float(plain.float().abs().median()),
                library_err=lib_err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} python {sys.version.split()[0]}")

    # 2. build (one source today; each source would get its own nvcc, started together)
    t0 = time.perf_counter()
    report = fa.build()
    print(f"[build] flash_attention.cu in {time.perf_counter() - t0:.1f}s -> {fa.library_path()}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    # 3. kernel vs plain version
    results = [flash_case(torch, F, fa, ref, case, seed=i) for i, case in enumerate(FLASH_CASES)]
    results.append(flash_case(torch, F, fa, ref, (1, 2, 2, 256, 128, True, 0, "float32", 2e-5),
                              seed=100, q_offset=128))
    results.append(flash_case(torch, F, fa, ref, (1, 4, 2, 128, 120, True, 0, "float32", 2e-5),
                              seed=101, layout="bshd"))
    results.append(flash_case(torch, F, fa, ref, PATH_SHAPE, seed=102, layout="bshd"))
    for r in results:
        print("[kernel] " + json.dumps(r))
    path = results[-1]

    # 4. full-width serving through the step factories
    cfg = get_config("chatglm3-6b")
    t0 = time.perf_counter()
    params = api.init_params(cfg, 0)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {api.param_count(cfg) / 1e9:.3f}B params in bf16, "
          f"init {time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    B, S, cache_len, n_decode = 4, 1024, 1040, 16
    batch = api.demo_batch(cfg, B, S, seed=0)
    prefill = make_prefill_step(cfg, StepSettings(attn_impl="flash"), cache_len=cache_len)
    decode = make_decode_step(cfg)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0                                # counts the main path only
    prefill_s = []
    for rep in range(2):                           # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        check(fa.launches == cfg.num_layers * (rep + 1),
              f"{fa.launches} flash launches after {rep + 1} prefills")
    prefill_logits = logits.clone()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    generated = [tok]
    decode_s = []
    for i in range(n_decode):                      # the first step is timed apart (cold)
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok, S + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        generated.append(tok)
        if i in (0, n_decode - 1):
            torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
    main_launches = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    generated = torch.cat(generated, dim=1)
    check(main_launches == 2 * cfg.num_layers, f"{main_launches} launches on the main path")
    check(bool(torch.isfinite(prefill_logits).all()) and bool(torch.isfinite(logits).all()),
          "non-finite logits")
    check(prefill_logits.shape == (B, 1, cfg.vocab_size), f"logits {prefill_logits.shape}")
    check(cache["k"].shape == (cfg.num_layers, B, cache_len, cfg.num_kv_heads, cfg.head_dim),
          f"cache {tuple(cache['k'].shape)}")
    check(bool(((generated >= 0) & (generated < cfg.vocab_size)).all()), "token out of range")
    print(f"[serve] prefill {B}x{S}: {prefill_s[1] * 1e3:.1f} ms "
          f"({B * S / prefill_s[1]:.0f} tok/s; cold {prefill_s[0] * 1e3:.1f} ms), "
          f"28 flash launches per prefill")
    warm_s = sum(decode_s[1:])
    print(f"[serve] decode {n_decode} steps x {B}: {warm_s * 1e3 / (n_decode - 1):.2f} ms/step "
          f"after the first ({B * (n_decode - 1) / warm_s:.1f} tok/s; cold first step "
          f"{decode_s[0] * 1e3:.1f} ms); peak memory {peak_gb:.2f} GB")
    print(f"[serve] greedy tokens of prompt 0: {generated[0].tolist()}")

    # checks of the main path's results (launches here are not counted)
    def consistency(cfg, params):
        """Relative errors of flash vs naive prefill and of prefill + one decode
        vs forward's last logits, for the flash and (as a control) naive prefill."""
        out = {}
        lg, caches = {}, {}
        for impl in ("flash", "naive"):
            lg[impl], caches[impl] = make_prefill_step(
                cfg, StepSettings(attn_impl=impl), cache_len=cache_len)(params, batch)
        out["flash_vs_naive_prefill"] = rel(torch, lg["flash"], lg["naive"])
        # layer 0's keys and values precede any attention: equal bits
        out["layer0_cache_equal"] = all(torch.equal(caches["flash"][n][0], caches["naive"][n][0])
                                        for n in ("k", "v"))
        nxt = lg["flash"][:, -1].argmax(-1, keepdim=True)
        with torch.no_grad():
            full, _ = api.forward(cfg, params, {"tokens": torch.cat([batch["tokens"], nxt], 1)})
        for impl in ("flash", "naive"):
            dec, _ = make_decode_step(cfg)(params, caches[impl], nxt, S)
            out[f"{impl}_prefill_decode_vs_forward"] = rel(torch, dec[:, 0], full[:, -1])
        return out

    check(torch.equal(prefill(params, batch)[0], prefill_logits), "prefill is not deterministic")
    bf16 = consistency(cfg, params)
    check(bf16["layer0_cache_equal"], "layer-0 cache differs between flash and naive prefill")
    print("[check] bf16, reported " + json.dumps(bf16))
    # In bf16 at full width the two mathematically equal naive paths (the control)
    # already differ by about the 0.02 limit, so the limits are held in fp32 compute,
    # where the same comparisons must agree to rounding.
    cfg32 = cfg.replace(compute_dtype="float32")
    params32 = api.init_params(cfg32, 0)
    fp32 = consistency(cfg32, params32)
    del params32
    print(f"[check] fp32, limit {FP32_TOL} " + json.dumps(fp32))
    for key in ("flash_vs_naive_prefill", "flash_prefill_decode_vs_forward"):
        check(fp32[key] < FP32_TOL, f"fp32 {key} rel {fp32[key]} >= {FP32_TOL}")
    check(fp32["layer0_cache_equal"], "fp32 layer-0 cache differs")
    torch.cuda.empty_cache()

    nxt = prefill_logits[:, -1].argmax(-1, keepdim=True)
    for label, fn in (("prefill", lambda: prefill(params, batch)),
                      ("decode", lambda: decode(params, cache, nxt, S))):
        print(f"[profile] {label} " + json.dumps(device_breakdown(torch, fn)))
    del cache

    # 5. the batched server at full width (prefills through decode steps, as in the
    #    reference: no flash launches on this path)
    fa.launches = 0
    srv = BatchedServer(cfg, params, max_batch=4, cache_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8), 8) for i in range(4)]
    t0 = time.perf_counter()
    srv.run(reqs)
    torch.cuda.synchronize()
    srv_s = time.perf_counter() - t0
    check(all(r.done and len(r.generated) == 8 for r in reqs), "server left requests unfinished")
    print(f"[server] 4 requests x 8 new tokens in {srv_s:.2f}s "
          f"({32 / srv_s:.1f} tok/s), flash launches {fa.launches}; "
          f"req 0 -> {reqs[0].generated}")

    # 6. results
    kernels = [dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:30",
                    launches=main_launches, max_abs_err=path["max_abs_err"], ms=path["kernel_ms"],
                    plain_ms=path["plain_ms"], bound_ms=path["bound_ms"],
                    bound_by=path["bound_by"], library_ms=path["library_ms"])]
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
