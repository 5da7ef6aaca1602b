#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card
    python3 chip_smoke.py --only kernel   # phases 1-3 alone: build and check the kernels
    python3 chip_smoke.py --only train    # phases 1-2, then 13-16 and 19 (training, [shard])

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device  — the card's name and power limit, as nvidia-smi reports them
  2. build   — nvcc builds every kernel from src/repro_torch/csrc into build/repro_torch,
               one nvcc per source, all started together
  3. kernels — each kernel against its plain PyTorch version on the card, at the
               reference's test shapes (the tests' tolerances) and at every serving
               path's shape; kernel, plain, library and bound times
               K1 flash_attention: bf16 path shapes element by element within two
               bf16 rounding steps (chatglm3-6b's; hymba-1.5b's with windows 1024
               and 0, at 4 rows and at [dryrun]'s 2 rows of rank 0 of (2, 4);
               h2o-danube-3-4b's at head dim 120 and mixtral-8x22b's, both with
               window 4096; gemma3-4b's at head dim 256 with windows 1024 and 0;
               qwen2-vl-2b's; head dim 192, which TMA zero-pads to 256); fp32 path
               shapes max abs error 2e-5 (gemma3-4b's fp32 check, and hymba-1.5b's
               with windows 1024 and 0 as [dryrun]'s fp32 mesh prefill runs them);
               and the 3xTF32 kernel at head dims 64, 120, 128, 192 and 256 with and
               without a window (S not a multiple of a tile), head dim 100 (4-byte
               copies) and a q_offset with a window, 2e-5;
               each case names the kernel that ran (tensor_core: bf16 by wgmma;
               tensor_core_fp32: fp32 in 3xTF32) and its achieved TFLOP/s; the plain
               version of the largest shapes runs one (batch, KV head) slice at a time
               K2 mamba_scan, both entry points: max abs error 1e-4 for y and the
               final state, at the reference's cases and falcon-mamba-7b's and
               hymba-1.5b's shapes (and hymba-1.5b's on rank 0 of (2, 4), 800 of its
               3200 channels, as [dryrun] runs it): the unfused scan on a_bar/bx, and
               the fused one from delta, x (bf16 and fp32), A, B and C, also at
               shapes that take its chunked-time branch (small B x Di, S not a
               multiple of the chunk)
  4-11. the models at full width with seed-0 random bf16 weights, one table row
               each (MODELS): prefill through make_prefill_step(attn_impl="flash"),
               16 greedy make_decode_step steps (qwen2-vl-2b's with [3, B, 1] m-rope
               ids), each kernel's launches per prefill asserted (K1's by kernel
               too), the cache's shapes and dtypes against api.cache_specs, a
               profiler breakdown of one prefill and one decode step, BatchedServer
               with 4 requests; then prefill + one decode against forward's last
               logits (and the flash prefill against the naive one, with naive
               prefill + decode vs forward as the equal-maths control), asserted in
               fp32 compute (relative error < 2e-5) and reported in bf16, at a length
               past the model's window; MoE at the no-drop capacity
               4. chatglm3-6b (dense, 28 layers): 4 x 1024, 28 K1 launches per prefill
               5. falcon-mamba-7b (ssm, 64 layers): 4 x 1024, 64 fused K2 and no K1;
                  the profile's elementwise ms beside K2's
               6. hymba-1.5b (hybrid, 32 layers, windows of 1024 but in layers
                  0/15/31): 4 x 2048, 32 K1 and 32 fused K2
               7. h2o-danube-3-4b (dense, 24 layers, window 4096, head dim 120):
                  2 x 8192, 24 tensor-core K1; checks at 1 x 4352
               8. gemma3-4b (dense, 34 layers, sandwich norm, GeGLU, windows of 1024
                  with every sixth layer global, head dim 256): 4 x 2048, 34 tensor-core
                  K1 and no fp32 K1; checks at 2 x 2048
               9. qwen2-vl-2b (vlm, 28 layers, m-rope): 4 x 2048 of which 512 patch
                  embeddings, 28 tensor-core K1
               10. mixtral-8x22b (moe, 8 of its 56 layers, 8 experts top-2, window
                  4096): 2 x 8192, 8 tensor-core K1; checks at 1 x 4352, fp32 at 2 layers
               11. whisper-tiny (encdec, 4 + 4 layers, learned positions, tied head):
                  prefill 4 x 64 tokens over 1500 frames through make_prefill_step, no
                  kernel launched (every encdec attention is `auto`, as in the
                  reference); no BatchedServer, which refuses encdec as the reference's
                  serve driver does; prefill + decode vs forward in fp32
  12. ring    — h2o-danube-3-4b at full width, window cut to 64, 2 layers: ring-cache
               decode against full-cache decode for 80 steps, fp32 (< 2e-5 once wrapped)
  13-16. training at full width (TRAINS), fp32 master weights, Trainer with
               StepSettings(accum=2, remat="dots"): the eval step at the step-0 params,
               naive and flash (flash launches K1 once per attention layer and must
               agree with naive within the bf16 limit), a profiler breakdown of one
               train step; then, under torch.use_deterministic_algorithms, a straight
               run of 4 steps (its launches must all be 0: no kernel trains), and 2
               steps + a checkpoint under build/ + a resume for 2 more, whose losses and
               grad norms must equal the straight run's bit for bit; every loss and grad
               norm finite, the step-0 loss equal to the naive eval's within the bf16
               limit, the resumed checkpoint's count 4 and its params moved.  Step ms,
               tokens/s, peak GB and the model-FLOP share of the data-sheet peak.  The
               SSM and hybrid rows then run again with `ssm_inloop` (each chunk of the
               training scan discretised inside its checkpoint): the naive and flash
               evals, a profile of one train step and a straight run of 4 steps under
               deterministic algorithms; every eval loss and the step-0 loss equal to
               the flag-off run's bit for bit, every later loss and grad norm within
               INLOOP_REL, no launch in the steps, and one `[train] <arch> inloop`
               line of step ms, tokens/s, peak GB and model-FLOP share off and on
               13. qwen2-vl-2b (vlm, 1.78e9 params): 4 x 2048 with 512 patch embeddings,
                   28 tensor-core K1 per flash eval
               14. whisper-tiny: 8 x 448 tokens over 1500 frames, no kernel
               15. hymba-1.5b (hybrid, 8 of its 32 layers, for time: see TRAINS):
                   4 x 2048, 8 tensor-core K1 and 8 fused K2 per flash eval
               16. falcon-mamba-7b (ssm, 4 of its 64 layers, for time): 4 x 2048, 4
                   fused K2 per flash eval and no K1
  17. trace   — the sharded train step's collective capture at full width:
               chatglm3-6b (28 layers; its 2 kv heads do not divide `model`, so the
               k/v projections are gathered before their heads split) as rank 0 of
               a (2, 4) ("data", "model") DeviceMesh under the fake process group,
               on the card: fp32 master weights and moments placed by the rules,
               accum 2, remat "full", a global batch of 8 x 2048 (4 x 2048 on the
               rank).  The (semantic, kind, link) table with multiplicity, bytes
               and H100 cost-model time on the one-node mesh (nvlink), and again
               with `data` on InfiniBand; the rank's step ms with the capture on
               and off (in turns), peak GB, and the roofline's dominant term.
               Checks: sites > 0, grad_sync and attention present, the grad_sync
               bytes over `data` equal to the gradients' bytes with `data`
               replicated (worked out from the placements) once per micro-batch
               (the gradients are synchronised in backward), no K1 or K2 launch
  18. ingest  — live ingest of the card's own captures (host code): the same step
               captured 3 more times, each trace written with dump.write_capture to
               build/chip_smoke_session/dump/host000_step00{k}.jsonl as the step ends,
               while a WatchDaemon polls the directory from a background thread
               (settle 0.25 s); every file ingested ok (none salvaged or
               quarantined), each ingested trace identical to its in-memory one;
               `run(once=True)`'s JSON and HTML reports byte for byte against batch
               from_captures + report and against `session ingest` + `session
               report`; the six corrupt modes on copies of the first capture through
               `session ingest --errors salvage` (exit 3; binary quarantined, the
               rest salvaged); bytes per file, host seconds to write, read + parse
               and fold (per file and per site), the step-end-to-ingest latency and
               the daemon's rounds; no K1 or K2 launch
  19. shard   — Trainer(mesh=(1, 1)) on a real nccl group of world size 1 against
               the straight Trainer: qwen2-vl-2b at the train phase's shape, 2
               steps each, deterministic algorithms; losses and grad norms within
               a relative 1e-3 (the first loss equal), no kernel launched; and a
               third, straight run with the mesh's vocab-parallel loss formulation
               (the one mesh-only difference in the model's maths), reported
               against the mesh run bit for bit; then the same pair (mesh and
               straight, the same checks) for hymba-1.5b at full width, 4 of its 32
               layers, with `ssm_inloop`: the in-loop scan per rank under local_map
  20. moe     — one qwen3-moe-235b-a22b MoE layer at full width (d_model 4096, 128
               experts, top-8, moe_d_ff 1536), fp32, no-drop capacity factor 16, x of
               2 x 1024 from seed 0, on a one-rank nccl mesh: apply_moe with the sort
               dispatch against the einsum dispatch, output relative 1e-4, aux 1e-5, and
               after a backward of mean(y^2) + 0.01 * aux every gradient finite, non-zero
               and within a relative 1e-4; no kernel launched; each one's forward +
               backward ms (CUDA events) and the peak GB it adds
  21. moe-trace — qwen3-moe-235b-a22b at full width, 2 of its 94 layers, as rank 0
               of (2, 4) under the fake process group: fp32 master weights and moments,
               accum 2, remat "full", global batch 8 x 2048, captured once with each
               dispatch (a warm-up step, the captured step, a step with the capture
               off); checks: a moe_combine all-reduce on nvlink.model in the sort's
               trace, no all-to-all in either, grad_sync in both, no launch
  22. session — the back half on the card's own traces: one TraceSession of [trace]'s
               chatglm3-6b trace, the same re-priced with `data` on InfiniBand and the
               two [moe-trace] captures, saved as json, npz and uncompressed npz under
               build/chip_smoke_session/ and reloaded (the last with mmap) with equal
               labels, totals, table and site counts; einsum diffed against sort by
               (semantic, kind, link); commcheck and the detectors over all four (the
               IB re-pricing raises cross_node_bulk with the saving `ib_saving` gives);
               the what-if sweep (ib-2x only for the IB variant); HTML and JSON reports;
               host seconds of each step and the files' sizes
  23. dryrun  — the dry-run (launch/dryrun.py) on the card: (a) fake against real:
               [trace]'s chatglm3-6b step traced again by dryrun.trace_cell on fake
               tensors, and hymba-1.5b's prefill (4 x 2048, bf16, attn "flash") as rank
               0 of (2, 4) under the fake group, run for real (K1 and K2 launched once a
               layer on the rank's shards) and on fake tensors (no launch): equal site
               tables (op, kind, groups, operand bytes, dtype, multiplicity) and FLOPs;
               each prints its fake peak beside the real max_memory_allocated and
               analytic_memory_bytes (no limit); (b) the same prefill on a one-rank nccl
               mesh (K1 and K2 under local_map) against the straight prefill, logits and
               every cache leaf: fp32 relative FP32_TOL, bf16 max abs 1e-2 and two bf16
               steps; (c) DRYRUN_CELLS on the production mesh, (32, 8) and llama3-405b
               train_4k on (2, 32, 8), fake tensors on the card at full width and full
               depth but llama3-405b's and qwen3-moe-235b-a22b's train_4k (2 layers, the
               8 micro-batches of their H100 rows), in DRYRUN_WORKERS processes: one line per cell
               (fake-run seconds, collectives, bytes, the roofline's terms, dominant,
               mfu_bound, the memory model against 80 GB, fake peak), no decode cell
               gathering its cache, no launch, and a `[dryrun] result` line
  24. collectives — each all-reduce of distributed/algorithms.py (builtin: c10d's; ring,
               rsag, recursive doubling) as rank 0 of an (8,) ("data",) DeviceMesh under
               the fake process group, on the card, at 4 MiB and 100 MB fp32 and at
               chatglm3-6b's whole bf16 gradient (6.24e9 parameters, 12.49 GB): the
               capture against the reference's signature written out here (ring 7 + 7
               permutes of the padded payload / 8 with pairs (i, i+1 mod 8); rsag one
               reduce-scatter and one all-gather, each of the padded payload (an
               all-gather's operand is its gathered bytes); recursive doubling 3 permutes of the
               payload with pairs i ^ 2^k; builtin one all-reduce; every site on
               nvlink.data with group size 8), finite outputs, no kernel launched; the
               rank-local ms (CUDA events), the modelled us on NVLink and with `data` on
               InfiniBand, and costmodel.allreduce_time's closed form beside each
  25. pipeline — distributed/pipeline.py's GPipe with chatglm3-6b at full width (d_model
               4096, 32 heads, 2 KV heads, head dim 128), bf16, seed-0 weights, each stage
               its layers through transformer.apply_layers(attn_impl="flash") on plain
               local tensors: (a) P = 4 over (4,) ("model",), rank 0 under the fake group
               (stage 0: layers 0-6, its rows a DTensor Shard(0) on `model`), M = 8
               micro-batches of 1 x 2048, captured: 7 x 11 = 77 K1 launches, 10
               pipeline_hop permutes of 16 MiB with pairs (0,1), (1,2), (2,3) and
               semantic pipeline, one all-reduce of 128 MiB; the tick ms, the bubble
               fraction, the hop's modelled us on NVLink and with `model` on InfiniBand;
               (b) P = 1 on a one-rank nccl mesh, all 28 layers one stage, M = 4: equal
               bit for bit to the straight apply_layers per micro-batch, 112 K1 launches
  26. a JSON line of every kernel: K1's bf16 wgmma kernel (at chatglm3-6b's shape; its
               variants at gemma3-4b's global and hymba-1.5b's rank shard shapes), K1's
               3xTF32 fp32 kernel (at hymba-1.5b's fp32 mesh prefill's global shape; also
               gemma3-4b's fp32 check's and the windowed one), and K2 (the fused entry
               point at falcon-mamba-7b's shape; both entry points as variants), each
               with its main-path launches; then the JSON result line.
With `--only kernel` it stops after phase 3 and prints no result line; with `--only
train` it builds the kernels, runs the train phases and [shard], and prints no
result line.
Each model's weights are freed before the next model is built.  Without a CUDA
device, or outside a checkout of the repo, it exits non-zero and prints no result.
"""
import argparse
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from collections import namedtuple
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM data sheet, dense
PEAK_3XTF32 = 495e12 / 3      # three TF32 products (dense 495 TFLOP/s) for each fp32 one
PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3, bytes/s
FP32_TOL = 2e-5       # relative; the port's fp32 parity tolerance against the reference
# bf16 outputs, element by element: kernel and plain version both compute in fp32
# and round once to bf16, so they may differ by one bf16 step, at most 2^-7 of the
# value (plus the fp32 difference near zero, ~1e-6 in the fp32 cases); the limit
# is two such steps.  This is the bf16 path shapes' limit: a max abs one cannot
# be, since one step is 2^-6 at an output in [2, 4) (the first causal row's
# output is its value row, |v| up to ~4 at these sizes)
BF16_STEP, BF16_FLOOR, BF16_MAX_STEPS = 2.0 ** -7, 1e-5, 2.0
PER_ELEMENT = None      # a case's tol: no max abs limit, the per-element one alone
# B, H, K, S, D, causal, window, dtype, tol: the serving paths' shapes in the model
# layout (chatglm3-6b's prefill of 4 x 1024; hymba-1.5b's of 4 x 2048 with its
# windowed and global layers; h2o-danube-3-4b's 2 x 8192 at head dim 120 and
# mixtral-8x22b's, both with a window of 4096; gemma3-4b's 4 x 2048 at head dim
# 256, with its local and global layers; qwen2-vl-2b's 4 x 2048; hymba-1.5b's on
# rank 0 of (2, 4) in [dryrun]'s fidelity prefill, 2 rows, every head), limited per
# element; and the reference's FLASH_CASES (tests/test_kernels.py) with their
# tolerances
PATH_SHAPES = [(4, 32, 2, 1024, 128, True, 0, "bfloat16", PER_ELEMENT),
               (4, 25, 5, 2048, 64, True, 1024, "bfloat16", PER_ELEMENT),
               (4, 25, 5, 2048, 64, True, 0, "bfloat16", PER_ELEMENT),
               (2, 32, 8, 8192, 120, True, 4096, "bfloat16", PER_ELEMENT),
               (2, 48, 8, 8192, 128, True, 4096, "bfloat16", PER_ELEMENT),
               (4, 8, 4, 2048, 256, True, 1024, "bfloat16", PER_ELEMENT),
               (4, 8, 4, 2048, 256, True, 0, "bfloat16", PER_ELEMENT),
               (4, 12, 2, 2048, 128, True, 0, "bfloat16", PER_ELEMENT),
               (2, 25, 5, 2048, 64, True, 1024, "bfloat16", PER_ELEMENT),
               (2, 25, 5, 2048, 64, True, 0, "bfloat16", PER_ELEMENT)]
# the plain version materialises [B, H, Sq, Skv] fp32 scores; above this many
# bytes it runs one (batch, KV head) slice at a time
PLAIN_SLICE_BYTES = 2 << 30
FLASH_CASES = [
    (1, 2, 2, 256, 128, True, 0, "float32", 2e-5),
    (2, 4, 2, 256, 128, True, 64, "float32", 2e-5),
    (1, 2, 1, 512, 128, False, 0, "float32", 2e-5),
    (1, 6, 3, 256, 256, True, 0, "float32", 2e-5),
    (1, 4, 4, 128, 128, True, 0, "bfloat16", 3e-2),
    (1, 2, 2, 384, 128, True, 128, "bfloat16", 3e-2),
]
# bf16 with a head dim above 128 runs the tensor-core kernel at 64 keys a KV tile
# (gemma3-4b's path shapes above): at the reference's small size, and at head dim
# 192 (TMA zero-pads it to 256 in shared memory) in the model layout, with S not a
# multiple of 64 and a window edge inside a tile, at the path limit
BF16_WIDE_CASE = (1, 4, 2, 256, 256, True, 0, "bfloat16", 3e-2)
BF16_PAD_CASE = (2, 8, 4, 1000, 192, True, 300, "bfloat16", PER_ELEMENT)
# fp32 runs the 3xTF32 tensor-core kernel: gemma3-4b's global layers at its fp32 check's
# 2 x 2048, and hymba-1.5b's layers with windows 1024 and 0 at 4 x 2048, as the
# [dryrun] fp32 prefill on a one-rank nccl mesh runs them; max abs error 2e-5
FP32_PATH_CASES = [(2, 8, 4, 2048, 256, True, 0, "float32", 2e-5),
                   (4, 25, 5, 2048, 64, True, 1024, "float32", 2e-5),
                   (4, 25, 5, 2048, 64, True, 0, "float32", 2e-5)]
# the 3xTF32 kernel at every head dim the models use, windowed in the model layout
# and not, with S not a multiple of a KV tile; head dim 100 (4-byte copies); a
# q_offset with a window: (case, layout, q_offset)
FP32_HEAD_DIM_CASES = (
    [((2, 4, 2, 300, d, True, 70, "float32", 2e-5), "bshd", 0) for d in (64, 120, 128, 192, 256)]
    + [((1, 4, 4, 333, d, False, 0, "float32", 2e-5), "bhsd", 0)
       for d in (64, 120, 128, 192, 256)]
    + [((1, 2, 1, 200, 100, True, 0, "float32", 2e-5), "bhsd", 0),
       ((2, 2, 2, 256, 128, True, 64, "float32", 2e-5), "bhsd", 100)])
# K2: B, S, Di, N — the reference's MAMBA_CASES (tests/test_kernels.py:69) and the
# shapes of the serving paths' prefills (falcon-mamba-7b 4 x 1024, hymba-1.5b
# 4 x 2048, and hymba-1.5b's on rank 0 of (2, 4): 2 rows, 800 of its 3200
# channels); the reference's tolerance
SCAN_CASES = [(1, 128, 64, 8), (2, 256, 128, 16), (1, 512, 256, 16), (1, 96, 64, 4)]
SCAN_PATH_SHAPES = [(4, 1024, 8192, 16), (4, 2048, 3200, 16), (2, 2048, 800, 16)]
# the fused K2's chunked-time branch: small B x Di, S not a multiple of the chunk
SCAN_CHUNKED_CASES = [(1, 1000, 96, 16), (2, 300, 64, 4), (1, 777, 40, 16), (3, 513, 100, 8)]
SCAN_TOL = 1e-4
SCAN_NO_LIBRARY = ("no single PyTorch call computes a linear recurrence with a "
                   "per-step readout (h_t = a_t*h_{t-1} + bx_t, y_t = <h_t, c_t>)")
# the full-width models, one at a time: arch, prefill batch and length, attention
# impls (the first serves, the others are compared with it), the consistency
# checks' batch and length, and each kernel's launches per prefill (K1's also by
# the kernel that ran; a count not named must stay 0); then, where cut, the
# depth of the whole row and of its fp32 check.  Each consistency length passes
# the model's window, so that the window masks in both the flash and naive paths
Model = namedtuple("Model", "arch B S impls check_shape per_prefill depth fp32_depth",
                   defaults=(None, None))
MODELS = [
    Model("chatglm3-6b", 4, 1024, ("flash", "naive"), (4, 1024),
          {"flash_attention": 28, "flash_attention/tensor_core": 28}),
    Model("falcon-mamba-7b", 4, 1024, ("flash",), (2, 512),
          {"mamba_scan": 64, "mamba_scan/fused": 64}),
    Model("hymba-1.5b", 4, 2048, ("flash", "naive"), (4, 2048),
          {"flash_attention": 32, "flash_attention/tensor_core": 32, "mamba_scan": 32,
           "mamba_scan/fused": 32}),
    Model("h2o-danube-3-4b", 2, 8192, ("flash", "naive"), (1, 4352),
          {"flash_attention": 24, "flash_attention/tensor_core": 24}),
    Model("gemma3-4b", 4, 2048, ("flash", "naive"), (2, 2048),
          {"flash_attention": 34, "flash_attention/tensor_core": 34}),
    Model("qwen2-vl-2b", 4, 2048, ("flash", "naive"), (4, 2048),
          {"flash_attention": 28, "flash_attention/tensor_core": 28}),
    # 8 of 56 layers: the full depth's ~282 GB of bf16 weights need the sharding slice
    Model("mixtral-8x22b", 2, 8192, ("flash", "naive"), (1, 4352),
          {"flash_attention": 8, "flash_attention/tensor_core": 8}, depth=8, fp32_depth=2),
    # S counts the decoder's prompt tokens; the encoder reads 1500 frames a row
    Model("whisper-tiny", 4, 64, ("auto",), (4, 64), {}),
]
# training at full width: arch, batch and sequence length, steps, the step of the
# checkpoint the resume starts from, each kernel's launches per flash eval (K1 one
# per attention layer, whisper's attention is always `auto`, so none; the fused K2
# one per SSM layer) and, where cut, the depth.  The SSM and hybrid rows are cut
# for time: their train step runs the plain chunked scan, whose many small ops
# leave it host-bound (on the H100 at 4 x 2048: hymba-1.5b 17.1 s a step at 32
# layers, 4.1 s at 8; falcon-mamba-7b 2.7 s at 4), and each row runs ~18 steps
# (falcon-mamba-7b's 64 layers would not fit 80 GB in any case: ~116 GB of fp32
# weights, gradients and AdamW moments)
Train = namedtuple("Train", "arch B S steps ckpt_at per_eval depth", defaults=(None,))
TRAINS = [Train("qwen2-vl-2b", 4, 2048, 4, 2,
                {"flash_attention": 28, "flash_attention/tensor_core": 28}),
          Train("whisper-tiny", 8, 448, 4, 2, {}),
          Train("hymba-1.5b", 4, 2048, 4, 2,
                {"flash_attention": 8, "flash_attention/tensor_core": 8, "mamba_scan": 8,
                 "mamba_scan/fused": 8}, depth=8),
          Train("falcon-mamba-7b", 4, 2048, 4, 2, {"mamba_scan": 4, "mamba_scan/fused": 4},
                depth=4)]
# the SSM and hybrid rows run again with `ssm_inloop`: its evals and step-0 loss
# equal the flag-off run's bit for bit, every later loss and grad norm within this
# relative limit (the in-loop backward sums A's gradient chunk by chunk)
INLOOP_REL = 1e-4
# bf16 results against each other: the parity tests' bf16 limit (relative)
BF16_REL = 0.02
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
# h2o-danube-3-4b at full width with its window cut to 64 and 2 layers: ring-cache
# decode against full-cache decode over 80 steps, fp32 compute
RING = dict(arch="h2o-danube-3-4b", window=64, layers=2, B=2, steps=80)
N_DECODE = 16
# the traced step: chatglm3-6b at full width on a (2, 4) mesh under the fake
# process group, global batch x sequence, accum 2, remat "full"
TRACE = dict(arch="chatglm3-6b", mesh=(2, 4), B=8, S=2048)
# the one-card mesh against the straight Trainer: the first TRAINS row's shape;
# then hymba-1.5b at full width and 4 of its 32 layers with `ssm_inloop` (the
# in-loop scan per rank under local_map) at the same shape
SHARD_REL = 1e-3
SHARD_INLOOP = dict(arch="hymba-1.5b", layers=4)
# one qwen3-moe-235b-a22b MoE layer at full width (d_model 4096, 128 experts, top-8,
# moe_d_ff 1536), fp32, at the no-drop capacity E/k, on a one-rank nccl mesh: the
# sort dispatch against the einsum dispatch.  Its sort buffer [E*C + 1, D] with
# C = k*T*16/E = T = 2048 is 262145 x 4096 fp32, 4.29 GB, as is y_e [E, C, D];
# the einsum dispatch's [G, Sg, k, E, C] slot table is 4 x 512 x 8 x 128 x 512,
# 4.29 GB in fp32 (8.59 GB as one_hot's int64)
MOE = dict(arch="qwen3-moe-235b-a22b", B=2, S=1024, rel=1e-4, aux=1e-5, grad_rel=1e-4)
# the sharded train step of qwen3-moe-235b-a22b at full width and 2 of its 94
# layers, captured with each dispatch as rank 0 of (2, 4) under the fake group
MOE_TRACE = dict(arch="qwen3-moe-235b-a22b", layers=2, mesh=(2, 4), B=8, S=2048)
# the back half's files, under the git-ignored build/
SESSION_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_session"
# [ingest]: capture-on steps of [trace]'s step written as dumps, the daemon's clock
INGEST = dict(steps=3, settle_s=0.25, interval_s=0.05)
INGEST_DIR = SESSION_DIR / "dump"
# each corrupt mode's ingest status under --errors salvage, as the CPU tests hold it
# (tests/test_torch_chaos.py): every damage but undecodable bytes is salvaged
CORRUPT_STATUS = {"truncate": "salvaged", "splice": "salvaged", "dup_lines": "salvaged",
                  "drop_lines": "salvaged", "mangle_rg": "salvaged", "binary": "quarantined"}
# [dryrun]: the fidelity prefill (hymba-1.5b, bf16, K1 and K2 on each rank's shards)
# as rank 0 of (2, 4) under the fake group, and the same prefill on a one-rank nccl
# mesh against the straight one-card prefill, in fp32 (relative FP32_TOL) and in
# bf16 (max abs BF16_MESH_ABS and BF16_MAX_STEPS steps per element); K1 launches
# once and K2 once per layer in each real prefill
FIDELITY = dict(arch="hymba-1.5b", mesh=(2, 4), B=4, S=2048,
                per_prefill={"flash_attention": 32, "flash_attention/tensor_core": 32,
                             "mamba_scan": 32, "mamba_scan/fused": 32})
BF16_MESH_ABS = 1e-2
# the dry-run's cells on the production mesh (arch, shape, multi-pod, layers), full
# width on fake tensors on the card, full depth but where layers are named: every
# family and every shape kind, with llama3-405b and qwen3-moe-235b-a22b train_4k (the
# 8 micro-batches of their H100 rows) at 2 of their 126 and 94 layers, whose full
# depth takes tens of minutes a cell (PERF.md); the full sweep is the CLI's.
# DRYRUN_WORKERS processes run them, each with its own fake process group
DRYRUN_CELLS = [("llama3-405b", "train_4k", False, 2), ("qwen3-moe-235b-a22b", "train_4k", False, 2),
                ("chatglm3-6b", "prefill_32k", False, None), ("chatglm3-6b", "decode_32k", False, None),
                ("falcon-mamba-7b", "prefill_32k", False, None),
                ("falcon-mamba-7b", "long_500k", False, None),
                ("hymba-1.5b", "decode_32k", False, None), ("hymba-1.5b", "long_500k", False, None),
                ("mixtral-8x22b", "decode_32k", False, None), ("gemma3-4b", "long_500k", False, None),
                ("h2o-danube-3-4b", "long_500k", False, None),
                ("qwen2-vl-2b", "decode_32k", False, None),
                ("whisper-tiny", "train_4k", False, None), ("whisper-tiny", "decode_32k", False, None),
                ("llama3-405b", "train_4k", True, 2)]
DRYRUN_WORKERS = 4
# [collectives]: each all-reduce algorithm as rank 0 of an (8,) ("data",) mesh under
# the fake process group, at the reference bench's fp32 payloads (4 MiB, 100 MB) and at
# GRAD_ARCH's whole bf16 gradient (its parameter count); (elements, dtype) per row,
# None for the gradient's count.  The closed form beside each algorithm's model
COLLECTIVES = dict(mesh=(8,), sizes=[(1 << 20, "float32"), (25_000_000, "float32"),
                                     (None, "bfloat16")], grad_arch="chatglm3-6b", iters=3)
CLOSED_FORM = {"builtin": "ring", "ring": "ring", "rsag": "reduce_scatter_allgather",
               "recursive_doubling": "recursive_doubling"}
# [pipeline]: chatglm3-6b at full width in bf16 with seed-0 weights, each stage its
# share of the layers through transformer.apply_layers(attn_impl="flash"): (a) P
# stages over (P,) ("model",), rank 0 under the fake group, M micro-batches of mb x S;
# (b) one stage of every layer on a one-rank nccl mesh, M_ONE micro-batches, against
# the straight layers bit for bit
PIPELINE = dict(arch="chatglm3-6b", P=4, M=8, mb=1, S=2048, M_ONE=4, iters=2)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def zero_counts(counters):
    """Set every launch count to 0: each kernel module's total and its per-kernel counts."""
    for mod in counters.values():
        mod.launches = 0
        for key in getattr(mod, "kernel_launches", {}):
            mod.kernel_launches[key] = 0


def read_counts(counters):
    """{module: launches} and {module/kernel: launches} for modules with several kernels."""
    out = {}
    for name, mod in counters.items():
        out[name] = mod.launches
        for key, n in getattr(mod, "kernel_launches", {}).items():
            out[f"{name}/{key}"] = n
    return out


def nvidia_smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def build_all(build, sources):
    """Run every kernel's build at once (one nvcc each); return {name: (s, report)}.

    A failed build raises here, when its result is read."""
    def timed(source):
        t0 = time.perf_counter()
        report = build.build(source)
        return time.perf_counter() - t0, report

    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(timed, source) for name, source in sources.items()}
        return {name: f.result() for name, f in futures.items()}


def spilling(report):
    """The kernels whose ptxas report (-Xptxas -v) shows spill stores or loads."""
    out, entry = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                                                line):
            out.append(entry)
    return out


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


def device_breakdown(torch, fn, host=False):
    """Device time of fn() by kernel group, from a torch.profiler trace.

    busy_ms sums kernel durations (one stream: they do not overlap); idle is
    the share of the span from the first kernel's start to the last one's end
    in which no kernel ran; top_other lists the five kernels of the "other"
    group with the most time.  With `host`, also the five host-side entries
    with the most self CPU time (ms; the profiler's own cost inflates them).
    The device side reads the profiler's raw events: building its event
    tree (`prof.events()`, which `host` needs) takes tens of seconds for a
    step of ~10^5 ops, such as an SSM train step.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {"flash_attention": 0.0, "mamba_scan": 0.0, "matmul": 0.0, "elementwise": 0.0,
              "other": 0.0}
    starts, ends, other = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        dur = e.duration_ns() / 1e6
        full = e.name()
        name = full.lower()
        if "flash_fwd" in name:     # flash_fwd_wgmma_kernel and flash_fwd_tf32x3_kernel
            groups["flash_attention"] += dur
        elif "mamba_scan" in name:        # both K2 kernels
            groups["mamba_scan"] += dur
        elif any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
            groups["matmul"] += dur
        elif "elementwise" in name:       # PyTorch's elementwise kernels
            groups["elementwise"] += dur
        else:
            groups["other"] += dur
            other[full[:80]] = other.get(full[:80], 0.0) + dur
        starts.append(e.start_ns())
        ends.append(e.start_ns() + e.duration_ns())
    check(starts, "profiler saw no device activity")
    busy = sum(groups.values())
    span = (max(ends) - min(starts)) / 1e6
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    out = dict(busy_ms=busy, span_ms=span, idle_share=1 - busy / span,
               **{f"{k}_ms": v for k, v in groups.items()},
               top_other=[[k, round(v, 3)] for k, v in top])
    if host:
        cpu = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:5]
        out["host_top"] = [[e.key[:60], round(e.self_cpu_time_total / 1e3, 3), e.count]
                           for e in cpu]
    return out


def plain_version(torch, ref, q, k, v, kw):
    """K1's plain version on q [B,H,Sq,D], k/v [B,K,Skv,D]; one (batch, KV head)
    slice at a time when the whole call's fp32 scores pass PLAIN_SLICE_BYTES."""
    B, H, Sq, _ = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if B * H * Sq * Skv * 4 <= PLAIN_SLICE_BYTES:
        return ref.flash_attention_ref(q, k, v, **kw)
    G = H // K
    out = torch.empty_like(q)
    for b in range(B):
        for kv in range(K):
            heads = slice(kv * G, (kv + 1) * G)
            out[b:b + 1, heads] = ref.flash_attention_ref(
                q[b:b + 1, heads], k[b:b + 1, kv:kv + 1], v[b:b + 1, kv:kv + 1], **kw)
    return out


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
    variant = fa.kernel_for(dt, D)
    before = dict(fa.kernel_launches)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check(fa.kernel_launches[variant] == before[variant] + 1,
          f"{case}: the {variant} kernel did not count the launch")
    plain_fn = lambda: plain_version(torch, ref, q, k, v, kw)  # noqa: E731
    plain = plain_fn()
    diff = (out.float() - plain.float()).abs()
    err = float(diff.max())
    check(torch.isfinite(out).all().item(), f"non-finite kernel output {case}")
    check(tol is PER_ELEMENT or err < tol,
          f"kernel vs plain {case} q_offset={q_offset}: {err} >= {tol}")
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
    plain_ms = cuda_ms(torch, plain_fn, iters if S * Sq * B * H < (1 << 30) else 2)
    library_ms = cuda_ms(torch, lib, iters)
    flops = 4 * D * B * H * int(mask.sum())                 # QK^T and PV on unmasked pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    # fp32 runs on the tensor cores as 3xTF32: its bound is at that rate, and the
    # CUDA cores' FFMA bound is kept beside it as `bound_simt_ms`
    t_ops = flops / (PEAK_3XTF32 if dtype == "float32" else PEAK_FLOPS[dtype])
    t_bytes = nbytes / PEAK_BYTES
    return dict(case=list(case[:8]), q_offset=q_offset, layout=layout, variant=variant,
                tflops=flops / kernel_ms / 1e9, max_abs_err=err,
                tol=tol, bf16_steps=steps, median_abs_out=float(plain.float().abs().median()),
                library_err=lib_err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_simt_ms=(1e3 * max(flops / PEAK_FLOPS["float32"], t_bytes)
                               if dtype == "float32" else None),
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def scan_case(torch, ms, ref, case, seed):
    """K2 vs its plain version on one shape, with the final state; inputs made as
    the reference's kernel tests make them (a = exp(-|z|), bx = 0.1 z, c = z)."""
    B, S, Di, N = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((B, S, Di, N), generator=gen, device="cuda").abs_().neg_().exp_()
    bx = torch.randn((B, S, Di, N), generator=gen, device="cuda").mul_(0.1)
    c = torch.randn((B, S, N), generator=gen, device="cuda")
    y, h = ms.mamba_scan(a, bx, c, return_state=True)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()                                 # the plain loop runs once per case
    plain_y, plain_h = ref.mamba_scan_ref(a, bx, c, return_state=True)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((y - plain_y).abs().max())
    h_err = float((h - plain_h).abs().max())
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all()),
          f"non-finite scan output {case}")
    check(err < SCAN_TOL and h_err < SCAN_TOL,
          f"scan kernel vs plain {case}: y {err}, h_S {h_err} >= {SCAN_TOL}")
    iters = 20 if a.numel() < (1 << 26) else 10
    kernel_ms = cuda_ms(torch, lambda: ms.mamba_scan(a, bx, c, return_state=True), iters)
    flops = 4 * a.numel()                          # h: mul + add; y: mul + add, per (b,t,d,n)
    nbytes = sum(t.numel() * 4 for t in (a, bx, c, y, h))
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return dict(case=list(case), max_abs_err=err, h_max_abs_err=h_err, tol=SCAN_TOL,
                median_abs_out=float(plain_y.abs().median()), kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def fused_scan_case(torch, ms, ref, case, seed, x_dtype="bfloat16"):
    """K2's fused entry point vs its plain version on one shape, with the final
    state: delta = softplus(z - 1), A = -(1..N) per channel (the model's a_log
    init) times exp(0.1 z), x in `x_dtype`, B and C = z.  Also which chunk count
    the kernel took."""
    B, S, Di, N = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    delta = torch.nn.functional.softplus(z(B, S, Di) - 1.0)
    a = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32) * (0.1 * z(Di, N)).exp()
    x = z(B, S, Di).to(getattr(torch, x_dtype))
    b, c = z(B, S, N), z(B, S, N)
    y, h = ms.mamba_scan_fused(delta, x, a, b, c, return_state=True)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()                                 # the plain loop runs once per case
    plain_y, plain_h = ref.mamba_scan_fused_ref(delta, x, a, b, c, return_state=True)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((y - plain_y).abs().max())
    h_err = float((h - plain_h).abs().max())
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all()),
          f"non-finite fused scan output {case}")
    check(err < SCAN_TOL and h_err < SCAN_TOL,
          f"fused scan kernel vs plain {case} x {x_dtype}: y {err}, h_S {h_err} >= {SCAN_TOL}")
    iters = 20 if B * S * Di * N < (1 << 26) else 10
    kernel_ms = cuda_ms(torch, lambda: ms.mamba_scan_fused(delta, x, a, b, c,
                                                            return_state=True), iters)
    # per (b, t, d, n): delta*A, exp, the recurrence's mul and add, *B, the readout's
    # mul and add; per (b, t, d): delta*x
    flops = 7 * B * S * Di * N + B * S * Di
    nbytes = sum(t.numel() * t.element_size() for t in (delta, x, a, b, c, y, h))
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    chunks = ms.scan_chunks(B, S, Di, N, torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(case=list(case), x_dtype=x_dtype, chunks=chunks, max_abs_err=err,
                h_max_abs_err=h_err, tol=SCAN_TOL,
                median_abs_out=float(plain_y.abs().median()), kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def prefix(batch, n):
    """A batch's first n positions: tokens, and for a vlm batch the patches
    (all in front) and [3, B, n] m-rope ids."""
    n_img = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    out = dict(batch, tokens=batch["tokens"][:, :n - n_img])
    if "positions" in batch:
        out["positions"] = batch["positions"][:, :, :n]
    return out


def decode_ids(torch, cfg, tokens, pos):
    """A decode step's rope ids: [3, B, 1] of pos for m-rope, else none (the step
    makes [B, 1])."""
    if cfg.rope != "mrope":
        return {}
    return {"positions": torch.full((3, tokens.shape[0], 1), pos, dtype=torch.int32,
                                    device=tokens.device)}


def main_path(rt, cfg, params, B, S, n_decode, attn_impl):
    """The serving path a user drives: 2 prefills (the first warms up), then n_decode
    greedy decode steps.  Every launch counter is zeroed just before and read just
    after.  Returns timings, launches per kernel and what the checks need."""
    torch = rt.torch
    cache_len = S + n_decode
    batch = rt.api.demo_batch(cfg, B, S, seed=0)
    prefill = rt.make_prefill_step(cfg, rt.StepSettings(attn_impl=attn_impl),
                                   cache_len=cache_len)
    decode = rt.make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rt.counters)
    prefill_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    prefill_logits = logits.clone()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    generated = [tok]
    decode_s = []
    for i in range(n_decode):                      # the first step is timed apart (cold)
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok, S + i, **decode_ids(torch, cfg, tok, S + i))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        generated.append(tok)
        if i in (0, n_decode - 1):
            torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
    launches = read_counts(rt.counters)
    generated = torch.cat(generated, dim=1)
    check(bool(torch.isfinite(prefill_logits).all()) and bool(torch.isfinite(logits).all()),
          f"{cfg.name}: non-finite logits")
    check(prefill_logits.shape == (B, 1, cfg.vocab_size), f"logits {prefill_logits.shape}")
    check(bool(((generated >= 0) & (generated < cfg.vocab_size)).all()), "token out of range")
    warm_s = sum(decode_s[1:])
    res = dict(arch=cfg.name, layers=cfg.num_layers, B=B, S=S,
               prefill_ms=prefill_s[1] * 1e3, prefill_tok_s=B * S / prefill_s[1],
               cold_prefill_ms=prefill_s[0] * 1e3, decode_ms=warm_s * 1e3 / (n_decode - 1),
               decode_tok_s=B * (n_decode - 1) / warm_s, cold_decode_ms=decode_s[0] * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
               tokens0=generated[0].tolist())
    return res, batch, prefill, decode, prefill_logits, cache


def run_server(rt, cfg, params):
    """BatchedServer at full width, 4 requests x (8 prompt + 8 new) tokens; it prefills
    through decode steps, as the reference's does, so it launches neither kernel."""
    zero_counts(rt.counters)
    srv = rt.BatchedServer(cfg, params, max_batch=4, cache_len=64)
    rng = rt.np.random.default_rng(0)
    reqs = [rt.Request(i, rng.integers(0, cfg.vocab_size, 8), 8) for i in range(4)]
    t0 = time.perf_counter()
    srv.run(reqs)
    rt.torch.cuda.synchronize()
    srv_s = time.perf_counter() - t0
    check(all(r.done and len(r.generated) == 8 for r in reqs), "server left requests unfinished")
    launches = read_counts(rt.counters)
    print(f"[server] {cfg.name}: 4 requests x 8 new tokens in {srv_s:.2f}s "
          f"({32 / srv_s:.1f} tok/s), launches {launches}; req 0 -> {reqs[0].generated}")


def consistency(rt, cfg, params, B, S, impls):
    """Relative errors on a batch of seed 1, launches not counted: for each attention
    impl, prefill of S positions + one decode step against forward's last logits on
    the S + 1 positions; the first impl's prefill against forward at S and against
    each other impl's prefill.  Forward runs the naive attention, so naive prefill +
    decode against it is the control with equal maths.  Where the cache holds k/v,
    layer 0's (which precede any attention) must be equal bits for every impl."""
    torch = rt.torch
    batch = rt.api.demo_batch(cfg, B, S + 1, seed=1)
    last = prefix(batch, S + 1)["tokens"][:, -1:]
    lg, dec, kv0 = {}, {}, {}
    for impl in impls:
        step = rt.make_prefill_step(cfg, rt.StepSettings(attn_impl=impl), cache_len=S + 1)
        lg[impl], cache = step(params, prefix(batch, S))
        if "k" in cache:
            kv0[impl] = (cache["k"][0].clone(), cache["v"][0].clone())
        dec[impl], _ = rt.make_decode_step(cfg)(params, cache, last, S,
                                                **decode_ids(torch, cfg, last, S))
        del cache
    with torch.no_grad():
        full, _ = rt.api.forward(cfg, params, batch, attn_impl="naive")
    first = impls[0]
    out = {f"{first}_vs_{impl}_prefill": rel(torch, lg[first], lg[impl])
           for impl in impls[1:]}
    for impl in impls:
        out[f"{impl}_prefill_decode_vs_forward"] = rel(torch, dec[impl][:, 0], full[:, -1])
    out[f"{first}_prefill_vs_forward"] = rel(torch, lg[first][:, 0], full[:, -2])
    if kv0:
        out["layer0_kv_equal"] = all(torch.equal(a, b) for kv in kv0.values()
                                     for a, b in zip(kv, kv0[first]))
    return out


def report_path(res, per_prefill):
    print(f"[serve] {res['arch']} prefill {res['B']}x{res['S']}: {res['prefill_ms']:.1f} ms "
          f"({res['prefill_tok_s']:.0f} tok/s; cold {res['cold_prefill_ms']:.1f} ms), "
          f"launches per prefill {per_prefill}")
    print(f"[serve] {res['arch']} decode x {res['B']}: {res['decode_ms']:.2f} ms/step after "
          f"the first ({res['decode_tok_s']:.1f} tok/s; cold first step "
          f"{res['cold_decode_ms']:.1f} ms); peak memory {res['peak_gb']:.2f} GB")
    print(f"[serve] {res['arch']} main path " + json.dumps(res))


def serve_model(rt, model):
    """One model at full width with seed-0 random bf16 weights: the main path and its
    launch counts, a profile of one prefill and one decode step, BatchedServer, then
    the consistency checks, reported in bf16 and held in fp32 compute.  Each set of
    weights is freed before the next is built.  Returns the main path's launches."""
    torch, api = rt.torch, rt.api
    arch, B, S, impls, check_shape, per_prefill, depth, fp32_depth = model
    cfg = rt.get_config(arch)
    full_depth = cfg.num_layers
    if depth:
        cfg = cfg.replace(num_layers=depth)
    t0 = time.perf_counter()
    params = api.init_params(cfg, 0)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {api.param_count(cfg) / 1e9:.3f}B params in bf16, "
          f"{cfg.num_layers} of {full_depth} layers"
          + (" (reduced depth)" if depth else "")
          + f", init {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    res, batch, prefill, decode, prefill_logits, cache = main_path(
        rt, cfg, params, B, S, N_DECODE, impls[0])
    want = {name: 2 * per_prefill.get(name, 0) for name in read_counts(rt.counters)}
    check(res["launches"] == want, f"{res['launches']} launches on the {cfg.name} main "
                                   f"path, want {want}")
    specs = api.cache_specs(cfg, rt.ShapeSpec("main_path", "decode", S + N_DECODE, B))
    shapes = layout(cache, lambda a: (tuple(a.shape), a.dtype))
    check(shapes == layout(specs, lambda spec: (spec.shape, spec.dtype)),
          f"cache {shapes} against api.cache_specs {specs}")
    report_path(res, per_prefill)
    check(torch.equal(prefill(params, batch)[0], prefill_logits), "prefill is not deterministic")
    nxt = prefill_logits[:, -1].argmax(-1, keepdim=True)
    ids = decode_ids(torch, cfg, nxt, S)
    for label, fn in (("prefill", lambda: prefill(params, batch)),
                      ("decode", lambda: decode(params, cache, nxt, S, **ids))):
        print(f"[profile] {cfg.name} {label} " + json.dumps(device_breakdown(torch, fn)))
    del cache, prefill, decode, prefill_logits
    torch.cuda.empty_cache()
    if cfg.family == "encdec":
        print(f"[server] {cfg.name}: not served; BatchedServer targets decoder-only "
              "families, as the reference's serve driver does")
    else:
        run_server(rt, cfg, params)

    # in bf16 at full width the equal-maths control already differs by about the
    # tests' 0.02, so the limits are held in fp32 compute, where the same
    # comparisons must agree to rounding.  A MoE model is checked at the no-drop
    # capacity: prefill routes groups of tokens and decode groups of one, so at
    # the default capacity they drop different tokens
    if cfg.num_experts:
        cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    bf16 = consistency(rt, cfg, params, *check_shape, impls)
    print(f"[check] {cfg.name} bf16 {cfg.num_layers} layers B={check_shape[0]} "
          f"S={check_shape[1]}, reported " + json.dumps(bf16))
    check(bf16.get("layer0_kv_equal", True), f"{cfg.name}: layer-0 k/v differ between impls")
    del params
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(compute_dtype="float32", num_layers=fp32_depth or cfg.num_layers)
    params32 = api.init_params(cfg32, 0)
    fp32 = consistency(rt, cfg32, params32, *check_shape, impls)
    del params32
    torch.cuda.empty_cache()
    print(f"[check] {cfg.name} fp32 {cfg32.num_layers} layers, limit {FP32_TOL} "
          + json.dumps(fp32))
    for key, val in fp32.items():
        check(val is True if isinstance(val, bool) else val < FP32_TOL,
              f"{cfg.name} fp32 {key}: {val}")
    return res["launches"]


def layout(cache, fn):
    """fn over a cache's (or its specs') entries: a stacked dict, or a per-layer list."""
    if isinstance(cache, dict):
        return {name: fn(a) for name, a in cache.items()}
    return [{name: fn(a) for name, a in entry.items()} for entry in cache]


def train_model(rt, spec):
    """One model trained at full width from fp32 master weights through Trainer: the
    eval step (naive and flash) at the step-0 params, a profile of one train step,
    a straight run, and a run cut at spec.ckpt_at and resumed from its checkpoint;
    see the module's docstring for the checks.  Returns the launches of the flash
    eval and of the straight run (every count 0), the two paths of this phase."""
    torch, api = rt.torch, rt.api
    cfg = rt.get_config(spec.arch)
    full_depth = cfg.num_layers
    if spec.depth:
        cfg = cfg.replace(num_layers=spec.depth, window_pattern=cfg.window_pattern[:spec.depth])
    settings = rt.StepSettings(accum=2, remat="dots")
    tokens = spec.B * spec.S
    n_flops = api.flops_param_count(cfg)

    def trainer(steps, c=cfg, **kw):
        return rt.Trainer(c, steps=steps, batch=spec.B, seq=spec.S, settings=settings,
                          log_every=1, **kw)

    def run_evals(c, params, batch):
        evals, launches = {}, {}
        for impl in ("naive", "flash"):
            zero_counts(rt.counters)
            t0 = time.perf_counter()
            evals[impl] = float(rt.make_eval_step(c, rt.StepSettings(attn_impl=impl))(
                params, batch))
            torch.cuda.synchronize()
            launches[impl] = read_counts(rt.counters)
            print(f"[train] {cfg.name}{' inloop' if c.ssm_inloop else ''} eval {impl}: loss "
                  f"{evals[impl]:.6f} in {(time.perf_counter() - t0) * 1e3:.1f} ms (cold), "
                  f"launches {launches[impl]}")
        return evals, launches

    print(f"[train] {cfg.name}: {api.param_count(cfg) / 1e9:.3f}B params in fp32 "
          f"({n_flops / 1e9:.3f}B in the model-FLOP count), {cfg.num_layers} of {full_depth} "
          f"layers{' (reduced depth)' if spec.depth else ''}, "
          f"B={spec.B} S={spec.S}, accum 2, remat dots, AdamW with fp32 moments")
    tr = trainer(spec.steps)
    params, opt, _ = tr.init_state(0)
    batch = rt.to_device(tr.data.batch_at(0), "cuda")
    evals, eval_launches = run_evals(cfg, params, batch)
    want = {name: spec.per_eval.get(name, 0) for name in read_counts(rt.counters)}
    check(eval_launches["flash"] == want, f"{cfg.name} flash eval launches "
                                          f"{eval_launches['flash']}, want {want}")
    eval_rel = abs(evals["flash"] - evals["naive"]) / abs(evals["naive"])
    check(eval_rel < BF16_REL, f"{cfg.name} flash eval vs naive: {eval_rel}")
    # the step's parts, host-timed after a warm-up: the data of one step, and the
    # step function with each remat policy ("full" for comparison: the selective
    # "dots" policy runs a Python dispatch mode over every op)
    t0 = time.perf_counter()
    tr.data.batch_at(1)
    data_ms = (time.perf_counter() - t0) * 1e3
    step_fn_ms = {}
    for remat in ("dots", "full"):
        fn = rt.make_train_step(cfg, tr.opt_cfg, rt.StepSettings(accum=2, remat=remat))
        fn(params, opt, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, opt, batch)
        torch.cuda.synchronize()
        step_fn_ms[remat] = (time.perf_counter() - t0) * 1e3
    print(f"[train] {cfg.name} one step's data {data_ms:.1f} ms (host); the step function "
          f"alone, remat dots {step_fn_ms['dots']:.1f} ms, full {step_fn_ms['full']:.1f} ms")
    # (no host-side table for the SSM and hybrid steps: see device_breakdown)
    prof = device_breakdown(torch, lambda: tr.step_fn(params, opt, batch),
                            host=cfg.family not in ("ssm", "hybrid"))
    print(f"[profile] {cfg.name} train step " + json.dumps(prof))
    del params, opt, batch, tr
    torch.cuda.empty_cache()

    ckpt = CKPT_DIR / cfg.name
    shutil.rmtree(ckpt, ignore_errors=True)
    # bitwise resume on the card: embedding and gather backward accumulate with
    # atomics unless PyTorch's deterministic algorithms are on (cuBLAS's workspace
    # is fixed by CUBLAS_WORKSPACE_CONFIG, set in main before cuBLAS starts)
    torch.use_deterministic_algorithms(True)
    try:
        zero_counts(rt.counters)
        torch.cuda.reset_peak_memory_stats()
        log_a = trainer(spec.steps).run()
        train_launches = read_counts(rt.counters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trainer(spec.ckpt_at, ckpt_dir=str(ckpt), ckpt_every=spec.ckpt_at).run()
        log_b = trainer(spec.steps, ckpt_dir=str(ckpt), ckpt_every=spec.ckpt_at).run()
    finally:
        torch.use_deterministic_algorithms(False)
    check(all(n == 0 for n in train_launches.values()),
          f"{cfg.name} train steps launched kernels: {train_launches}")
    for m in log_a:
        step_s = m["sec"]
        print(f"[train] {cfg.name} step {m['step']}: {step_s * 1e3:.1f} ms, "
              f"{tokens / step_s:.0f} tok/s, loss {m['loss']:.6f}, grad_norm "
              f"{m['grad_norm']:.6f}, 6*N*tokens/step time {6 * n_flops * tokens / step_s / 1e12:.1f} "
              f"TFLOP/s = {6 * n_flops * tokens / step_s / PEAK_FLOPS['bfloat16']:.3f} of "
              f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f}")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in log_a + log_b),
          f"{cfg.name}: non-finite loss or grad norm")
    step0_rel = abs(log_a[0]["loss"] - evals["naive"]) / abs(evals["naive"])
    check(step0_rel < BF16_REL, f"{cfg.name} step-0 train loss {log_a[0]['loss']} vs naive "
                                f"eval {evals['naive']}")
    resumed = [(m["loss"], m["grad_norm"]) for m in log_b]
    straight = [(m["loss"], m["grad_norm"]) for m in log_a[spec.ckpt_at:]]
    check(resumed == straight, f"{cfg.name} resumed {resumed} != straight {straight}")
    init = api.init_params(cfg, 0, dtype=torch.float32)
    last, extra = rt.checkpoint.restore(
        str(ckpt), {"params": init, "opt": {"count": torch.zeros((), dtype=torch.int32)}})
    check(extra["next_step"] == spec.steps and int(last["opt"]["count"]) == spec.steps,
          f"{cfg.name} checkpoint at {extra}, count {int(last['opt']['count'])}")
    moved = sum(float((a - b).abs().sum()) for a, b in zip(rt.leaves(init),
                                                            rt.leaves(last["params"])))
    check(moved > 0, f"{cfg.name}: params did not move")
    del init, last
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    warm = [m["sec"] for m in log_a[1:]]
    step_s = sum(warm) / len(warm)
    res = dict(arch=cfg.name, layers=cfg.num_layers, B=spec.B, S=spec.S, steps=spec.steps,
               accum=2, remat="dots", step_ms=step_s * 1e3, cold_step_ms=log_a[0]["sec"] * 1e3,
               tok_s=tokens / step_s, peak_gb=peak_gb,
               model_tflops=6 * n_flops * tokens / step_s / 1e12,
               model_flop_share=6 * n_flops * tokens / step_s / PEAK_FLOPS["bfloat16"],
               losses=[m["loss"] for m in log_a], grad_norms=[m["grad_norm"] for m in log_a],
               eval_naive=evals["naive"], eval_flash=evals["flash"], eval_rel=eval_rel,
               step0_vs_eval_rel=step0_rel, resumed_equal=True, moved_abs_sum=moved,
               data_ms=data_ms, step_fn_ms=step_fn_ms,
               launches_train=train_launches, launches_flash_eval=eval_launches["flash"])
    print(f"[train] {cfg.name} result " + json.dumps(res))
    launches = {name: eval_launches["flash"][name] + train_launches[name]
                for name in train_launches}
    if cfg.family in ("ssm", "hybrid"):
        for name, n in train_inloop(rt, spec, cfg, trainer, run_evals, res, want).items():
            launches[name] += n
    return launches


def train_inloop(rt, spec, cfg, trainer, run_evals, off, want):
    """The SSM or hybrid row again with `ssm_inloop`: the naive and flash evals at
    the step-0 params, a profile of one train step and a straight run under
    deterministic algorithms, held against the flag-off run `off` (see INLOOP_REL);
    step ms, tokens/s, peak GB and model-FLOP share beside the flag-off ones.
    Returns the launches of its flash eval and straight run."""
    torch, api = rt.torch, rt.api
    icfg = cfg.replace(ssm_inloop=True)
    tokens, n_flops = spec.B * spec.S, api.flops_param_count(cfg)
    tr = trainer(spec.steps, c=icfg)
    params, opt, _ = tr.init_state(0)
    batch = rt.to_device(tr.data.batch_at(0), "cuda")
    evals, eval_launches = run_evals(icfg, params, batch)
    check(eval_launches["flash"] == want, f"{cfg.name} inloop flash eval launches "
                                          f"{eval_launches['flash']}, want {want}")
    check(evals == {"naive": off["eval_naive"], "flash": off["eval_flash"]},
          f"{cfg.name} inloop evals {evals} != flag-off {off['eval_naive']}, "
          f"{off['eval_flash']}")
    prof = device_breakdown(torch, lambda: tr.step_fn(params, opt, batch))
    print(f"[profile] {cfg.name} inloop train step " + json.dumps(prof))
    del params, opt, batch, tr
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    try:
        zero_counts(rt.counters)
        torch.cuda.reset_peak_memory_stats()
        log = trainer(spec.steps, c=icfg).run()
        train_launches = read_counts(rt.counters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    check(all(n == 0 for n in train_launches.values()),
          f"{cfg.name} inloop train steps launched kernels: {train_launches}")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in log),
          f"{cfg.name} inloop: non-finite loss or grad norm")
    check(log[0]["loss"] == off["losses"][0],
          f"{cfg.name} inloop step-0 loss {log[0]['loss']} != flag-off {off['losses'][0]}")
    worst = max(abs(m[k] - ref) / abs(ref) for m, ref_l, ref_g in
                zip(log, off["losses"], off["grad_norms"])
                for k, ref in (("loss", ref_l), ("grad_norm", ref_g)))
    check(worst < INLOOP_REL, f"{cfg.name} inloop vs flag-off: {worst}")
    step_s = sum(m["sec"] for m in log[1:]) / (len(log) - 1)
    on = dict(step_ms=step_s * 1e3, tok_s=tokens / step_s, peak_gb=peak_gb,
              model_flop_share=6 * n_flops * tokens / step_s / PEAK_FLOPS["bfloat16"])
    res = dict(arch=cfg.name, layers=cfg.num_layers, B=spec.B, S=spec.S, steps=spec.steps,
               off={k: off[k] for k in on}, on=on,
               losses=[m["loss"] for m in log], grad_norms=[m["grad_norm"] for m in log],
               max_rel_to_off=worst, evals_bitwise=True, step0_bitwise=True,
               launches_train=train_launches, launches_flash_eval=eval_launches["flash"])
    print(f"[train] {cfg.name} inloop result " + json.dumps(res))
    return {name: eval_launches["flash"][name] + train_launches[name] for name in train_launches}


def link_table(events):
    """{(semantic, kind, link): [multiplicity, operand bytes, modelled s]} over sites."""
    table = {}
    for e in events:
        row = table.setdefault((e.semantic, e.kind, e.link_class), [0, 0, 0.0])
        row[0] += e.multiplicity
        row[1] += e.operand_bytes * e.multiplicity
        row[2] += e.est_time_s * e.multiplicity
    return table


def trace_phase(rt):
    """The capture of the sharded train step at full width (see the module's
    docstring).  Keeps the trace for the session phase in `rt.kept`, and the
    live step for [ingest], which releases it.  Returns its launches (every
    count 0)."""
    torch, api, sh, core = rt.torch, rt.api, rt.sharding, rt.core
    cfg = rt.get_config(TRACE["arch"])
    mesh, spec = rt.make_host_mesh(TRACE["mesh"], ("data", "model"), backend="fake",
                                   device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = sh.init_params(cfg, 0, mesh)
    oc = rt.adamw.AdamWConfig()
    opt = rt.adamw.init(oc, params)
    B, S = TRACE["B"], TRACE["S"]
    shape = rt.ShapeSpec("trace", "train", S, B)
    placements = {k: sh.placements_for(s, mesh)
                  for k, s in sh.batch_pspecs(cfg, shape, mesh).items()}
    batch = rt.shard_batch(rt.SyntheticTokens(cfg, rt.DataConfig(B, S, seed=0)).batch_at(0),
                           mesh, placements)
    step = rt.make_train_step(cfg, oc, rt.StepSettings(accum=2, remat="full"))
    local_gb = sum(t.to_local().numel() * 4 for t in rt.leaves(params)) * 3 / 1e9
    print(f"[trace] {cfg.name}: {api.param_count(cfg) / 1e9:.3f}B params, rank 0 of "
          f"{TRACE['mesh']} (data, model) under the fake process group; {local_gb:.2f} GB of "
          f"local fp32 params and moments; global batch {B} x {S}, accum 2, remat full")

    def timed(capture):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rt.activation_sharding(mesh):
            tr = (core.trace_step(step, (params, opt, batch), mesh, spec, label=cfg.name)
                  if capture else step(params, opt, batch))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, tr

    zero_counts(rt.counters)
    warm_ms, _ = timed(False)
    runs = {"off": [], "on": []}
    for mode in ("on", "off", "off", "on"):
        ms, out = timed(mode == "on")
        runs[mode].append(ms)
        if mode == "on":
            tr = out
    launches = read_counts(rt.counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(n == 0 for n in launches.values()), f"traced steps launched kernels {launches}")
    check(tr.sites > 0, "no collective captured")
    table = link_table(tr.events)
    sems = {k[0] for k in table}
    check({"grad_sync", "attention"} <= sems, f"semantics {sorted(sems)}")
    check(any(k[0] == "grad_sync" and k[2] == "nvlink.data" for k in table),
          "no grad_sync on nvlink.data")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    rule = 0
    for p, s in zip(rt.leaves(params), rt.leaves(sh.param_pspecs(cfg, mesh))):
        axes = [a for e in s if e for a in ((e,) if isinstance(e, str) else e)]
        rule += p.numel() * 4 // math.prod(sizes[a] for a in axes if a != "data")
    synced = sum(e.operand_bytes * e.multiplicity for e in tr.events
                 if e.semantic == "grad_sync" and e.link_class.endswith(".data")
                 and "optimizer" not in e.op_name)
    check(synced == 2 * rule, f"grad_sync bytes over data {synced} != accum 2 x "
                              f"data-replicated gradient bytes {rule}")
    ib_store = tr.store.annotation_clone()
    rt.costmodel.annotate_store(ib_store, rt.MeshSpec(spec.shape, spec.axes, axis_kind={
        "data": "ib", "model": "nvlink"}), rt.H100)
    ib_table = link_table(ib_store.rows())
    tokens = B * S
    rf = rt.roofline(tr, rt.H100, model_flops=6 * api.flops_param_count(cfg) * tokens)
    print(f"[trace] {tr.sites} sites; (semantic, kind, link): multiplicity, operand bytes, "
          f"H100 model ms (NVLink), the same with data on InfiniBand")
    for key in sorted(table):
        mult, nbytes, secs = table[key]
        ib_key = (key[0], key[1], key[2].replace("nvlink.data", "ib.data"))
        print(f"[trace]   {'/'.join(key)}: {mult}, {nbytes}, {secs * 1e3:.4f}; "
              f"{ib_key[2]} {ib_table.get(ib_key, [0, 0, 0.0])[2] * 1e3:.4f}")
    res = dict(arch=cfg.name, mesh=list(TRACE["mesh"]), B=B, S=S, sites=tr.sites,
               multiplicity=sum(r[0] for r in table.values()),
               collective_bytes=tr.total_collective_bytes(),
               model_ms_nvlink=tr.total_est_time_s() * 1e3,
               model_ms_data_ib=float(ib_store.total_est_time_s()) * 1e3,
               grad_sync_data_bytes=synced, rule_bytes=rule,
               step_ms_capture_on=runs["on"], step_ms_capture_off=runs["off"],
               warm_up_ms=warm_ms, capture_overhead=(sum(runs["on"]) / sum(runs["off"]) - 1),
               peak_gb=peak_gb, rank_gflop=tr.hlo_flops / 1e9, roofline=rf.row(),
               launches=launches)
    print("[trace] result " + json.dumps(res))
    rt.kept["trace"] = (tr, spec)

    def release():
        nonlocal params, opt, batch
        del params, opt, batch
        torch.cuda.empty_cache()
        rt.dist.destroy_process_group()
    # the step stays live for [ingest], which captures it again and then releases it
    rt.kept["trace step"] = (lambda: timed(True), spec, release)
    return launches


def ingest_phase(rt):
    """Live ingest of the card's own captures (host only; see the module's
    docstring): [trace]'s step captured INGEST["steps"] more times, each
    trace written with `dump.write_capture` into INGEST_DIR as the step ends
    while a `WatchDaemon` polls the directory from a background thread.
    Then: every file ingested `ok`, each ingested trace identical to its
    in-memory one; `run(once=True)`'s JSON and HTML reports against batch
    `from_captures` + `report`, and against `session ingest` + `session
    report`; the six corrupt modes on copies of the card's first capture
    through `session ingest --errors salvage` (exit 3).  Host seconds to
    write, read and fold each file, its bytes, the step-end-to-ingest
    latency and the daemon's rounds.  Releases [trace]'s step.  Returns its
    launches (every count 0)."""
    import contextlib
    import io
    import threading
    from repro_torch.core import dump, synth
    from repro_torch.core import session as session_mod
    from repro_torch.core.session import TraceSession
    from repro_torch.core.watch import WatchConfig, WatchDaemon
    capture, spec, release = rt.kept.pop("trace step")
    shutil.rmtree(INGEST_DIR, ignore_errors=True)
    INGEST_DIR.mkdir(parents=True)
    zero_counts(rt.counters)
    daemon = WatchDaemon(WatchConfig(root=str(INGEST_DIR), mesh=spec, quiet=True,
                                     settle_s=INGEST["settle_s"]))
    seen, stop = {}, threading.Event()

    def poll():
        while not stop.is_set():
            for path in daemon.poll_once()[0]:
                seen[path] = time.time()
            time.sleep(INGEST["interval_s"])
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    traces, ends, write_s, step_ms = {}, {}, {}, []
    try:
        for k in range(INGEST["steps"]):
            ms, tr = capture()
            ends_k = time.time()
            path = dump.capture_path(str(INGEST_DIR), 0, k)
            t0 = time.perf_counter()
            dump.write_capture(tr, path, mesh=spec)
            write_s[path] = time.perf_counter() - t0
            traces[path], ends[path] = tr, ends_k
            step_ms.append(ms)
        deadline = time.time() + 60
        while len(seen) < len(traces) and time.time() < deadline:
            time.sleep(INGEST["interval_s"])
    finally:
        stop.set()
        poller.join()
        release()
    launches = read_counts(rt.counters)
    check(all(n == 0 for n in launches.values()), f"captured steps launched kernels {launches}")
    paths = sorted(traces)
    check(sorted(seen) == paths, f"the daemon ingested {sorted(seen)} of {paths}")
    check(not daemon.degraded() and all(daemon._records[p]["status"] == "ok" for p in paths),
          f"degraded ingest {daemon.degraded()}")
    live = daemon.session()
    for p in paths:
        got, want = live.get(os.path.splitext(os.path.basename(p))[0]), traces[p]
        check(got.store.identical(want.store)
              and (got.sites, int(got.store.multiplicity.sum()),
                   got.total_collective_bytes(), got.total_est_time_s())
              == (want.sites, int(want.store.multiplicity.sum()),
                  want.total_collective_bytes(), want.total_est_time_s()),
              f"{p}: the ingested trace differs from the captured one")
    # host seconds of each part, per file: read + parse, and the daemon's fold
    read_s, fold_s = {}, {}
    timing = WatchDaemon(WatchConfig(root=str(INGEST_DIR), mesh=spec, quiet=True))
    for p in paths:
        t0 = time.perf_counter()
        tr = dump.trace_from_capture(dump.read_capture(p), spec,
                                     label=os.path.splitext(os.path.basename(p))[0])
        read_s[p] = time.perf_counter() - t0
        t0 = time.perf_counter()
        timing._fold(tr)
        fold_s[p] = time.perf_counter() - t0
    # the daemon's --once reports against batch ingest + report
    out = SESSION_DIR / "ingest"
    out.mkdir(parents=True, exist_ok=True)
    once = WatchDaemon(WatchConfig(
        root=str(INGEST_DIR), mesh=spec, quiet=True, once=True, settle_s=INGEST["settle_s"],
        interval_s=INGEST["interval_s"], report_json=str(out / "watch.json"),
        report_html=str(out / "watch.html")))
    t0 = time.perf_counter()
    rc = once.run()
    once_s = time.perf_counter() - t0
    check(rc == 0, f"watch --once exited {rc}")
    t0 = time.perf_counter()
    batch = TraceSession.from_captures("dump", paths, spec)
    batch_s = time.perf_counter() - t0
    cli = io.StringIO()
    with contextlib.redirect_stdout(cli):
        rcs = [session_mod._main(["ingest", str(out / "batch.json"), *paths,
                                  "--mesh", ",".join(map(str, spec.shape)),
                                  "--axes", ",".join(spec.axes)])]
        for fmt in ("json", "html"):
            rcs.append(session_mod._main(["report", str(out / "batch.json"), "--format", fmt,
                                          "--out", str(out / f"cli.{fmt}")]))
    check(rcs == [0, 0, 0], f"session ingest/report exited {rcs}")
    for fmt in ("json", "html"):
        daemon_bytes = (out / f"watch.{fmt}").read_bytes()
        check(daemon_bytes == (batch.report(fmt=fmt) + "\n").encode()
              == (out / f"cli.{fmt}").read_bytes(),
              f"watch --once {fmt} report differs from batch ingest + report")
    # the six corrupt modes on copies of the card's first capture
    chaos = SESSION_DIR / "chaos"
    shutil.rmtree(chaos, ignore_errors=True)
    chaos.mkdir(parents=True)
    text = dump.read_capture(paths[0])
    for i, mode in enumerate(synth.CORRUPT_MODES):
        seed = i
        while synth.corrupt_capture(text, mode, seed=seed) == text:
            seed += 1           # a line mode that picked no line of this file
        damaged = synth.corrupt_capture(text, mode, seed=seed)
        with open(chaos / f"capture_{mode}.jsonl",
                  "wb" if isinstance(damaged, bytes) else "w") as f:
            f.write(damaged)
    files = sorted(str(p) for p in chaos.glob("*.jsonl"))
    with contextlib.redirect_stdout(io.StringIO()) as buf, \
            contextlib.redirect_stderr(io.StringIO()):
        rc = session_mod._main(["ingest", str(chaos / "chaos.json"), *files, "--errors",
                                "salvage", "--retries", "0", "--json", "--workers", "1",
                                "--mesh", ",".join(map(str, spec.shape)),
                                "--axes", ",".join(spec.axes)])
    statuses = {os.path.basename(r["source"])[len("capture_"):-len(".jsonl")]: r["status"]
                for r in json.loads(buf.getvalue())["records"]}
    check(rc == 3, f"session ingest --errors salvage over the corrupt copies exited {rc}")
    check(statuses == CORRUPT_STATUS, f"corrupt modes: {statuses} != {CORRUPT_STATUS}")
    sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
    latency = {os.path.basename(p): seen[p] - ends[p] for p in paths}
    sites = {os.path.basename(p): traces[p].sites for p in paths}
    for p in paths:
        b, n = os.path.basename(p), traces[p].sites
        print(f"[ingest] {b}: {sizes[b]} bytes, {n} sites; host s write {write_s[p]:.6f} "
              f"({write_s[p] / n * 1e6:.2f} us a site), read + parse {read_s[p]:.6f} "
              f"({read_s[p] / n * 1e6:.2f} us a site), fold {fold_s[p]:.6f} "
              f"({fold_s[p] / n * 1e6:.2f} us a site); step end to ingest {latency[b]:.3f} s")
    print(f"[ingest] daemon: {daemon.rounds} rounds at {INGEST['interval_s']} s, settle "
          f"{INGEST['settle_s']} s; watch --once {once_s:.3f} s in {once.rounds} rounds, "
          f"batch from_captures {batch_s:.3f} s; corrupt copies {statuses}")
    res = dict(arch=rt.kept["trace"][0].label, steps=INGEST["steps"], step_ms=step_ms,
               file_bytes=sizes, sites=sites,
               write_s={os.path.basename(p): write_s[p] for p in paths},
               read_parse_s={os.path.basename(p): read_s[p] for p in paths},
               fold_s={os.path.basename(p): fold_s[p] for p in paths},
               latency_s=latency, daemon_rounds=daemon.rounds, settle_s=INGEST["settle_s"],
               interval_s=INGEST["interval_s"], once_s=once_s, once_rounds=once.rounds,
               batch_s=batch_s, corrupt=statuses, launches=launches)
    print("[ingest] result " + json.dumps(res))
    return launches


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_phase(rt):
    """Trainer on a one-card nccl mesh against the straight Trainer (see the
    module's docstring), and the witness: the straight Trainer with the mesh's
    vocab-parallel loss formulation on plain tensors, which must give the
    mesh's readings bit for bit when that formulation is the whole of the
    difference; then SHARD_INLOOP's pair.  Returns its launches (every count 0)."""
    torch, spec, losses = rt.torch, TRAINS[0], rt.losses
    cfg = rt.get_config(spec.arch)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), RANK="0",
                      WORLD_SIZE="1")
    inloop = SHARD_INLOOP
    icfg = rt.get_config(inloop["arch"])
    icfg = icfg.replace(num_layers=inloop["layers"], ssm_inloop=True,
                        window_pattern=icfg.window_pattern[:inloop["layers"]])
    settings = rt.StepSettings(accum=2, remat="dots")
    logs = {}
    plain_pick = losses._lse_and_target
    zero_counts(rt.counters)
    torch.use_deterministic_algorithms(True)
    try:
        for name, c, mesh in (("straight", cfg, None), ("mesh 1x1", cfg, (1, 1)),
                              ("witness", cfg, None), ("inloop straight", icfg, None),
                              ("inloop mesh 1x1", icfg, (1, 1))):
            if name == "witness":
                losses._lse_and_target = losses._lse_and_target_vocab_parallel
            else:
                losses._lse_and_target = plain_pick
            tr = rt.Trainer(c, steps=2, batch=spec.B, seq=spec.S, settings=settings,
                            log_every=1, mesh=mesh)
            logs[name] = tr.run()
            del tr
            torch.cuda.empty_cache()
    finally:
        losses._lse_and_target = plain_pick
        torch.use_deterministic_algorithms(False)
    launches = read_counts(rt.counters)
    check(rt.dist.get_backend() == "nccl" and rt.dist.get_world_size() == 1,
          "the mesh did not run on a one-rank nccl group")
    rt.dist.destroy_process_group()

    def same(a, b):
        return all(x["loss"] == y["loss"] and x["grad_norm"] == y["grad_norm"]
                   for x, y in zip(a, b))

    def worst(a, b):
        return max(max(abs(x[k] - y[k]) / abs(x[k]) for k in ("loss", "grad_norm"))
                   for x, y in zip(a, b))
    rows = {k.replace(" ", "_"): [(m["loss"], m["grad_norm"], m["sec"] * 1e3) for m in v]
            for k, v in logs.items()}
    res = dict(arch=cfg.name, B=spec.B, S=spec.S, steps=2, accum=2, remat="dots",
               **{k: v for k, v in rows.items() if not k.startswith("inloop")},
               bitwise=same(logs["straight"], logs["mesh 1x1"]),
               max_rel=worst(logs["straight"], logs["mesh 1x1"]),
               witness_bitwise_to_mesh=same(logs["witness"], logs["mesh 1x1"]),
               inloop=dict(arch=icfg.name, layers=icfg.num_layers, ssm_inloop=True,
                           **{k: v for k, v in rows.items() if k.startswith("inloop")},
                           bitwise=same(logs["inloop straight"], logs["inloop mesh 1x1"]),
                           max_rel=worst(logs["inloop straight"], logs["inloop mesh 1x1"])),
               launches=launches)
    print("[shard] result " + json.dumps(res))
    check(all(n == 0 for n in launches.values()), f"sharded steps launched kernels {launches}")
    for pre, r in (("", res), ("inloop ", res["inloop"])):
        check(logs[pre + "straight"][0]["loss"] == logs[pre + "mesh 1x1"][0]["loss"],
              f"{pre}step-0 losses differ")
        check(r["max_rel"] < SHARD_REL, f"{pre}mesh 1x1 vs straight: {r['max_rel']}")
    return launches


def moe_phase(rt):
    """One qwen3-moe-235b-a22b MoE layer at full width on a one-rank nccl mesh
    (see MOE): `apply_moe` with the sort dispatch against the einsum dispatch,
    both on the mesh's DTensors from the same seed-0 fp32 weights and x; the
    output, the aux loss and, after a backward of mean(y^2) + 0.01 * aux, every
    gradient.  Forward + backward ms (CUDA events, the second of two runs) and
    peak GB of each.  Returns its launches (every count 0)."""
    torch, sh, moe = rt.torch, rt.sharding, rt.moe
    cfg = rt.get_config(MOE["arch"])
    cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), RANK="0",
                      WORLD_SIZE="1")
    backend = "nccl" if rt.device == "cuda" else "gloo"
    mesh, _ = rt.make_host_mesh((1, 1), ("data", "model"), backend=backend)
    sizes = sh.mesh_axis_sizes(mesh)
    placements = {}
    rt.tree_map_meta(lambda path, m: placements.__setitem__(path[-1], sh.placements_for(
        sh.spec_for(m.shape, m.logical, sh.TRAIN_RULES, sizes), mesh)), moe.moe_meta(cfg))
    gen = torch.Generator(device=rt.device).manual_seed(0)
    x_full = torch.randn(MOE["B"], MOE["S"], cfg.d_model, generator=gen, device=rt.device)
    T = MOE["B"] * MOE["S"]
    cap = math.ceil(cfg.top_k * T * cfg.capacity_factor / cfg.num_experts)
    print(f"[moe] {cfg.name} MoE layer: d_model {cfg.d_model}, {cfg.num_experts} experts, "
          f"top-{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, fp32, capacity factor "
          f"{cfg.capacity_factor:g} (no drops); x {MOE['B']} x {MOE['S']} x {cfg.d_model}; one-rank "
          f"{backend} mesh (1, 1); sort buffer {(cfg.num_experts * cap + 1) * cfg.d_model * 4 / 1e9:.2f} GB")

    def run(dispatch):
        """One forward + backward; its outputs, gradients (the sort's kept on the
        host while the einsum runs: 9.7 GB of expert gradients), ms, and the peak
        GB it added to what was allocated before it."""
        params = rt.materialize(moe.moe_meta(cfg), 0, torch.device(rt.device), torch.float32,
                                place=lambda path, t: rt.distribute_tensor(
                                    t, mesh, placements[path[-1]]).requires_grad_())
        x = rt.distribute_tensor(x_full, mesh, [rt.Shard(0), rt.Replicate()]).requires_grad_()
        c = cfg.replace(moe_dispatch=dispatch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with rt.activation_sharding(mesh):
            y, aux = moe.apply_moe(c, params, x)
            ((y.float() ** 2).mean() + 0.01 * aux).backward()
        end.record()
        torch.cuda.synchronize()
        out = dict(y=y.full_tensor().detach(), aux=float(aux.full_tensor().detach()),
                   grads={k: t.grad.full_tensor() for k, t in [("x", x)] + sorted(params.items())},
                   ms=start.elapsed_time(end),
                   peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        del params, x, y, aux
        return out

    zero_counts(rt.counters)
    res = {}
    for dispatch in ("sort", "einsum"):
        first_ms = run(dispatch)["ms"]
        torch.cuda.empty_cache()
        res[dispatch] = run(dispatch)                   # warm: the second run's readings
        res[dispatch]["ms_first"] = first_ms
        if dispatch == "sort":
            res[dispatch]["grads"] = {k: g.cpu() for k, g in res[dispatch]["grads"].items()}
        torch.cuda.empty_cache()
    launches = read_counts(rt.counters)
    s, e = res["sort"], res["einsum"]
    y_rel = rel(torch, s["y"], e["y"])
    aux_err = abs(s["aux"] - e["aux"])
    grad_rel = {k: rel(torch, g.to(e["grads"][k].device), e["grads"][k])
                for k, g in s["grads"].items()}
    finite = all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                 for g in s["grads"].values())
    summary = dict(arch=cfg.name, B=MOE["B"], S=MOE["S"], capacity=cap, y_rel=y_rel,
                   aux_sort=s["aux"], aux_einsum=e["aux"], aux_abs_err=aux_err,
                   grad_rel=grad_rel, grads_finite_nonzero=finite,
                   fwd_bwd_ms={k: res[k]["ms"] for k in res},
                   fwd_bwd_ms_first={k: res[k]["ms_first"] for k in res},
                   peak_gb={k: res[k]["peak_gb"] for k in res}, launches=launches)
    print(f"[moe] sort vs einsum: y rel {y_rel:.3e} (limit {MOE['rel']}), aux {s['aux']:.7f} vs "
          f"{e['aux']:.7f} (limit {MOE['aux']}), grads rel "
          + ", ".join(f"{k} {v:.3e}" for k, v in grad_rel.items()) + f" (limit {MOE['grad_rel']})")
    print(f"[moe] forward + backward ms (second run; first in brackets): sort {s['ms']:.2f} "
          f"[{s['ms_first']:.2f}], einsum {e['ms']:.2f} [{e['ms_first']:.2f}]; peak GB sort "
          f"{s['peak_gb']:.2f}, einsum {e['peak_gb']:.2f}")
    print("[moe] result " + json.dumps(summary))
    check(rt.dist.get_backend() == backend and rt.dist.get_world_size() == 1,
          f"the MoE mesh did not run on a one-rank {backend} group")
    rt.dist.destroy_process_group()
    del res, s, e, x_full
    torch.cuda.empty_cache()
    check(all(n == 0 for n in launches.values()), f"the MoE layer launched kernels {launches}")
    check(y_rel < MOE["rel"], f"sort vs einsum output {y_rel}")
    check(aux_err < MOE["aux"], f"sort vs einsum aux {aux_err}")
    check(finite, "a sort-dispatch gradient is not finite or is all zero")
    check(all(v < MOE["grad_rel"] for v in grad_rel.values()), f"gradients {grad_rel}")
    return launches


def moe_trace_phase(rt):
    """The sharded train step of qwen3-moe-235b-a22b (see MOE_TRACE) captured
    with the sort and with the einsum dispatch: each a warm-up step, a captured
    step and a step with the capture off.  Keeps both traces for the session
    phase.  Returns its launches (every count 0)."""
    torch, sh, core = rt.torch, rt.sharding, rt.core
    cfg = rt.get_config(MOE_TRACE["arch"]).replace(num_layers=MOE_TRACE["layers"])
    mesh, spec = rt.make_host_mesh(MOE_TRACE["mesh"], ("data", "model"), backend="fake",
                                   device=rt.device)
    B, S = MOE_TRACE["B"], MOE_TRACE["S"]
    shape = rt.ShapeSpec("moe-trace", "train", S, B)
    placements = {k: sh.placements_for(s, mesh)
                  for k, s in sh.batch_pspecs(cfg, shape, mesh).items()}
    oc = rt.adamw.AdamWConfig()
    zero_counts(rt.counters)
    out = {}
    for dispatch in ("sort", "einsum"):
        c = cfg.replace(moe_dispatch=dispatch)
        torch.cuda.reset_peak_memory_stats()
        params = sh.init_params(c, 0, mesh)
        opt = rt.adamw.init(oc, params)
        batch = rt.shard_batch(rt.SyntheticTokens(c, rt.DataConfig(B, S, seed=0)).batch_at(0),
                               mesh, placements)
        step = rt.make_train_step(c, oc, rt.StepSettings(accum=2, remat="full"))
        if dispatch == "sort":
            local_gb = sum(t.to_local().numel() * 4 for t in rt.leaves(params)) * 3 / 1e9
            print(f"[moe-trace] {c.name}, {c.num_layers} of 94 layers: "
                  f"{rt.api.param_count(c) / 1e9:.3f}B params, rank 0 of {MOE_TRACE['mesh']} "
                  f"(data, model) under the fake process group; {local_gb:.2f} GB of local fp32 "
                  f"params and moments; global batch {B} x {S}, accum 2, remat full")
        ms = {}
        for mode in ("warm", "on", "off"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with rt.activation_sharding(mesh):
                if mode == "on":
                    tr = core.trace_step(step, (params, opt, batch), mesh, spec,
                                         label=f"{c.name} {dispatch}")
                else:
                    step(params, opt, batch)
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        table = link_table(tr.events)
        print(f"[moe-trace] {dispatch}: {tr.sites} sites; step ms warm-up {ms['warm']:.1f}, "
              f"capture on {ms['on']:.1f}, off {ms['off']:.1f}; peak {peak_gb:.2f} GB; "
              f"(semantic, kind, link): multiplicity, operand bytes, H100 model ms")
        for key in sorted(table):
            mult, nbytes, secs = table[key]
            print(f"[moe-trace]   {'/'.join(key)}: {mult}, {nbytes}, {secs * 1e3:.4f}")
        out[dispatch] = dict(trace=tr, table=table, ms=ms, peak_gb=peak_gb)
        del params, opt, batch, step
        torch.cuda.empty_cache()
    launches = read_counts(rt.counters)
    rt.dist.destroy_process_group()
    res = {d: dict(sites=v["trace"].sites, model_ms=v["trace"].total_est_time_s() * 1e3,
                   collective_bytes=v["trace"].total_collective_bytes(),
                   step_ms=v["ms"], peak_gb=v["peak_gb"],
                   table={"/".join(k): r for k, r in sorted(v["table"].items())})
           for d, v in out.items()}
    print("[moe-trace] result " + json.dumps(dict(arch=cfg.name, layers=cfg.num_layers, B=B, S=S,
                                                   launches=launches, **res)))
    check(all(n == 0 for n in launches.values()), f"traced MoE steps launched kernels {launches}")
    check(("moe_combine", "all-reduce", "nvlink.model") in out["sort"]["table"],
          "the sort trace has no moe_combine all-reduce on nvlink.model")
    for d, v in out.items():
        check(not any(k[1] == "all-to-all" for k in v["table"]), f"{d}: an all-to-all")
        check(any(k[0] == "grad_sync" for k in v["table"]), f"{d}: no grad_sync")
    rt.kept.update({f"moe {d}": (v["trace"], spec) for d, v in out.items()})
    return launches


def session_phase(rt):
    """The back half on the card's own traces (host only): one TraceSession of
    [trace]'s chatglm3-6b trace, the same re-priced with `data` on InfiniBand,
    and the two [moe-trace] captures; saved as json, npz and uncompressed npz
    under SESSION_DIR and reloaded (the last with mmap), diffed (einsum against
    sort), linted, run through the detectors and the what-if sweep, and
    rendered as HTML and JSON reports.  Host seconds of each step, file sizes."""
    from repro_torch.core import commcheck, detect, whatif
    from repro_torch.core.events import Trace
    from repro_torch.core.session import TraceSession
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    glm, glm_spec = rt.kept["trace"]
    ib_mesh = rt.MeshSpec(glm_spec.shape, glm_spec.axes, {"data": "ib", "model": "nvlink"})
    ib_store = timed("reannotate", lambda: whatif.reannotate(
        glm.store, whatif.Scenario("data-ib", axis_kind={"data": "ib"}), glm_spec, rt.H100))
    glm_ib = Trace.from_store(f"{glm.label} data on IB", glm.mesh_shape, glm.mesh_axes,
                              glm.num_devices, ib_store, op_stats=glm.op_stats,
                              hlo_flops=glm.hlo_flops,
                              per_device_memory_bytes=glm.per_device_memory_bytes,
                              argument_bytes=glm.argument_bytes)
    sort, einsum = rt.kept["moe sort"][0], rt.kept["moe einsum"][0]
    sess = TraceSession("chip-smoke", [glm, glm_ib, sort, einsum])
    SESSION_DIR.mkdir(parents=True, exist_ok=True)
    want = (sess.labels(), sess.totals(), sess.table())
    sizes = {}
    for name, compress, mmap in (("session.json", True, False), ("session.npz", True, False),
                                 ("session_raw.npz", False, True)):
        path = str(SESSION_DIR / name)
        timed(f"save {name}", lambda: sess.save(path, compress=compress))
        got = timed(f"load {name}", lambda: TraceSession.load(path, mmap=mmap))
        sizes[name] = os.path.getsize(path)
        check((got.labels(), got.totals(), got.table()) == want, f"{name} reloads differently")
        check([t.store.n for t in got] == [t.store.n for t in sess]
              and [int(t.store.multiplicity.sum()) for t in got]
              == [int(t.store.multiplicity.sum()) for t in sess], f"{name}: site counts")
    diff = timed("diff", lambda: sess.diff(einsum.label, sort.label, by="sem_kind_link"))
    print("[session] diff einsum -> sort by (semantic, kind, link):")
    for line in diff.splitlines():
        print("[session]   " + line)
    lint = timed("commcheck", lambda: {t.label: commcheck.check_trace(t) for t in sess})
    found = timed("detect", lambda: {t.label: detect.run_all(t) for t in sess})
    for label in sess.labels():
        print(f"[session] {label}: commcheck {[f.detector for f in lint[label]]}; detectors "
              f"{[(f.detector, f.severity, round(f.est_saved_s * 1e3, 4)) for f in found[label]]}")
    xnode = [f for f in found[glm_ib.label] if f.detector == "cross_node_bulk"]
    saving = whatif.ib_saving(glm_ib.store, ib_mesh, rt.H100)
    check(len(xnode) == 1 and xnode[0].est_saved_s == saving > 0,
          f"data on IB: cross_node_bulk {xnode}, ib_saving {saving}")
    check(not any(f.detector == "cross_node_bulk" for f in found[glm.label]),
          "cross_node_bulk on the NVLink trace")
    sweeps = timed("whatif", lambda: {
        "nvlink": whatif.sweep(glm.store, glm_spec), "ib": whatif.sweep(glm_ib.store, ib_mesh)})
    names = {k: [r.scenario.name for r in v] for k, v in sweeps.items()}
    check("ib-2x" in names["ib"] and "ib-2x" not in names["nvlink"], f"what-if tiers {names}")
    for k, v in sweeps.items():
        print(f"[session] what-if ({k}): " + ", ".join(
            f"{r.scenario.name} {r.saved_s * 1e3:.3f} ms" for r in v))

    def reports():
        for i, t in enumerate(sess):
            for fmt in ("html", "json"):
                path = SESSION_DIR / f"report_{i}.{fmt}"
                with open(path, "w") as fp:
                    sess.report(t.label, fmt=fmt, fp=fp)
                sizes[path.name] = os.path.getsize(path)
    timed("reports", reports)
    res = dict(labels=sess.labels(), totals=sess.totals(), file_bytes=sizes, host_s=secs,
               ib_saving_ms=saving * 1e3, whatif=names,
               lint={k: [f.detector for f in v] for k, v in lint.items()},
               detect={k: [f.detector for f in v] for k, v in found.items()})
    print("[session] result " + json.dumps(res))


def site_table(trace):
    """A trace's sites as comparable rows: (op_name, kind, replica groups, operand
    bytes, dtype, multiplicity), sorted."""
    return sorted((e.op_name, e.kind, str(e.replica_groups), e.operand_bytes, e.dtype,
                   e.multiplicity) for e in trace.events)


def fidelity(rt, name, real, fake, launches_fake, mem_model, secs):
    """Check a fake trace against the real one (equal sites and FLOPs, no launch
    in the fake run) and print both peaks beside the analytic memory model."""
    same_sites = site_table(fake) == site_table(real)
    same_flops = fake.hlo_flops == real.hlo_flops
    res = dict(step=name, sites=fake.sites, multiplicity=sum(e.multiplicity for e in fake.events),
               sites_equal=same_sites, rank_gflop=fake.hlo_flops / 1e9,
               real_rank_gflop=real.hlo_flops / 1e9, flops_equal=same_flops,
               gb_accessed=fake.hlo_bytes / 1e9, real_gb_accessed=real.hlo_bytes / 1e9,
               gb_accessed_unfused=fake.hlo_bytes_unfused / 1e9,
               real_gb_accessed_unfused=real.hlo_bytes_unfused / 1e9,
               fake_peak_gb=fake.per_device_memory_bytes / 1e9,
               real_peak_gb=real.per_device_memory_bytes / 1e9,
               mem_model_gb=mem_model / 1e9, fake_s=secs, launches_fake=launches_fake)
    print(f"[dryrun] {name}: fake vs real: {fake.sites} sites, equal {same_sites}; "
          f"{fake.hlo_flops / 1e9:.1f} GFLOP, equal {same_flops}; peak GB: fake "
          f"{res['fake_peak_gb']:.2f}, real (max_memory_allocated) {res['real_peak_gb']:.2f}, "
          f"analytic_memory_bytes {res['mem_model_gb']:.2f}; fake run {secs:.1f} s")
    print("[dryrun] fidelity " + json.dumps(res))
    if not same_sites:
        for row in sorted(set(site_table(fake)) ^ set(site_table(real)))[:12]:
            print(f"[dryrun]   differs: {'fake' if row in site_table(fake) else 'real'} {row}")
    check(same_sites, f"{name}: fake and real site tables differ")
    check(same_flops, f"{name}: fake {fake.hlo_flops} vs real {real.hlo_flops} FLOPs")
    check(all(n == 0 for n in launches_fake.values()), f"{name}: the fake run launched "
                                                       f"{launches_fake}")


def dryrun_phase(rt):
    """The dry-run (see the module's docstring): (a) fake against real, for
    [trace]'s step and for the fidelity prefill; (b) the fidelity prefill on a
    one-rank nccl mesh against the straight prefill; (c) DRYRUN_CELLS on the
    production mesh.  Returns the launches of its real prefills."""
    torch, dr, sh = rt.torch, rt.dryrun, rt.sharding
    # (a) [trace]'s chatglm3-6b train step, its real capture against a fake one
    real, _ = rt.kept["trace"]
    cfg = rt.get_config(TRACE["arch"])
    mesh, spec = rt.make_host_mesh(TRACE["mesh"], ("data", "model"), backend="fake",
                                   device=rt.device)
    shape = rt.ShapeSpec("trace", "train", TRACE["S"], TRACE["B"])
    st = rt.StepSettings(accum=2, remat="full")
    zero_counts(rt.counters)
    fake, _, secs = dr.trace_cell(cfg, shape, st, mesh, spec, fake=True)
    mem = dr.analytic_memory_bytes(cfg, shape, st, mesh, dr.cell_rules(cfg, shape, st, mesh))
    fidelity(rt, f"{cfg.name} train {TRACE['B']} x {TRACE['S']}", real, fake,
             read_counts(rt.counters), mem["total_with_slack"], secs)

    # (a) the fidelity prefill: real (K1 and K2 on rank 0's shards) and fake
    cfg = rt.get_config(FIDELITY["arch"])
    shape = rt.ShapeSpec("fidelity", "prefill", FIDELITY["S"], FIDELITY["B"])
    st = rt.StepSettings(accum=1, remat="none", attn_impl="flash")
    zero_counts(rt.counters)
    real, _, real_s = dr.trace_cell(cfg, shape, st, mesh, spec, fake=False)
    torch.cuda.synchronize()
    launches = read_counts(rt.counters)
    torch.cuda.empty_cache()
    zero_counts(rt.counters)
    fake, _, secs = dr.trace_cell(cfg, shape, st, mesh, spec, fake=True)
    mem = dr.analytic_memory_bytes(cfg, shape, st, mesh, dr.cell_rules(cfg, shape, st, mesh))
    print(f"[dryrun] {cfg.name} prefill {shape.global_batch} x {shape.seq_len}, rank 0 of "
          f"{FIDELITY['mesh']}: real run {real_s:.2f} s, launches {launches}")
    fidelity(rt, f"{cfg.name} prefill {shape.global_batch} x {shape.seq_len}", real, fake,
             read_counts(rt.counters), mem["total_with_slack"], secs)
    for kname, n in FIDELITY["per_prefill"].items():
        check(launches[kname] == n, f"fidelity prefill: {kname} {launches[kname]} != {n}")
    rt.dist.destroy_process_group()

    # (b) the same prefill on a one-rank nccl mesh against the straight one
    mesh_launches = {k: 0 for k in launches}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        B, S = FIDELITY["B"], FIDELITY["S"]
        prefill = rt.make_prefill_step(c, rt.StepSettings(attn_impl="flash"))
        batch = rt.api.demo_batch(c, B, S, seed=0)
        logits, cache = prefill(rt.api.init_params(c, 0), batch)
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), RANK="0",
                          WORLD_SIZE="1")
        one, _ = rt.make_host_mesh((1, 1), ("data", "model"), backend="nccl")
        params = sh.init_params(c, 0, one, dtype=getattr(torch, dtype),
                                rules=sh.serve_rules_for(c, one))
        bshape = rt.ShapeSpec("fidelity", "prefill", S, B)
        mbatch = rt.shard_batch({k: v.cpu().numpy() for k, v in batch.items()}, one,
                                {k: sh.placements_for(p, one)
                                 for k, p in sh.batch_pspecs(c, bshape, one).items()})
        zero_counts(rt.counters)
        with rt.activation_sharding(one):
            m_logits, m_cache = prefill(params, mbatch)
        torch.cuda.synchronize()
        got = read_counts(rt.counters)
        kernel = "flash_attention/" + rt.counters["flash_attention"].kernel_for(
            getattr(torch, dtype), c.head_dim)
        per_layer = FIDELITY["per_prefill"]["flash_attention"]
        check(got["flash_attention"] == got[kernel] == got["mamba_scan"]
              == got["mamba_scan/fused"] == per_layer,
              f"mesh prefill {dtype}: launches {got}, {kernel} and fused K2 {per_layer} each")
        for kname, n in got.items():
            mesh_launches[kname] += n
        pairs = [("logits", m_logits, logits)] + [(k, m_cache[k], cache[k]) for k in cache]
        errs = {}
        for name, a, b in pairs:
            a = sh.full_tensor(a).float()
            b = b.float()
            diff = (a - b).abs()
            errs[name] = dict(rel=float(diff.max() / (b.abs().max() + 1e-6)),
                              max_abs=float(diff.max()),
                              bf16_steps=float((diff / (BF16_STEP * b.abs() + BF16_FLOOR)).max()))
        print(f"[dryrun] {c.name} prefill {B} x {S} {dtype} on a one-rank nccl mesh vs the "
              f"straight prefill: " + json.dumps(errs))
        check(rt.dist.get_backend() == "nccl", "the mesh prefill did not run on nccl")
        rt.dist.destroy_process_group()
        for name, e in errs.items():
            if dtype == "float32":
                check(e["rel"] < FP32_TOL, f"mesh prefill {name} fp32: {e['rel']}")
            else:
                check(e["max_abs"] < BF16_MESH_ABS and e["bf16_steps"] <= BF16_MAX_STEPS,
                      f"mesh prefill {name} bf16: {e}")
        del params, mbatch, m_logits, m_cache, logits, cache, batch
        torch.cuda.empty_cache()

    # (c) the cells on the production mesh, fake tensors on the card, in worker
    # processes (each its own fake group; launches counted in each)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=ctx) as pool:
        rows = list(pool.map(dryrun_cell, DRYRUN_CELLS, [rt.device] * len(DRYRUN_CELLS)))
    for r in rows:
        depth = f" ({r['layers']} layers)" if r["layers"] else ""
        print(f"[dryrun] {r['arch']} {r['shape']} {r['mesh']}{depth}: fake run {r['lower_s']} s, "
              f"{r['n_collectives']} collectives ({r['sites']} sites), "
              f"{r['collective_bytes_per_dev'] / 1e9:.3f} GB; compute {r['compute_ms']:.2f} / "
              f"memory {r['memory_ms']:.2f} / collective {r['collective_ms']:.2f} ms, dominant "
              f"{r['dominant']}, mfu_bound {r['mfu_bound']:.3f}; mem model "
              f"{r['mem_model_gb']:.2f} GB, fits 80 GB {r['fits_hbm']}, fake peak "
              f"{r['mem_gb_per_dev']:.2f} GB", flush=True)
    print("[dryrun] result " + json.dumps(dict(cells=rows, sweep_s=time.perf_counter() - t0)))
    for r in rows:
        name = f"{r['arch']} {r['shape']} {r['mesh']}"
        check(r["n_collectives"] > 0, f"{name}: no collective")
        check(r["cache_gathers"] == 0, f"{name}: the decode cache is gathered")
        check(all(n == 0 for n in r["launches"].values()), f"{name} launched {r['launches']}")
    return {k: launches[k] + mesh_launches[k] for k in launches}


def dryrun_cell(cell, device):
    """One DRYRUN_CELLS row in a worker process: `dryrun.lower_cell` on the
    production mesh; its row with its sites, GB accessed, launches and the
    decode cache's gathers."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_spec
    arch, shape, multi_pod, layers = cell
    cfg = get_config(arch)
    over = {"num_layers": layers} if layers else None
    counters = {"flash_attention": fa, "mamba_scan": ms}
    zero_counts(counters)
    r = dryrun.lower_cell(arch, shape, multi_pod=multi_pod, device=device, cfg_overrides=over)
    tr = r.pop("trace")
    gathers = dryrun.cache_gathers(tr, cfg.replace(**(over or {})), SHAPES[shape],
                                   make_mesh_spec(multi_pod=multi_pod)) \
        if SHAPES[shape].kind == "decode" else []
    r.update(layers=layers, sites=tr.sites, gb_accessed=tr.hlo_bytes / 1e9,
             cache_gathers=len(gathers), launches=read_counts(counters))
    return r


def collective_signature(alg, n, elements, esize):
    """The reference algorithm's signature on an (n,) mesh, from its semantics:
    [(kind, scope, multiplicity, operand bytes, pairs or None)].  The capture
    records an op's input, but an all-gather's gathered output: the ring's hop
    carries the padded payload / n, the reduce-scatter takes the padded
    payload and the all-gather gives it back whole."""
    chunk = -(-elements // n) * esize
    ring = [(i, (i + 1) % n) for i in range(n)]
    return {
        "builtin": [("all-reduce", "", 1, elements * esize, None)],
        "ring": [("collective-permute", "ring_rs_hop", n - 1, chunk, ring),
                 ("collective-permute", "ring_ag_hop", n - 1, chunk, ring)],
        "rsag": [("reduce-scatter", "rsag_rs", 1, chunk * n, None),
                 ("all-gather", "rsag_ag", 1, chunk * n, None)],
        "recursive_doubling": [("collective-permute", f"recdbl_round{k}", 1, elements * esize,
                                [(i, i ^ (1 << k)) for i in range(n)])
                               for k in range(int(math.log2(n)))],
    }[alg]


def collectives_phase(rt):
    """Each all-reduce algorithm of distributed/algorithms.py as rank 0 of an (8,)
    ("data",) mesh under the fake process group, on the card (see COLLECTIVES): its
    capture against the reference's signature, finite outputs, no kernel launch;
    the rank-local ms (CUDA events), the modelled us on NVLink and with `data` on
    InfiniBand, and costmodel.allreduce_time's closed form beside each."""
    torch, core, cm = rt.torch, rt.core, rt.costmodel
    n = COLLECTIVES["mesh"][0]
    mesh, spec = rt.make_host_mesh(COLLECTIVES["mesh"], ("data",), backend="fake",
                                   device=rt.device)
    ib = rt.MeshSpec(spec.shape, spec.axes, axis_kind={"data": "ib"})
    links = {"nvlink": (rt.H100.nvlink_bw, rt.H100.nvlink_latency_s),
             "ib": (rt.H100.ib_bw, rt.H100.ib_latency_s)}
    grad = rt.api.param_count(rt.get_config(COLLECTIVES["grad_arch"]))
    rows = []
    for elements, dtype in COLLECTIVES["sizes"]:
        elements = elements or grad
        x = torch.randn(elements, generator=torch.Generator(rt.device).manual_seed(0),
                        device=rt.device, dtype=getattr(torch, dtype))
        nbytes = x.numel() * x.element_size()
        for alg in rt.algorithms.ALGORITHMS:
            fn = rt.algorithms.allreduce_fn(alg, mesh, "data")
            zero_counts(rt.counters)
            tr = core.trace_step(fn, (x,), mesh, spec, label=alg)
            y = fn(x)
            torch.cuda.synchronize()
            launches = read_counts(rt.counters)
            check(all(v == 0 for v in launches.values()), f"{alg} launched kernels {launches}")
            check(bool(torch.isfinite(y).all()), f"{alg}: non-finite output")
            del y
            got = [(e.kind, e.op_name.rsplit("/", 1)[0] if "/" in e.op_name else "",
                    e.multiplicity, e.operand_bytes,
                    [tuple(p) for p in e.source_target_pairs] if e.source_target_pairs else None)
                   for e in tr.events]
            want = collective_signature(alg, n, elements, x.element_size())
            check(got == want, f"{alg} at {nbytes} B: signature {got[:4]} != {want[:4]}")
            check(all(e.group_size == n and e.link_class == "nvlink.data" for e in tr.events),
                  f"{alg}: groups or links {[(e.group_size, e.link_class) for e in tr.events]}")
            ms = cuda_ms(torch, lambda: fn(x), COLLECTIVES["iters"])
            ib_store = tr.store.annotation_clone()
            cm.annotate_store(ib_store, ib, rt.H100)
            model = {"nvlink": tr.total_est_time_s(), "ib": float(ib_store.total_est_time_s())}
            closed = {k: cm.allreduce_time(CLOSED_FORM[alg], nbytes, n, *links[k], rt.H100)
                      for k in links}
            row = dict(algorithm=alg, bytes=nbytes, dtype=dtype, ms=ms,
                       model_us_nvlink=model["nvlink"] * 1e6, model_us_ib=model["ib"] * 1e6,
                       closed_us_nvlink=closed["nvlink"] * 1e6, closed_us_ib=closed["ib"] * 1e6,
                       sites=[(k, sc, m, ob) for k, sc, m, ob, _ in got])
            rows.append(row)
            print("[collectives] " + json.dumps(row))
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
    rt.dist.destroy_process_group()
    print(f"[collectives] result {len(rows)} runs, rank 0 of {COLLECTIVES['mesh']} under the "
          f"fake process group, no kernel launched")


def _stacked_stages(rt, layers, stages):
    """The layers' params as one tree whose leaves are [stages, layers a stage, ...]."""
    per = len(layers) // stages
    return rt.tree_map(lambda *ts: rt.torch.stack(ts).reshape(stages, per, *ts[0].shape),
                       *layers)


def pipeline_phase(rt):
    """The GPipe pipeline of distributed/pipeline.py with chatglm3-6b's layers at full
    width (see PIPELINE): (a) P stages, rank 0 under the fake group, captured; (b) one
    stage of every layer on a one-rank nccl mesh against the straight layers, bit
    for bit.  Returns the launches of both runs."""
    torch, pp = rt.torch, rt.pipeline
    cfg = rt.get_config(PIPELINE["arch"])
    P, M, mb, S = PIPELINE["P"], PIPELINE["M"], PIPELINE["mb"], PIPELINE["S"]
    nl = cfg.num_layers
    params = rt.api.init_params(cfg, 0)
    layers = params["layers"]
    del params
    positions = torch.arange(S, device=rt.device, dtype=torch.int32)[None].expand(mb, S)
    gen = torch.Generator(rt.device).manual_seed(0)

    def stage_fn(p, h):
        n = rt.tree_leaves(p)[0].shape[0]
        stage_layers = [rt.tree_map(lambda a: a[i], p) for i in range(n)]
        return rt.transformer.apply_layers(cfg.replace(num_layers=n), stage_layers, h,
                                           positions, attn_impl="flash")[0]

    kernel = "flash_attention/" + rt.counters["flash_attention"].kernel_for(
        torch.bfloat16, cfg.head_dim)
    # (a) P stages over (P,) ("model",); rank 0 holds stage 0's rows only
    mesh, spec = rt.make_host_mesh((P,), ("model",), backend="fake", device=rt.device)
    per = nl // P
    local = _stacked_stages(rt, layers[:per], 1)
    stage_params = rt.tree_map(lambda a: rt.DTensor.from_local(a, mesh, [rt.Shard(0)]), local)
    x = torch.randn((M, mb, S, cfg.d_model), generator=gen, device=rt.device,
                    dtype=torch.bfloat16)
    run = lambda w, h: pp.pipeline_apply(stage_fn, w, h, mesh, axis="model")
    with torch.inference_mode():
        zero_counts(rt.counters)
        tr = rt.core.trace_step(run, (stage_params, x), mesh, spec, label="pipeline")
        torch.cuda.synchronize()
        launches_a = read_counts(rt.counters)
        ticks = M + P - 1
        check(launches_a[kernel] == per * ticks == launches_a["flash_attention"],
              f"pipeline (a): {launches_a} != {per} layers x {ticks} ticks of {kernel}")
        check(launches_a["mamba_scan"] == 0, f"pipeline (a) launched K2: {launches_a}")
        y = run(stage_params, x)
        check(bool(torch.isfinite(y).all()) and tuple(y.shape) == tuple(x.shape),
              f"pipeline (a): output {tuple(y.shape)} not finite or not {tuple(x.shape)}")
        del y
        ms = cuda_ms(torch, lambda: run(stage_params, x), PIPELINE["iters"])
    hops = [e for e in tr.events if e.kind == "collective-permute"]
    ars = [e for e in tr.events if e.kind == "all-reduce"]
    hop_bytes = mb * S * cfg.d_model * 2
    check(sum(e.multiplicity for e in hops) == M + P - 2 and
          all(e.operand_bytes == hop_bytes and e.semantic == "pipeline" and
              [tuple(p) for p in e.source_target_pairs] == [(i, i + 1) for i in range(P - 1)]
              for e in hops),
          f"pipeline hops {[(e.multiplicity, e.operand_bytes, e.semantic) for e in hops]}")
    check(len(ars) == 1 and ars[0].multiplicity == 1 and ars[0].operand_bytes == M * hop_bytes,
          f"pipeline all-reduce {[(e.multiplicity, e.operand_bytes) for e in ars]}")
    check(len(tr.events) == len(hops) + 1, f"pipeline sites {[e.kind for e in tr.events]}")
    ib_store = tr.store.annotation_clone()
    rt.costmodel.annotate_store(ib_store, rt.MeshSpec(spec.shape, spec.axes,
                                                      axis_kind={"model": "ib"}), rt.H100)
    hop_ib = [r for r in ib_store.rows() if r.kind == "collective-permute"][0]
    res_a = dict(arch=cfg.name, P=P, M=M, mb=mb, S=S, layers_a_stage=per, ms=ms,
                 tick_ms=ms / ticks, bubble_fraction=pp.bubble_fraction(M, P),
                 hop_bytes=hop_bytes, hop_us_nvlink=hops[0].est_time_s * 1e6,
                 hop_us_model_ib=hop_ib.est_time_s * 1e6,
                 all_reduce_us_nvlink=ars[0].est_time_s * 1e6, launches=launches_a)
    print("[pipeline] (a) " + json.dumps(res_a))
    del stage_params, local, x, tr
    torch.cuda.empty_cache()
    rt.dist.destroy_process_group()

    # (b) one stage of every layer on a one-rank nccl mesh, against the straight layers
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), RANK="0",
                      WORLD_SIZE="1")
    one, _ = rt.make_host_mesh((1,), ("model",), backend="nccl")
    M1 = PIPELINE["M_ONE"]
    x = torch.randn((M1, mb, S, cfg.d_model), generator=gen, device=rt.device,
                    dtype=torch.bfloat16)
    whole = _stacked_stages(rt, layers, 1)
    with torch.inference_mode():
        zero_counts(rt.counters)
        y = pp.pipeline_apply(stage_fn, whole, x, one, axis="model")
        torch.cuda.synchronize()
        launches_b = read_counts(rt.counters)
        straight = torch.stack([rt.transformer.apply_layers(cfg, layers, x[i], positions,
                                                            attn_impl="flash")[0]
                                for i in range(M1)])
    check(rt.dist.get_backend() == "nccl", "pipeline (b) did not run on an nccl group")
    check(launches_b[kernel] == nl * M1 == launches_b["flash_attention"],
          f"pipeline (b): {launches_b} != {nl} layers x {M1} micro-batches")
    same = bool(torch.equal(y, straight))
    print("[pipeline] (b) " + json.dumps(dict(arch=cfg.name, layers=nl, M=M1, bitwise=same,
                                              max_abs=float((y.float() - straight.float())
                                                            .abs().max()),
                                              launches=launches_b)))
    check(same, "pipeline (b): one stage differs from the straight layers")
    del whole, layers, x, y, straight
    torch.cuda.empty_cache()
    rt.dist.destroy_process_group()
    return {k: launches_a[k] + launches_b[k] for k in launches_a}


def ring_cache(rt):
    """The windowed ring cache at full width: h2o-danube-3-4b with its window cut to
    RING's, fp32 compute and fp32 caches, one ring of `window` slots against one full
    cache, decoding the same tokens from empty caches; once the ring has wrapped
    (step >= window) their logits must agree within FP32_TOL."""
    torch, api, T = rt.torch, rt.api, rt.transformer
    cfg = rt.get_config(RING["arch"]).replace(window=RING["window"], num_layers=RING["layers"],
                                              compute_dtype="float32")
    B, steps, w = RING["B"], RING["steps"], RING["window"]
    params = api.init_params(cfg, 0)
    toks = api.demo_batch(cfg, B, steps, seed=2)["tokens"]
    ring = T.init_cache(cfg, B, steps, windowed=True, dtype=torch.float32, device=toks.device)
    full = T.init_cache(cfg, B, steps, windowed=False, dtype=torch.float32, device=toks.device)
    check(ring["k"].shape[2] == w and full["k"].shape[2] == steps,
          f"ring {tuple(ring['k'].shape)}, full {tuple(full['k'].shape)}")
    decode = rt.make_decode_step(cfg)
    errs = []
    for t in range(steps):
        lr, ring = decode(params, ring, toks[:, t:t + 1], t)
        lf, full = decode(params, full, toks[:, t:t + 1], t)
        errs.append(rel(torch, lr, lf))
    warm = max(errs[w:])
    print(f"[ring] {cfg.name} window {w}, {cfg.num_layers} layers, B={B}, {steps} steps, fp32: "
          f"ring vs full max rel {warm:.3e} from step {w} (before it {max(errs[:w]):.3e}), "
          f"limit {FP32_TOL}")
    check(warm < FP32_TOL, f"ring cache vs full cache: {warm}")
    del params, ring, full
    torch.cuda.empty_cache()


def kernels_line(main_launches, variant_path, scan_variants):
    """The `{"kernels": [...]}` entries: K1's bf16 wgmma kernel at chatglm3-6b's
    path shape, K1's 3xTF32 kernel at hymba-1.5b's fp32 mesh prefill's global
    shape, and K2 with its fused entry point at falcon-mamba-7b's; each with its
    main-path launches, and its other shapes (K2: both entry points) beside."""
    def at(shapes):
        return {where: dict(case=r["case"], max_abs_err=max(r["max_abs_err"],
                                                            r.get("h_max_abs_err", 0.0)),
                            bf16_steps=r.get("bf16_steps"), ms=r["kernel_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            bound_simt_ms=r.get("bound_simt_ms"),
                            tflops=r.get("tflops"), chunks=r.get("chunks"))
                for where, r in shapes.items()}

    def entry(name, source, replaces, launches, r, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches,
                    max_abs_err=max(r["max_abs_err"], r.get("h_max_abs_err", 0.0)),
                    ms=r["kernel_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"], **extra)

    fa_src, fa_tpu = ("src/repro_torch/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:30")
    bf16 = variant_path["tensor_core"]
    fp32 = variant_path["tensor_core_fp32"]
    return [
        entry("flash_attention", fa_src, fa_tpu, main_launches["flash_attention/tensor_core"],
              bf16["chatglm3-6b"], variant="tensor_core", kernel="flash_fwd_wgmma_kernel",
              at=at(bf16)),
        entry("flash_attention_fp32", fa_src, fa_tpu,
              main_launches["flash_attention/tensor_core_fp32"],
              fp32["hymba-1.5b fp32 mesh prefill, global"], variant="tensor_core_fp32",
              kernel="flash_fwd_tf32x3_kernel", at=at(fp32)),
        entry("mamba_scan", "src/repro_torch/csrc/mamba_scan.cu",
              "src/repro/kernels/mamba_scan.py:24", main_launches["mamba_scan"],
              scan_variants["fused"]["falcon-mamba-7b"], variant="fused",
              kernel="mamba_scan_fused_kernel",
              variants={v: dict(launches=main_launches[f"mamba_scan/{v}"], at=at(shapes))
                        for v, shapes in scan_variants.items()})]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="drive the port on one CUDA card")
    ap.add_argument("--only", choices=("kernel", "train"), default=None,
                    help="kernel: stop after the kernels' phase (build, and each kernel "
                         "against its plain version with its times); train: build, then "
                         "the train phases and [shard] alone")
    args = ap.parse_args(argv)
    # a fixed cuBLAS workspace, set before cuBLAS starts: the train phase's
    # deterministic algorithms require it (32 MiB, H100's default size in PyTorch)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    from repro_torch.launch.presets import StepSettings
    from repro_torch.launch.serve import BatchedServer, Request
    import torch.distributed as dist
    from repro_torch import checkpoint, core
    from repro_torch.core import costmodel
    from repro_torch.core.roofline import roofline
    from repro_torch.core.topology import H100, MeshSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch, to_device
    from repro_torch.distributed import sharding
    from repro_torch.distributed.autoshard import activation_sharding
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_mesh_spec
    from repro_torch.optim import adamw
    from repro_torch.launch.steps import (make_decode_step, make_eval_step, make_prefill_step,
                                          make_train_step)
    from repro_torch.launch.train import Trainer
    from repro_torch.models import api, losses, moe, transformer
    from repro_torch.models.meta import leaves, materialize, tree_map_meta
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.distributed import algorithms, pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    counters = {"flash_attention": fa, "mamba_scan": ms}
    rt = SimpleNamespace(torch=torch, np=np, api=api, get_config=get_config, kept={},
                         device="cuda",
                         make_prefill_step=make_prefill_step,
                         make_decode_step=make_decode_step, StepSettings=StepSettings,
                         BatchedServer=BatchedServer, Request=Request, counters=counters,
                         ShapeSpec=ShapeSpec, transformer=transformer, Trainer=Trainer,
                         make_eval_step=make_eval_step, make_train_step=make_train_step,
                         to_device=to_device, checkpoint=checkpoint, leaves=leaves,
                         dist=dist, core=core, costmodel=costmodel, roofline=roofline,
                         H100=H100, MeshSpec=MeshSpec, DataConfig=DataConfig,
                         SyntheticTokens=SyntheticTokens, shard_batch=shard_batch,
                         sharding=sharding, activation_sharding=activation_sharding,
                         make_host_mesh=make_host_mesh, adamw=adamw, losses=losses, moe=moe,
                         materialize=materialize, tree_map_meta=tree_map_meta,
                         distribute_tensor=distribute_tensor, Shard=Shard,
                         Replicate=Replicate, dryrun=dryrun, configs=configs,
                         make_mesh_spec=make_mesh_spec, DTensor=DTensor,
                         algorithms=algorithms, pipeline=pipeline, tree_map=tree_map,
                         tree_leaves=tree_leaves)

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} python {sys.version.split()[0]}")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    built = build_all(build, {kname: mod.SOURCE for kname, mod in counters.items()})
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.1f}s")
    for kname, (secs, report) in built.items():
        print(f"[build] {kname}: {secs:.1f}s -> {build.library_path(counters[kname].SOURCE)}")
        for line in report.splitlines():
            if any(word in line for word in ("entry function", "registers", "spill",
                                             "arning")):
                print(f"[build]   {line.strip()[:160]}")
        for entry in spilling(report):
            check("wgmma" not in entry, f"ptxas reports spills in {entry}")

    if args.only == "train":
        for spec in TRAINS:
            train_model(rt, spec)
        shard_phase(rt)
        print(f"[done] train phases only, {time.perf_counter() - t_start:.1f}s")
        print(smi)
        return 0

    # 3. kernels vs plain versions
    results = [flash_case(torch, F, fa, ref, case, seed=i) for i, case in enumerate(FLASH_CASES)]
    results.append(flash_case(torch, F, fa, ref, (1, 2, 2, 256, 128, True, 0, "float32", 2e-5),
                              seed=100, q_offset=128))
    results.append(flash_case(torch, F, fa, ref, (1, 4, 2, 128, 120, True, 0, "float32", 2e-5),
                              seed=101, layout="bshd"))
    results.append(flash_case(torch, F, fa, ref, BF16_WIDE_CASE, seed=105))
    results.append(flash_case(torch, F, fa, ref, BF16_PAD_CASE, seed=106, layout="bshd"))
    fp32_paths = [flash_case(torch, F, fa, ref, case, seed=(107, 120, 121)[i], layout="bshd")
                  for i, case in enumerate(FP32_PATH_CASES)]
    results += fp32_paths
    results += [flash_case(torch, F, fa, ref, case, seed=300 + i, layout=layout,
                           q_offset=q_offset)
                for i, (case, layout, q_offset) in enumerate(FP32_HEAD_DIM_CASES)]
    results += [flash_case(torch, F, fa, ref, case, seed=102 + i, layout="bshd")
                for i, case in enumerate(PATH_SHAPES)]
    print(f"[kernel] bounds use H100 SXM data-sheet rates: {PEAK_BYTES / 1e12} TB/s, "
          f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16, "
          f"{PEAK_3XTF32 / 1e12:.0f} TFLOP/s fp32 as 3xTF32 (K1's fp32 bound), "
          f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s fp32 FFMA (K2's bound, K1's "
          f"bound_simt_ms) (dense, 700 W)")
    for r in results:
        print("[kernel] " + json.dumps(r))
    path_results = dict(zip(PATH_SHAPES, results[-len(PATH_SHAPES):]))
    # the kernels' line reports the tensor-core K1 kernel at chatglm3-6b's and
    # gemma3-4b's global shapes and hymba-1.5b's rank shard, the 3xTF32 one (fp32
    # only) at gemma3-4b's fp32 check's and hymba-1.5b's fp32 mesh prefill's
    variant_path = {"tensor_core": {"chatglm3-6b": path_results[PATH_SHAPES[0]],
                                    "gemma3-4b global": path_results[PATH_SHAPES[6]],
                                    "hymba-1.5b rank shard, window 1024":
                                        path_results[PATH_SHAPES[8]],
                                    "hymba-1.5b rank shard, global":
                                        path_results[PATH_SHAPES[9]]},
                    "tensor_core_fp32": {"gemma3-4b global, fp32 check": fp32_paths[0],
                                         "hymba-1.5b fp32 mesh prefill, window 1024":
                                             fp32_paths[1],
                                         "hymba-1.5b fp32 mesh prefill, global":
                                             fp32_paths[2]}}
    scans = [scan_case(torch, ms, ref, case, seed=200 + i)
             for i, case in enumerate(SCAN_CASES + SCAN_PATH_SHAPES)]
    for r in scans:
        print("[kernel] mamba_scan " + json.dumps(r))
    fused = [fused_scan_case(torch, ms, ref, case, seed=220 + i, x_dtype=x_dtype)
             for i, case in enumerate(SCAN_CASES + SCAN_PATH_SHAPES + SCAN_CHUNKED_CASES)
             for x_dtype in ("bfloat16", "float32")]
    for r in fused:
        print("[kernel] mamba_scan_fused " + json.dumps(r))
    check(any(r["chunks"] > 1 for r in fused), "no fused K2 case took the chunked branch")
    # the kernels' line reports both K2 entry points at the path shapes: the unfused one
    # on a_bar/bx in fp32, the fused one with bf16 x, as the bf16 prefills run it
    unfused_at = dict(zip(SCAN_PATH_SHAPES, scans[len(SCAN_CASES):]))
    fused_at = {tuple(r["case"]): r for r in fused if r["x_dtype"] == "bfloat16"}
    scan_where = {"falcon-mamba-7b": SCAN_PATH_SHAPES[0], "hymba-1.5b": SCAN_PATH_SHAPES[1],
                  "hymba-1.5b rank shard": SCAN_PATH_SHAPES[2]}
    scan_variants = {"fused": {w: fused_at[c] for w, c in scan_where.items()},
                     "unfused": {w: unfused_at[c] for w, c in scan_where.items()}}
    print(f"[kernel] mamba_scan library_ms null: {SCAN_NO_LIBRARY}")
    torch.cuda.empty_cache()
    if args.only == "kernel":
        print(f"[done] kernels only, {time.perf_counter() - t_start:.1f}s")
        print(smi)
        return 0

    t_lap = [t_start]

    def lap(name):
        """Print the seconds since the last lap: the phases' share of the time limit."""
        now = time.perf_counter()
        print(f"[time] {name}: {now - t_lap[0]:.1f}s")
        t_lap[0] = now

    lap("build and kernels")
    # 4-11. the models at full width, one at a time
    main_launches = {kname: 0 for kname in read_counts(counters)}
    for model in MODELS:
        for kname, n in serve_model(rt, model).items():
            main_launches[kname] += n
    lap("serve")

    # 12. the ring cache
    ring_cache(rt)
    lap("ring")

    # 13-16. training at full width
    print(f"[train] checkpoints under {CKPT_DIR}; disk free "
          f"{shutil.disk_usage(CKPT_DIR.parent if CKPT_DIR.parent.exists() else '.').free / 1e9:.0f} GB")
    for spec in TRAINS:
        for kname, n in train_model(rt, spec).items():
            main_launches[kname] += n
        lap(f"train {spec.arch}")

    # 17-21. the sharded train step: its capture, live ingest of its captures, and
    # one card's mesh against the straight Trainer; the MoE sort dispatch against the einsum dispatch, and
    # the captures of a sharded MoE step with each
    for phase in (trace_phase, ingest_phase, shard_phase, moe_phase, moe_trace_phase):
        for kname, n in phase(rt).items():
            main_launches[kname] += n
        lap(phase.__name__)

    # 22. the profiler's back half on the card's own traces
    session_phase(rt)
    lap("session_phase")

    # 23. the dry-run: fake against real, the prefill on a mesh, the production cells
    for kname, n in dryrun_phase(rt).items():
        main_launches[kname] += n
    lap("dryrun_phase")

    # 24-25. the all-reduce algorithms' captures; the GPipe pipeline of chatglm3-6b's layers
    collectives_phase(rt)
    lap("collectives_phase")
    for kname, n in pipeline_phase(rt).items():
        main_launches[kname] += n
    lap("pipeline_phase")

    # 26. results: launches are the main paths' (every MODELS row's two prefills, each
    # train phase's flash eval and straight run, with `ssm_inloop` too, the dry-run's
    # three real prefills on a mesh, the pipeline's two runs; the sharded, MoE, fake and
    # collective steps launch none)
    print(f"[done] main-path launches {main_launches}")

    kernels = kernels_line(main_launches, variant_path, scan_variants)
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
