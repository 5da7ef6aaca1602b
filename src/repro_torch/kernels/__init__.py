"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

build.py            — nvcc into build/repro_torch/ and ctypes loading, shared
flash_attention.py  — binding and kernel-layout wrapper of
                      csrc/flash_attention.cu (replaces the reference's
                      Pallas `repro/kernels/flash_attention.py`): bf16 runs
                      the tensor-core kernel (wgmma fed by TMA) at every head
                      dim up to 256, fp32 the 3xTF32 one (mma.sync, cp.async)
mamba_scan.py       — binding and wrappers of csrc/mamba_scan.cu (replaces
                      the reference's Pallas `repro/kernels/mamba_scan.py`):
                      the scan on a_bar/bx, and the fused one that makes them
                      in registers from delta, x, A, B (the model's path);
                      and of csrc/mamba_scan_train.cu, the fused scan's
                      differentiable twin for training (a forward that saves
                      chunk-start states and a backward kernel)
ops.py              — model-layout wrappers, and `launch_counts`, the
                      kernel modules' launch counters under one naming rule
ref.py              — plain PyTorch versions (the CPU path and the oracle),
                      and the plain differentiable training scans
                      (`scan_chunked`, `scan_inloop`)

K1 and K2's prefill entry points are forward only, as the reference's are;
their wrappers raise inside autograd.  Training runs K2's training pair on
the card and the plain scan of `ref.py` on the CPU.  No module here imports
the models.
"""
