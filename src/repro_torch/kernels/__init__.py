"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

build.py            — nvcc into build/repro_torch/ and ctypes loading, shared
flash_attention.py  — binding and kernel-layout wrapper of
                      csrc/flash_attention.cu (replaces the reference's
                      Pallas `repro/kernels/flash_attention.py`): bf16 runs
                      the tensor-core kernel (wgmma fed by TMA) at every head
                      dim up to 256, fp32 the CUDA-core one
mamba_scan.py       — binding and wrapper of csrc/mamba_scan.cu (replaces
                      the reference's Pallas `repro/kernels/mamba_scan.py`)
ops.py              — model-layout wrappers
ref.py              — plain PyTorch versions (the CPU path and the oracle)

Both kernels are forward only, as the reference's are; their wrappers raise
inside autograd, and training runs the plain paths.
"""
