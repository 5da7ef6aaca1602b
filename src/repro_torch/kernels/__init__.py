"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

flash_attention.py  — build, ctypes binding and kernel-layout wrapper of
                      csrc/flash_attention.cu (replaces the reference's
                      Pallas `repro/kernels/flash_attention.py`)
ops.py              — model-layout wrapper ([B, S, H, Dh])
ref.py              — plain PyTorch versions (the CPU path and the oracle)
"""
