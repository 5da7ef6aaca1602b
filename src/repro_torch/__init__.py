"""PyTorch/CUDA port of the `repro` package, slice by slice.

The JAX package `repro` is the reference; this package imports nothing of it
and never imports jax.  Module names mirror the reference so each counterpart
is easy to find.  It covers the serving path (prefill, decode,
`BatchedServer`) of the dense (chatglm3-6b), ssm (falcon-mamba-7b) and hybrid
(hymba-1.5b) families, with flash attention and the Mamba selective scan as
CUDA kernels.
"""
