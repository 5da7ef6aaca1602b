"""PyTorch/CUDA port of the `repro` package, slice by slice.

The JAX package `repro` is the reference; this package imports nothing of it
and never imports jax.  Module names mirror the reference so each counterpart
is easy to find.  This slice covers the dense decoder's serving path
(prefill, decode, `BatchedServer`) with flash attention as a CUDA kernel.
"""
