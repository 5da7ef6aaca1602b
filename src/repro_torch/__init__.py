"""PyTorch/CUDA port of the `repro` package, slice by slice.

The JAX package `repro` is the reference; this package imports nothing of it
and never imports jax.  Module names mirror the reference so each counterpart
is easy to find.  It covers serving (prefill, decode, `BatchedServer`) of
every decoder-only family and of the encoder-decoder (through `api.prefill`
and `api.decode_step`), and training on one card (`launch.train.Trainer`),
with flash attention and the Mamba selective scan as CUDA kernels.
"""
