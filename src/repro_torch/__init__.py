"""PyTorch + CUDA port of the MVDRAM reproduction.

Same module layout as the JAX package `repro`: every port module sits where
its JAX counterpart sits, keeps its function names and public layouts, and
runs on the GPU through hand-written CUDA kernels (`csrc/`). On CPU tensors
the kernel wrappers run their plain PyTorch versions instead, which is how
the tests compare the port with the JAX package.

This package imports `torch` and numpy only — never `jax` and nothing of
`repro`.
"""
