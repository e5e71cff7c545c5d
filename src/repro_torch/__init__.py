"""PyTorch / CUDA port of the ``repro`` package.

Mirrors ``repro``'s module names so each port sits at the same path as
its JAX counterpart.  Plain tensor code is PyTorch; every Pallas TPU
kernel on a ported path is a hand-written CUDA kernel for Hopper under
``kernels/csrc``.  The package imports neither JAX nor ``repro``.
"""
