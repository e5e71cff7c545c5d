"""The port's kernels: hand-written CUDA sources under ``csrc/``, their
plain PyTorch versions, and the ops that dispatch between them."""
