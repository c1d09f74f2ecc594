"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``) for
attention and row-wise cosine, their plain PyTorch versions (``ref``) and
the dispatching entry points (``ops``)."""
