"""PyTorch / CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``repro``'s module names so each counterpart is easy to
find, but imports nothing from it: it keeps its own copies of the configs
and the tokenizer. Entry points default to ``device="cuda"``; they run on
the CPU only when the caller asks, with the kernels' plain versions.
"""
