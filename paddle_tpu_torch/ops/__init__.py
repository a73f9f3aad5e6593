"""Kernels of the port: each module holds a hand-written CUDA kernel's
wrapper, its plain PyTorch version and its launch counter; `build.py`
compiles the CUDA sources under `csrc/` at first use."""
