"""Ops of the port. The kernel modules (`paged_attention.py`,
`rnn_kernels.py`) hold a hand-written CUDA kernel's wrapper, its plain
PyTorch version and its launch counter; `build.py` compiles the CUDA
sources under `csrc/` at first use. The others (`conv.py`,
`normalization.py`, `linalg.py`, `xent.py`, `sequence.py`, `rnn.py`,
`attention.py`, `ctc.py`, `crf.py`, `detection.py`, `mdlstm.py`) are torch
ops, as their counterparts are XLA ops."""
