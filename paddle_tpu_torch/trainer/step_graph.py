"""The training step as one CUDA graph.

The port's counterpart of the JAX trainer's compiled step (`_build_step`
jitted, in `paddle_tpu/trainer/trainer.py`) and of its K-step `lax.scan`
dispatch (`make_multi_step`). `SGDTrainer._step_body` — the forward, the
backward (`torch.autograd.grad`), the optimizer's in-place update and the
in-place write of the new states — is captured K times in a row with
`torch.cuda.CUDAGraph`, once per batch signature, and replayed, so a
dispatch costs the host the input copies, one replay and the costs' copy
instead of thousands of launches.

What makes the capture legal:
  * Static inputs: every slot of the batch has a device buffer of its
    shape and dtype (stacked [K, ...] for K steps), and the per-step lr is
    a [K] f32 buffer; `replay` copies the new values into them (host
    values through pinned buffers, which it rewrites only once the
    previous replay's copies have left them).
  * Static state: the parameters, the optimizer's slots and its step
    counter `t`, and the states are updated in their own storage
    (`Optimizer.update`, `SGDTrainer._step_body`), so the graph's pointers
    stay right. Whoever replaces their values copies into that storage
    (`SGDTrainer.load*`) and never rebinds it; `init_state` drops the
    graphs.
  * No host work inside: the step reads no device value on the host, and
    the kernels' plans, builds and attributes are cached by the warm-up
    (the trainer runs the first step of a signature eagerly, as a real
    step, before it captures).

Launch counts: the recurrent and attention wrappers count a call made
under capture in `rnn_kernels.CAPTURED`; each replay adds the calls its
capture recorded (`rnn_kernels.note_replay`), so "2 forward + 2 backward
GRU launches a step" reads the same under replay as eagerly.

CUDA only: the CPU has no graphs and the trainer runs the step eagerly
there. A failed capture raises; nothing drops back to eager on the card."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from paddle_tpu_torch.ops import rnn_kernels


class StepGraph:
    """`k` calls of `step_body(batch_i, lr_i)` captured as one graph on the
    calling thread; `example` holds the batch slots ([K, ...] stacked when
    k > 1, else one batch) whose shapes and dtypes the static buffers
    take."""

    def __init__(self, step_body: Callable[[Dict[str, torch.Tensor], torch.Tensor],
                                           torch.Tensor],
                 example: Mapping[str, Any], k: int, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"StepGraph needs a CUDA device, got {device}")
        self.k = k
        self.replays = 0
        self.inputs = {name: torch.empty(tuple(np.shape(v)), dtype=_dtype(v),
                                         device=device)
                       for name, v in example.items()}
        self.lrs = torch.zeros((k,), dtype=torch.float32, device=device)
        self._pinned = {name: torch.empty(v.shape, dtype=v.dtype).pin_memory()
                        for name, v in self.inputs.items()}
        self._lr_pinned = torch.zeros((k,), dtype=torch.float32).pin_memory()
        self._copied = torch.cuda.Event()
        batches = ([self.inputs] if k == 1 else
                   [{name: v[i] for name, v in self.inputs.items()} for i in range(k)])
        self.graph = torch.cuda.CUDAGraph()
        before = dict(rnn_kernels.CAPTURED)
        # thread_local: the checkpoint writer thread may wait on a CUDA
        # event meanwhile; the autograd thread's backward still records
        # into the capture stream
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.costs = torch.stack([step_body(b, self.lrs[i])
                                      for i, b in enumerate(batches)])
        self.kernel_calls = {name: n - before[name]
                             for name, n in rnn_kernels.CAPTURED.items()
                             if n != before[name]}

    def replay(self, batch: Mapping[str, Any], lrs) -> torch.Tensor:
        """K steps on `batch` (the slots as `example` laid them out) at the
        K learning rates `lrs` -> the K costs, copied out of the graph's
        static output (so the next replay leaves them alone)."""
        self._copied.synchronize()
        for name, dst in self.inputs.items():
            src = batch[name]
            if isinstance(src, torch.Tensor) and src.device.type == "cuda":
                dst.copy_(src)
                continue
            host = self._pinned[name]
            host.copy_(src if isinstance(src, torch.Tensor)
                       else torch.from_numpy(np.asarray(src)))
            dst.copy_(host, non_blocking=True)
        self._lr_pinned.copy_(torch.as_tensor(lrs, dtype=torch.float32))
        self.lrs.copy_(self._lr_pinned, non_blocking=True)
        self._copied.record()
        self.graph.replay()
        self.replays += 1
        rnn_kernels.note_replay(self.kernel_calls)
        return self.costs.clone()


def _dtype(v: Any) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.zeros((), dtype=np.asarray(v).dtype)).dtype
