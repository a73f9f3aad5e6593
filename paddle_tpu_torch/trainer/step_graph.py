"""The training step as one CUDA graph.

The port's counterpart of the JAX trainer's compiled step (`_build_step`
jitted, in `paddle_tpu/trainer/trainer.py`) and of its K-step `lax.scan`
dispatch (`make_multi_step`). `SGDTrainer._step_body` — the lr from the
schedule, the step's key, the forward, the backward
(`torch.autograd.grad`), the optimizer's in-place update, the model
average, the in-place write of the new states and counters, and the
divergence guard's revert — is captured K times in a row with
`torch.cuda.CUDAGraph`, once per batch signature, and replayed, so a
dispatch costs the host the input copies, one replay and the costs' copy
instead of thousands of launches.

What makes the capture legal:
  * Static inputs: every slot of the batch has a device buffer of its
    shape and dtype (stacked [K, ...] for K steps); `replay` copies the new
    values into them (host values through pinned buffers, which it
    rewrites only once the previous replay's copies have left them).
  * Static state: everything a step reads and writes lives on the device
    and is updated in its own storage: the parameters, the optimizer's
    slots and its step counter `t`, the states, the model averages, the
    samples counter, `lr_scale`, the divergence count and the guard's cost
    accumulator (`SGDTrainer._step_body`). The lr is the schedule of the
    samples counter times `lr_scale`, and Dropout's key folds in the samples
    counter, both computed inside the graph, so every replay runs its own
    step. Whoever replaces a value copies it into that storage
    (`SGDTrainer.load*`, `set_lr_scale`) and never rebinds it;
    `init_state` drops the graphs.
  * No host work inside: the step reads no device value on the host (a
    PrintLayer's value is copied into a buffer of the graph's and printed
    after each replay, `nn/layers.captured_prints`), and
    the kernels' plans, builds and attributes are cached by the warm-up
    (the trainer runs the first step of a signature eagerly, as a real
    step, before it captures).

Launch counts: the recurrent and attention wrappers count a call made
under capture in `rnn_kernels.CAPTURED`; each replay adds the calls its
capture recorded (`rnn_kernels.note_replay`), so "2 forward + 2 backward
GRU launches a step" reads the same under replay as eagerly. A
data-parallel step's collectives (NCCL, on the mesh's group) are captured
with it and counted the same way (`parallel/mesh.py` `CAPTURED`,
`note_replay`); the signature's first, eager dispatch has already created
the NCCL communicator.

CUDA only: the CPU has no graphs and the trainer runs the step eagerly
there. A failed capture raises; nothing drops back to eager on the card."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from paddle_tpu_torch.nn import layers
from paddle_tpu_torch.ops import rnn_kernels
from paddle_tpu_torch.parallel import mesh as mesh_mod


class StepGraph:
    """`k` calls of `step_body(batch_i)` captured as one graph on the
    calling thread; `example` holds the batch slots ([K, ...] stacked when
    k > 1, else one batch) whose shapes and dtypes the static buffers
    take. `step_body` returns (cost, {extra name: value}); the graph keeps
    the K costs and, for k == 1, the extras as its static outputs."""

    def __init__(self, step_body: Callable[[Dict[str, torch.Tensor]],
                                           Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
                 example: Mapping[str, Any], k: int, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"StepGraph needs a CUDA device, got {device}")
        self.k = k
        self.replays = 0
        self.inputs = {name: torch.empty(tuple(np.shape(v)), dtype=_dtype(v),
                                         device=device)
                       for name, v in example.items()}
        self._pinned = {name: torch.empty(v.shape, dtype=v.dtype).pin_memory()
                        for name, v in self.inputs.items()}
        self._copied = torch.cuda.Event()
        batches = ([self.inputs] if k == 1 else
                   [{name: v[i] for name, v in self.inputs.items()} for i in range(k)])
        self.graph = torch.cuda.CUDAGraph()
        before = dict(rnn_kernels.CAPTURED)
        collectives_before = dict(mesh_mod.CAPTURED)
        # thread_local: the checkpoint writer thread may wait on a CUDA
        # event meanwhile; the autograd thread's backward still records
        # into the capture stream
        with layers.captured_prints() as prints, \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            outs = [step_body(b) for b in batches]
            self.costs = torch.stack([c for c, _ in outs])
            self.extras = outs[0][1] if k == 1 else {}
        self.prints = prints
        self.kernel_calls = {name: n - before[name]
                             for name, n in rnn_kernels.CAPTURED.items()
                             if n != before[name]}
        self.collective_calls = mesh_mod.captured_since(collectives_before)

    def replay(self, batch: Mapping[str, Any]):
        """K steps on `batch` (the slots as `example` laid them out) ->
        (the K costs, the extras), copied out of the graph's static outputs
        (so the next replay leaves them alone)."""
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
        self._copied.record()
        self.graph.replay()
        self.replays += 1
        rnn_kernels.note_replay(self.kernel_calls)
        mesh_mod.note_replay(self.collective_calls)
        layers.emit_prints(self.prints)
        return self.costs.clone(), {k: v.clone() for k, v in self.extras.items()}


def _dtype(v: Any) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.zeros((), dtype=np.asarray(v).dtype)).dtype
