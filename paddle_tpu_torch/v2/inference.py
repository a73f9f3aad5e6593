"""paddle.v2.inference analog (counterpart of `paddle_tpu/v2/inference.py`;
python/paddle/v2/inference.py).

`infer()` streams input chunks of `batch_size` samples through the output
sub-graph: the deployment path that replaces
paddle_gradient_machine_forward (capi/gradient_machine.h:73). The forward
runs eagerly under `torch.inference_mode()` on `device` (None: `paddle.init`'s
device), where the JAX package jits it; the parameters go to the device
once, when the `Inference` is built."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core.init_ctx import flags
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.v2.parameters import Parameters
from paddle_tpu_torch.v2.topology import Topology


class Inference:
    def __init__(self, output_layer, parameters: Parameters, device: DeviceLike = None):
        outputs = output_layer if isinstance(output_layer, (list, tuple)) else [output_layer]
        self.topology = Topology(list(outputs))
        self.output_names = [l.name for l in outputs]
        self.network = self.topology.network
        self.device = resolve_device(device or flags().device)
        self._params = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(self.device)
                        for k, v in parameters.as_dict().items()}
        self._states: Optional[Dict[str, torch.Tensor]] = None

    def _ensure_states(self, batch) -> None:
        """Batch norm's moving statistics and any parameter the tar does not
        carry take their initial values (one init-mode forward, once)."""
        if self._states is not None:
            return
        params, states = self.network.init(batch, device=self.device, with_states=True)
        for k, v in params.items():
            self._params.setdefault(k, v)
        self._states = states

    def forward(self, batch) -> List[torch.Tensor]:
        """The outputs' values on one fed batch (device tensors)."""
        self._ensure_states(batch)
        with torch.inference_mode():
            outs, _ = self.network.apply(self._params, batch, self._states, train=False)
        return [outs[n].value for n in self.output_names]

    def infer(self, input: Union[List, Iterable], feeding: Optional[Dict[str, int]] = None,
              field: Union[str, Sequence[str]] = "value", batch_size: int = 128):
        fields = [field] if isinstance(field, str) else list(field)
        for f in fields:
            if f not in ("value", "id"):
                raise ValueError(f"unsupported infer field {f!r} (value|id)")
        feeder = self.topology.make_feeder(feeding)
        samples = list(input)
        chunks: List[List[np.ndarray]] = []
        for i in range(0, len(samples), batch_size):
            vals = self.forward(feeder(samples[i:i + batch_size]))
            # ids (a beam_search output) stay int32, as the JAX package's do
            chunks.append([(v.float() if v.is_floating_point() else v).cpu().numpy()
                           for v in vals])
        per_output = [_concat_chunks([c[j] for c in chunks])
                      for j in range(len(self.output_names))]
        results = []
        for f in fields:
            for out in per_output:
                results.append(np.argmax(out, axis=-1) if f == "id" else out)
        return results[0] if len(results) == 1 else results


def _concat_chunks(chunks):
    """Concatenate per-batch outputs; sequence outputs may be padded to
    different lengths per chunk — zero-pad to the common max first."""
    if len(chunks) == 1:
        return chunks[0]
    if chunks[0].ndim >= 2:
        max_t = max(c.shape[1] for c in chunks)
        if any(c.shape[1] != max_t for c in chunks):
            chunks = [np.pad(c, [(0, 0), (0, max_t - c.shape[1])] + [(0, 0)] * (c.ndim - 2))
                      for c in chunks]
    return np.concatenate(chunks, axis=0)


def infer(output_layer, parameters: Parameters, input, feeding=None, field="value",
          batch_size: int = 128, device: DeviceLike = None):
    return Inference(output_layer, parameters, device=device).infer(
        input, feeding=feeding, field=field, batch_size=batch_size)
