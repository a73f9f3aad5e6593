"""InferenceMachine: serve a merged model (counterpart of
`paddle_tpu/capi/inference.py`; capi/gradient_machine.h parity).

`create_for_inference(path)` ~ paddle_gradient_machine_create_for_inference_
with_parameters (capi/gradient_machine.h:52); `forward` ~ :73;
`get_layer_output` ~ :112. The parameters go to the device once, at load;
each forward runs eagerly under `torch.inference_mode()` (the JAX package
jits it). One machine serves any number of threads: its tensors are only
read, and the per-layer sub-networks are built under a lock."""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.graph import Network


class InferenceMachine:
    def __init__(self, topology, params, states, feeder, device: DeviceLike = None):
        self.topology = topology
        self.network = topology.network
        self.device = resolve_device(device)

        def place(values):
            return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(self.device)
                    for k, v in values.items()}
        self.params = place(params)
        self.states = place(states)
        self.feeder = feeder
        self._layer_nets: Dict[str, Network] = {}
        self._layer_lock = threading.Lock()

    @classmethod
    def from_merged(cls, path: str, device: DeviceLike = None) -> "InferenceMachine":
        from paddle_tpu_torch.config import parse_config

        with np.load(path, allow_pickle=False) as z:
            source = str(z["__config_source__"])
            config_args = str(z["__config_args__"])
            params = {k[len("param/"):]: z[k] for k in z.files if k.startswith("param/")}
            states = {k[len("state/"):]: z[k] for k in z.files if k.startswith("state/")}
        with tempfile.NamedTemporaryFile("w", suffix="_conf.py", delete=False) as f:
            f.write(source)
            cfg_path = f.name
        try:
            pc = parse_config(cfg_path, config_args, emit_proto=False)
        finally:
            os.unlink(cfg_path)
        return cls(pc.topology, params, states, pc.topology.make_feeder(), device=device)

    def _apply(self, network: Network, batch: Any):
        if not isinstance(batch, dict):
            batch = self.feeder(batch)
        with torch.inference_mode():
            return network.apply(self.params, batch, self.states, train=False)[0]

    # -- forward (capi/gradient_machine.h:73) ---------------------------------
    def forward(self, batch: Any, output_layer: Optional[str] = None
                ) -> Union[Dict[str, np.ndarray], np.ndarray]:
        """batch: a dict of arrays, or a list of sample tuples (fed through
        the config's data layers in declaration order). The bare array for
        `output_layer`, else {name: array} for every output."""
        outs = self._apply(self.network, batch)
        if output_layer is not None:
            return outs[output_layer].value.cpu().numpy()
        return {name: a.value.cpu().numpy() for name, a in outs.items()}

    def output_names(self) -> List[str]:
        return [l.name for l in self.network.outputs]

    # -- any layer's output (GradientMachine::getLayerOutput) ------------------
    def get_layer_output(self, layer_name: str, batch: Any) -> np.ndarray:
        """Forward the sub-graph of `layer_name` and return its output
        (paddle_gradient_machine_get_layer_output, capi/gradient_machine.h:112)."""
        with self._layer_lock:
            if layer_name not in self._layer_nets:
                layer = self.topology.network.layers_by_name[layer_name]
                self._layer_nets[layer_name] = Network([layer])
        net = self._layer_nets[layer_name]
        return self._apply(net, batch)[layer_name].value.cpu().numpy()


def create_for_inference(merged_path: str, device: DeviceLike = None) -> InferenceMachine:
    return InferenceMachine.from_merged(merged_path, device=device)
