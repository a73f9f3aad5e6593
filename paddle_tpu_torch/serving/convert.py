"""Move ServableLM weights between the JAX package and the port.

The JAX package keys its parameters `embed`, `pos`, `lnf`, `unembed` and
`l{i}.wq … l{i}.ln2` (paddle_tpu/serving/model.py:209-237). A name with a
dot cannot be an `nn.Module` attribute, so the port keeps layer i's
parameters in `layers[i]` and its state dict says `layers.{i}.wq`. Layouts
are unchanged — matrices stay [in, out] — so conversion is renaming only,
and a .npz checkpoint loads in both directions."""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_JAX_LAYER = re.compile(r"^l(\d+)\.(\w+)$")
_PORT_LAYER = re.compile(r"^layers\.(\d+)\.(\w+)$")


def params_from_jax(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX parameter dict (numpy or jax arrays) -> the port's state dict
    (f32 CPU tensors; `load_state_dict` copies them to the model's device)."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        m = _JAX_LAYER.match(name)
        key = f"layers.{m.group(1)}.{m.group(2)}" if m else name
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def params_to_jax(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The port's parameters under the JAX package's names, as f32 numpy."""
    out: Dict[str, np.ndarray] = {}
    for key, value in module.state_dict().items():
        m = _PORT_LAYER.match(key)
        name = f"l{m.group(1)}.{m.group(2)}" if m else key
        out[name] = value.detach().to("cpu", torch.float32).numpy()
    return out
