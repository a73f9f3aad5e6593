"""Move layer-graph parameters between the JAX package and the port.

Both key a parameter `attr.name or f"{layer.name}.{pname}"` and keep the same
layouts ([in, out] matrices, GRU gate blocks z, r, c), so conversion changes
only the container: numpy or jax arrays one way, f32 tensors the other. A
seq2seq model has 22 such names (`src_emb.w`, `trg_emb_table`, `out_w`,
`out_b`, `enc.{fw,bw}.input_proj.{w,b}`, `enc.{fw,bw}.{w_hzr,w_hc,b}`,
`decoder.att.{w_enc,w_dec,v}`, `decoder.w_in`, `decoder.w_init`,
`decoder.gru.{w_hzr,w_hc,b}`). The LSTM text classifier (`text_lstm`, or
the same graph with `use_peephole=False`) has `emb.w`, `logits.{w,b}` and
per layer i `lstm{i}.input_proj.{w,b}` and `lstm{i}.{w_hh,b}` (W_hh
[H, 4H] in gate blocks i, f, c, o), plus `lstm{i}.check_{i,f,o}` [H] with
peepholes. Conv weights are HWIO in both packages, 3-D ones DHWIO; NCE's
`w` is [num_classes, D], hsigmoid's [num_classes - 1, D] in heap order,
MDLstm's `w_h` [H, 5H] with `check_f` [2, H]. State dicts (batch
norm's `<layer>.moving_mean` / `.moving_var`, f32 [C]) move through the same
two functions: ResNet-50 has 161 parameters and 106 states."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device


def params_from_jax(params: Mapping[str, object],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """JAX parameter or state dict (numpy or jax arrays) -> {name: f32
    tensor on `device`} (None means CUDA, as everywhere in the port)."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(value, dtype=np.float32)).to(dev)
            for name, value in params.items()}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's parameter or state dict -> {name: f32 numpy array}, the
    JAX package's layout and names."""
    return {name: value.detach().to("cpu", torch.float32).numpy().copy()
            for name, value in params.items()}

