"""merge_model: fold a config and its trained parameters into ONE file
(counterpart of `paddle_tpu/capi/merge_model.py`; paddle/trainer/
MergeModel.cpp + python/paddle/utils/merge_model.py). Layout, one .npz:

    __config_source__  : the config script text (re-executed at load)
    __config_args__    : its config_args string
    __trainer_config__ : the TrainerConfig text (for inspection)
    param/<name>       : parameter arrays
    state/<name>       : non-trainable states (batch norm's moving statistics)
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from paddle_tpu_torch import proto
from paddle_tpu_torch.config import parse_config
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer import v1_format


def _load(model_dir: str, pass_id: Optional[int]):
    """(params, states) of save_dir's pass `pass_id` (the newest for None),
    or of a pass directory given itself (save_dir/pass-00042)."""
    if any(d.startswith("pass-") for d in os.listdir(model_dir)):
        params, states, _opt, _manifest = ckpt.load_pass(model_dir, pass_id)
    else:
        parent, leaf = os.path.split(model_dir.rstrip("/"))
        params, states, _opt, _manifest = ckpt.load_pass(parent, int(leaf.split("-")[1]))
    return params, states


def merge_model(config_path: str, model_dir: str, output_path: str,
                config_args: str = "", pass_id: Optional[int] = None) -> str:
    with open(config_path) as f:
        source = f.read()
    pc = parse_config(config_path, config_args)
    params, states = _load(model_dir, pass_id)
    payload: Dict[str, np.ndarray] = {
        "__config_source__": np.asarray(source),
        "__config_args__": np.asarray(config_args),
        "__trainer_config__": np.asarray(proto.to_text(pc.trainer_config)),
    }
    for k, v in params.items():
        payload[f"param/{k}"] = np.asarray(v)
    for k, v in (states or {}).items():
        payload[f"state/{k}"] = np.asarray(v)
    tmp = output_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, output_path)
    return output_path


def merge_model_v1(config_path: str, model_dir: str, output_path: str,
                   config_args: str = "", pass_id: Optional[int] = None) -> str:
    """Reference-format merged model (MergeModel.cpp byte layout): int64
    config length + the TrainerConfig + every parameter with its
    `Parameter::Header`, in the config's declaration order — the stream has
    no names, so a reader binds bytes to parameters by position. The config
    header is the protobuf TEXT rendering (the reference binary cannot
    parse it); the framing and the parameter bytes are the reference's."""
    pc = parse_config(config_path, config_args)
    params, _states = _load(model_dir, pass_id)
    config_bytes = proto.to_text(pc.trainer_config).encode()
    # a declared parameter missing from the checkpoint would shift every
    # later binding: fail here instead
    declared = [p.name for p in pc.trainer_config.model_config.parameters]
    missing = [n for n in declared if n not in params]
    if missing:
        raise ValueError(
            f"merge_model_v1: config declares parameters {missing} that are not in "
            "the checkpoint — positional binding would corrupt every parameter after "
            "the first missing one")
    order = declared + sorted(set(params) - set(declared))
    tmp = output_path + ".tmp"
    with open(tmp, "wb") as f:
        v1_format.write_merged(f, config_bytes, params, order=order)
    os.replace(tmp, output_path)
    return output_path
