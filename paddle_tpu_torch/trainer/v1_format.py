"""v1 binary parameter format — byte-level interchange with the reference
(the port's copy of `paddle_tpu/trainer/v1_format.py`, byte for byte the
same files).

Layout (paddle/parameter/Parameter.h:263 `Parameter::Header` +
Parameter.cpp:286 `Parameter::save`): a little-endian packed
`{int32 format; uint32 valueSize; uint64 size}` header (16 bytes, no
padding) followed by `size` raw float32 values. One file per parameter named
after it in a model directory (ParamUtil), or all parameters appended to one
stream after a length-prefixed serialized config (MergeModel.cpp).

Weight memory layouts (so reference-trained models load into the NHWC/HWIO
layers here and vice-versa):
- fc / projection weights: reference `Weight(height=in, width=out)` row-major
  [in, out] — identical to ours, no conversion.
- conv filters: reference rows are (channel, kh, kw) against columns
  num_filters (ExpandConvLayer.cpp:48 `height = filterPixels * filterChannels`,
  im2col channel-major) — i.e. flat [cin, kh, kw, cout]; ours are HWIO
  [kh, kw, cin, cout]. 4-D parameters are transposed on write/read.
"""

from __future__ import annotations

import os
import struct
from typing import Any, BinaryIO, Dict, Optional

import numpy as np

HEADER = struct.Struct("<iIQ")  # format, valueSize, size
PARAM_FORMAT_ORIGINAL = 0


def _to_v1_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # HWIO -> [cin, kh, kw, cout] (reference conv rows)
        return np.ascontiguousarray(np.transpose(arr, (2, 0, 1, 3)))
    return arr


def _from_v1_layout(name: str, flat: np.ndarray, shape) -> np.ndarray:
    if len(shape) == 4:  # reverse of _to_v1_layout
        kh, kw, ci, co = shape
        return np.ascontiguousarray(
            np.transpose(flat.reshape(ci, kh, kw, co), (1, 2, 0, 3))
        )
    return flat.reshape(shape)


def write_param(stream: BinaryIO, name: str, arr: np.ndarray) -> None:
    """Parameter::save byte layout. Values are written float32 (the
    reference's `real`); non-f32 params are cast."""
    data = _to_v1_layout(name, np.asarray(arr)).astype("<f4", copy=False)
    stream.write(HEADER.pack(PARAM_FORMAT_ORIGINAL, 4, data.size))
    stream.write(data.tobytes())


def read_param(stream: BinaryIO, name: str, shape) -> np.ndarray:
    raw = stream.read(HEADER.size)
    if len(raw) != HEADER.size:
        raise EOFError(f"truncated v1 parameter header for {name!r}")
    fmt, value_size, size = HEADER.unpack(raw)
    if fmt != PARAM_FORMAT_ORIGINAL:
        raise ValueError(f"unsupported v1 header format {fmt} for {name!r}")
    if value_size != 4:
        raise ValueError(f"unsupported valueSize {value_size} for {name!r}")
    want = int(np.prod(shape)) if shape else 1
    if size != want:
        raise ValueError(
            f"size mismatch for {name!r}: file has {size}, parameter wants {want}"
        )
    data = np.frombuffer(stream.read(size * 4), dtype="<f4", count=size)
    return _from_v1_layout(name, data, shape)


def save_model_dir(dirname: str, params: Dict[str, Any]) -> None:
    """ParamUtil-style model dir: one `Parameter::save` file per parameter."""
    os.makedirs(dirname, exist_ok=True)
    for name, arr in params.items():
        with open(os.path.join(dirname, name), "wb") as f:
            write_param(f, name, np.asarray(arr))


def load_model_dir(dirname: str, template: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Load a ParamUtil model dir against a shape template ({name: array})."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in template.items():
        path = os.path.join(dirname, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"missing parameter file {path!r} while loading model"
            )
        with open(path, "rb") as f:
            out[name] = read_param(f, name, np.asarray(arr).shape)
    return out


def write_merged(stream: BinaryIO, config_bytes: bytes, params: Dict[str, Any],
                 order: Optional[list] = None) -> None:
    """MergeModel.cpp layout: int64 config length + serialized config +
    parameters appended in order, each with its Parameter::Header."""
    stream.write(struct.pack("<q", len(config_bytes)))
    stream.write(config_bytes)
    for name in order or list(params):
        write_param(stream, name, np.asarray(params[name]))


def read_merged(stream: BinaryIO, template: Dict[str, Any],
                order: Optional[list] = None):
    """-> (config_bytes, {name: array})."""
    (n,) = struct.unpack("<q", stream.read(8))
    config_bytes = stream.read(n)
    out: Dict[str, np.ndarray] = {}
    for name in order or list(template):
        out[name] = read_param(stream, name, np.asarray(template[name]).shape)
    return config_bytes, out
