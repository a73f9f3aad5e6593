"""paddle.v2.parameters analog (counterpart of `paddle_tpu/v2/parameters.py`;
python/paddle/v2/parameters.py).

`Parameters` is a numpy-facing dict of a model's parameters with the v2
tar (de)serialization: one `<name>.npy` member per parameter, sorted by
name, written and read with `allow_pickle=False` — the JAX package's
layout, so a tar written by either package loads in the other.
`create(cost)` draws the values with the port's own initializers (a torch
generator per parameter), which are not jax's numbers: to hold the port to
the JAX package on the same values, move a JAX `Parameters` across by name
(its tar into `from_tar`)."""

from __future__ import annotations

import io
import os
import tarfile
from typing import Dict, Iterator

import numpy as np

from paddle_tpu_torch.core.init_ctx import flags
from paddle_tpu_torch.device import DeviceLike


class Parameters:
    def __init__(self):
        self._params: Dict[str, np.ndarray] = {}

    # -- creation -------------------------------------------------------------
    @staticmethod
    def from_topology(topology, seed: int = 0, device: DeviceLike = None) -> "Parameters":
        """`paddle.parameters.create(cost)`: create the parameters by running
        the graph once, in init mode, on a synthetic batch on `device`
        (None: `paddle.init`'s device, CUDA unless use_gpu=False)."""
        params = topology.network.init(topology.sample_batch(), seed=seed,
                                       device=device or flags().device)
        return Parameters.from_dict({k: v.cpu().numpy() for k, v in params.items()})

    @staticmethod
    def from_dict(d: Dict[str, np.ndarray]) -> "Parameters":
        p = Parameters()
        for k, v in d.items():
            p._params[k] = np.asarray(v)
        return p

    # -- dict protocol ----------------------------------------------------------
    def names(self):
        return list(self._params.keys())

    def keys(self):
        return self._params.keys()

    def has_key(self, key: str) -> bool:
        return key in self._params

    def __contains__(self, key: str) -> bool:
        return key in self._params

    def __iter__(self) -> Iterator[str]:
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)

    def get(self, key: str) -> np.ndarray:
        return self._params[key]

    __getitem__ = get

    def set(self, key: str, value: np.ndarray) -> None:
        if key in self._params and self._params[key].shape != np.shape(value):
            raise ValueError(f"shape mismatch for {key!r}: {self._params[key].shape} "
                             f"vs {np.shape(value)}")
        self._params[key] = np.asarray(value)

    __setitem__ = set

    def get_shape(self, key: str):
        return self._params[key].shape

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dict(self._params)

    # -- (de)serialization: a tar of .npy members (v2 to_tar / from_tar) ----
    def to_tar(self, f) -> None:
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name, arr in sorted(self._params.items()):
                buf = io.BytesIO()
                np.save(buf, arr, allow_pickle=False)
                data = buf.getvalue()
                info = tarfile.TarInfo(name=name + ".npy")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

    @staticmethod
    def from_tar(f) -> "Parameters":
        p = Parameters()
        with tarfile.open(fileobj=f, mode="r") as tar:
            for member in tar.getmembers():
                if not member.name.endswith(".npy"):
                    continue
                buf = tar.extractfile(member)
                assert buf is not None
                p._params[member.name[:-len(".npy")]] = np.load(
                    io.BytesIO(buf.read()), allow_pickle=False)
        return p

    def save_to_file(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            self.to_tar(f)
        os.replace(tmp, path)

    @staticmethod
    def load_from_file(path: str) -> "Parameters":
        with open(path, "rb") as f:
            return Parameters.from_tar(f)


def create(layers, seed: int = 0, device: DeviceLike = None) -> Parameters:
    """paddle.parameters.create(cost): output layer(s) or a Topology."""
    from paddle_tpu_torch.v2.topology import Topology

    topo = layers if isinstance(layers, Topology) else Topology(layers)
    return Parameters.from_topology(topo, seed=seed, device=device)
