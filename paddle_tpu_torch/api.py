"""swig_paddle-shaped compatibility surface (counterpart of
`paddle_tpu/api.py`; paddle/api/PaddleAPI.h, py_paddle).

The reference exposes trainer internals to Python through SWIG classes
(`GradientMachine` :720, `Arguments` :402, `SequenceGenerator` :1025). Here
those internals are Python; this module gives scripts written against
py_paddle the same class shapes over the port's layer graph. A
`GradientMachine` runs on `device` (None: CUDA); its forwards run eagerly
under `torch.inference_mode()`, `forwardBackward` under autograd.
`SequenceGenerator` generates over a graph holding a beam_search layer
(`nn/recurrent_group.BeamSearchLayer`) on the machine's parameters."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.graph import Layer, Network


class Arguments:
    """Batch container (PaddleAPI.h:402): per-slot values or ids and
    sequence start positions, kept as a dict batch; start positions become
    the padded + lengths encoding."""

    def __init__(self, batch: Optional[Dict[str, Any]] = None):
        self._batch: Dict[str, Any] = dict(batch or {})

    @classmethod
    def createArguments(cls, _size: int = 0) -> "Arguments":
        return cls()

    def setSlotValue(self, name: str, value: np.ndarray) -> None:
        self._batch[name] = np.asarray(value)

    def setSlotIds(self, name: str, ids: np.ndarray) -> None:
        self._batch[name] = np.asarray(ids, np.int32)

    def setSlotSequenceStartPositions(self, name: str, starts: Sequence[int]) -> None:
        """v1 ragged encoding: starts [0, l0, l0+l1, ...] -> padded + lengths."""
        starts = list(starts)
        lengths = np.diff(starts).astype(np.int32)
        flat = self._batch.get(name)
        if flat is None:
            raise ValueError(f"set slot {name!r} value/ids before start positions")
        flat = np.asarray(flat)
        max_len = int(lengths.max()) if len(lengths) else 1
        out = np.zeros((len(lengths), max_len) + flat.shape[1:], flat.dtype)
        for i, (s, l) in enumerate(zip(starts[:-1], lengths)):
            out[i, :l] = flat[s:s + l]
        self._batch[name] = out
        self._batch[name + ".lengths"] = lengths

    def getSlotValue(self, name: str) -> np.ndarray:
        return np.asarray(self._batch[name])

    def as_batch(self) -> Dict[str, Any]:
        return dict(self._batch)


class Evaluator:
    """makeEvaluator() result: start / finish + printStats."""

    def __init__(self, machine: "GradientMachine"):
        self.machine = machine
        self._metrics: Dict[str, float] = {}

    def start(self) -> None:
        self._metrics.clear()

    def finish(self) -> None:
        pass

    def printStats(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self._metrics.items())


def _batch_of(in_args: Any) -> Dict[str, Any]:
    return in_args.as_batch() if isinstance(in_args, Arguments) else in_args


class GradientMachine:
    """PaddleAPI.h:720: forward / backward / forwardBackward over a
    topology. `backward` returns the parameters' gradients (the reference
    fills gradient buffers)."""

    def __init__(self, outputs: Sequence[Layer], seed: int = 0, device: DeviceLike = None):
        self.network = Network(list(outputs))
        self.seed = seed
        self.device = resolve_device(device)
        self.params: Dict[str, torch.Tensor] = {}
        self.states: Dict[str, torch.Tensor] = {}

    @classmethod
    def createFromConfigProto(cls, parsed_config, device: DeviceLike = None
                              ) -> "GradientMachine":
        """From a `config.parse_config` result (the proto's owner)."""
        return cls(parsed_config.outputs, device=device)

    def initParams(self, batch: Dict[str, Any]) -> None:
        self.params, self.states = self.network.init(batch, seed=self.seed,
                                                     device=self.device, with_states=True)

    def _ready(self, in_args: Any) -> Dict[str, Any]:
        batch = _batch_of(in_args)
        if not self.params:
            self.initParams(batch)
        return batch

    def forward(self, in_args: Any, _out_args: Any = None, _pass_type: Any = None):
        batch = self._ready(in_args)
        with torch.inference_mode():
            outs, _ = self.network.apply(self.params, batch, self.states, train=False)
        return {k: v.value.cpu().numpy() for k, v in outs.items()}

    def forwardBackward(self, in_args: Any, _out=None, _pt=None):
        """-> (the first output's cost, {name: gradient}) of a train-mode
        forward."""
        batch = self._ready(in_args)
        names = list(self.params)
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        outs, _ = self.network.apply(params, batch, self.states, train=True,
                                     rng=prng.PRNGKey(self.seed, self.device))
        cost = outs[self.network.outputs[0].name].value.sum()
        grads = torch.autograd.grad(cost, [params[k] for k in names], allow_unused=True,
                                    materialize_grads=True)
        return float(cost.detach()), {k: g.cpu().numpy() for k, g in zip(names, grads)}

    backward = forwardBackward  # the reference splits them; the semantics match

    def getLayerOutput(self, name: str, in_args: Any) -> np.ndarray:
        batch = self._ready(in_args)
        sub = Network([self.network.layers_by_name[name]])
        with torch.inference_mode():
            outs, _ = sub.apply(self.params, batch, self.states, train=False)
        return outs[name].value.cpu().numpy()

    def getParameters(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.params.items()}

    def setParameters(self, params: Dict[str, np.ndarray]) -> None:
        self.params = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(self.device)
                       for k, v in params.items()}

    def makeEvaluator(self) -> Evaluator:
        return Evaluator(self)


class SequenceGenerator:
    """PaddleAPI.h:1025: beam-search text generation over a graph holding a
    beam_search layer; `dict_file` is the vocabulary, one word a line."""

    def __init__(self, machine: GradientMachine, beam_layer: Layer,
                 dict_file: Optional[Sequence[str]] = None):
        self.machine = machine
        self.beam_layer = beam_layer
        self.vocab = list(dict_file) if dict_file else None

    def generate(self, in_args: Any) -> List[List[int]]:
        """The best beam's ids of every sample, up to and including EOS."""
        batch = self.machine._ready(in_args)
        with torch.inference_mode():
            outs, _ = self.machine.network.apply(self.machine.params, batch,
                                                 self.machine.states, train=False)
        arg = outs[self.beam_layer.name]
        ids = arg.value.cpu().numpy()
        lens = arg.lengths.cpu().numpy()
        return [list(map(int, ids[i, :lens[i]])) for i in range(len(ids))]

    def generateText(self, in_args: Any) -> List[str]:
        assert self.vocab is not None, "pass dict_file to decode text"
        return [" ".join(self.vocab[t] for t in seq if t < len(self.vocab))
                for seq in self.generate(in_args)]
