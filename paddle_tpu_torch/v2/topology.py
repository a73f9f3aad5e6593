"""paddle.v2.topology analog (counterpart of `paddle_tpu/v2/topology.py`;
python/paddle/v2/topology.py:27 Topology).

The layer DAG *is* the model config; Topology adds the v2 conveniences on
top: data-layer discovery (`data_layers`), the automatic feeding order
(`make_feeder`), and the synthetic batch the config dump traces the graph
with (`sample_batch`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from paddle_tpu_torch.data.feeder import DataFeeder, InputSpec
from paddle_tpu_torch.nn.graph import Layer, Network


class Topology:
    def __init__(self, layers: Union[Layer, Sequence[Layer]], extra_layers: Sequence[Layer] = ()):
        if isinstance(layers, Layer):
            layers = [layers]
        # extra_layers ride along in the graph (reference: unused/print layers
        # stay in the config) but are not declared outputs
        self.declared_outputs: List[Layer] = list(layers)
        self.output_layers: List[Layer] = list(layers) + list(extra_layers)
        self.network = Network(self.output_layers)

    # -- data layers --------------------------------------------------------
    def data_layers(self) -> Dict[str, Layer]:
        """name → data Layer, in topological order (v2 Topology.data_layers)."""
        return {
            l.name: l
            for l in self.network.layer_order
            if l.type_name == "data"
        }

    def data_type(self) -> List:
        """[(name, InputSpec)] for layers built via v2.layer.data."""
        out = []
        for name, l in self.data_layers().items():
            spec = getattr(l, "data_type", None)
            if spec is None:
                spec = _infer_spec(l)
            out.append((name, spec))
        return out

    def get_layer(self, name: str) -> Layer:
        return self.network.layers_by_name[name]

    # -- feeding ------------------------------------------------------------
    def make_feeder(self, feeding: Optional[Dict[str, int]] = None) -> DataFeeder:
        """Build a DataFeeder whose column order follows `feeding`
        (name → sample-tuple index, the v2 convention) or data-layer order."""
        pairs = self.data_type()
        if feeding:
            names = {n for n, _ in pairs}
            unknown = set(feeding) - names
            if unknown:
                raise ValueError(f"feeding refers to unknown data layers: {unknown}")
            not_fed = names - set(feeding)
            if not_fed:
                raise ValueError(
                    f"feeding is missing required data layers: {sorted(not_fed)}"
                )
            pairs = sorted(pairs, key=lambda kv: feeding[kv[0]])
        return DataFeeder({n: s for n, s in pairs})

    # -- sample batch for shape-driven init ---------------------------------
    def sample_batch(self, batch_size: int = 2, seq_len: int = 8) -> Dict[str, np.ndarray]:
        batch: Dict[str, np.ndarray] = {}
        for name, l in self.data_layers().items():
            spec = getattr(l, "data_type", None)
            shape = tuple(l.shape)
            is_seq = getattr(l, "is_seq", False)
            if spec is not None and spec.kind in ("index", "index_seq"):
                hi = max(int(spec.dim), 2)
                if spec.kind == "index_seq":
                    batch[name] = np.zeros((batch_size, seq_len), np.int32)
                    batch[name + ".lengths"] = np.full((batch_size,), seq_len, np.int32)
                else:
                    batch[name] = np.zeros((batch_size,), np.int32)
                _ = hi
            elif spec is not None and spec.kind in ("dense_subseq", "index_subseq"):
                # subsequence count == seq_len so per-subsequence outputs
                # align with level-1 sequence slots in the same synthetic
                # batch (a seq label per subsequence is the common pairing)
                s_max = max(seq_len, 1)
                if spec.kind == "dense_subseq":
                    batch[name] = np.zeros(
                        (batch_size, s_max, seq_len) + shape, np.float32
                    )
                else:
                    batch[name] = np.zeros((batch_size, s_max, seq_len), np.int32)
                batch[name + ".lengths"] = np.full((batch_size,), s_max, np.int32)
                batch[name + ".sub_lengths"] = np.full(
                    (batch_size, s_max), seq_len, np.int32
                )
            elif is_seq:
                batch[name] = np.zeros((batch_size, seq_len) + shape, np.float32)
                batch[name + ".lengths"] = np.full((batch_size,), seq_len, np.int32)
            else:
                batch[name] = np.zeros((batch_size,) + shape, np.float32)
        return batch


def _infer_spec(l: Layer) -> InputSpec:
    shape = tuple(l.shape)
    if getattr(l, "is_seq", False):
        kind = "index_seq" if not shape else "dense_seq"
        return InputSpec(kind, shape or 0)
    if not shape:
        return InputSpec("index", 0, np.int32)
    return InputSpec("dense", shape if len(shape) > 1 else shape[0])
