"""Graphviz diagram of a network (counterpart of
`paddle_tpu/utils/make_model_diagram.py`;
python/paddle/utils/make_model_diagram.py), over the port's
`nn/graph.Network`: the same dot text as the JAX package's for the same
topology."""

from __future__ import annotations

import shutil
import subprocess
from typing import Sequence, Union

from paddle_tpu_torch.nn.graph import Layer, Network


def to_dot(topology: Union[Layer, Sequence[Layer], Network], name: str = "model") -> str:
    net = topology if isinstance(topology, Network) else Network(topology)
    lines = [f"digraph {name} {{", "  rankdir=BT;"]
    for layer in net.layer_order:
        shape = "box" if layer.type_name != "data" else "oval"
        lines.append(
            f'  "{layer.name}" [label="{layer.name}\\n({layer.type_name})" '
            f"shape={shape}];"
        )
        for inp in layer.inputs:
            lines.append(f'  "{inp.name}" -> "{layer.name}";')
    lines.append("}")
    return "\n".join(lines)


def make_diagram(topology, output_path: str, name: str = "model") -> str:
    """Write the .dot file; render it to .png when the graphviz binary exists."""
    dot = to_dot(topology, name)
    dot_path = output_path if output_path.endswith(".dot") else output_path + ".dot"
    with open(dot_path, "w") as f:
        f.write(dot)
    if shutil.which("dot") and not output_path.endswith(".dot"):
        subprocess.run(
            ["dot", "-Tpng", dot_path, "-o", output_path], check=False, timeout=60
        )
    return dot_path
