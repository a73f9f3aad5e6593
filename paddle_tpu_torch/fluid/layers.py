"""The fluid layers API (counterpart of `paddle_tpu/fluid/layers.py`;
python/paddle/v2/framework/layers.py): each helper creates vars and
appends OpDescs to the default Program, with the JAX package's names,
shapes and initializers, so both packages build the same program."""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

import numpy as np

from paddle_tpu_torch.fluid.framework import Program, Variable

_tls = threading.local()


def default_main_program() -> Program:
    prog = getattr(_tls, "main_program", None)
    if prog is None:
        prog = _tls.main_program = Program()
    return prog


def reset_default_program() -> Program:
    _tls.main_program = Program()
    return _tls.main_program


def _block():
    return default_main_program().current_block()


# -- inputs -----------------------------------------------------------------


def data(name: str, shape: Sequence[int], dtype=np.float32, lod_level: int = 0) -> Variable:
    """Batch axis is implicit (the reference uses -1 leading dim)."""
    return _block().create_var(
        name, shape=list(shape), dtype=dtype, is_data=True, lod_level=lod_level
    )


# -- layers -----------------------------------------------------------------


def fc(
    input: Variable,
    size: int,
    act: Optional[str] = None,
    bias_attr: bool = True,
    name: Optional[str] = None,
    num_flatten_dims: int = 1,
) -> Variable:
    block = _block()
    prog = block.program
    name = name or prog.unique_name("fc")
    # ignore batch markers (-1/None) when sizing the weight
    known = [
        d for d in (input.desc.shape or [])[num_flatten_dims - 1 :]
        if d is not None and d > 0
    ]
    in_dim = int(np.prod(known)) if known else None
    bound = 1.0 / math.sqrt(in_dim) if in_dim else 0.1
    w = block.create_parameter(
        f"{name}.w", shape=[in_dim, size], initializer=("uniform", -bound, bound)
    )
    out = block.create_var(f"{name}.mul_out", shape=list(input.desc.shape[:num_flatten_dims - 1]) + [size])
    block.append_op(
        "mul", {"X": input, "Y": w}, {"Out": out},
        {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    if bias_attr:
        b = block.create_parameter(
            f"{name}.b", shape=[size], initializer=("constant", 0.0)
        )
        out2 = block.create_var(f"{name}.bias_out", shape=out.desc.shape)
        # axis=-1: bias broadcasts over trailing feature dim
        block.append_op("elementwise_add", {"X": out, "Y": b}, {"Out": out2}, {"axis": -1})
        out = out2
    return _activation(out, act, name)


def _activation(x: Variable, act: Optional[str], name: str) -> Variable:
    if act is None:
        return x
    block = _block()
    out = block.create_var(f"{name}.{act}", shape=x.desc.shape)
    block.append_op(act, {"X": x}, {"Y": out}, {})
    return out


def embedding(input: Variable, size: Sequence[int], name: Optional[str] = None) -> Variable:
    block = _block()
    name = name or block.program.unique_name("embedding")
    w = block.create_parameter(
        f"{name}.w", shape=list(size), initializer=("uniform", -0.05, 0.05)
    )
    out = block.create_var(f"{name}.out", shape=[None, size[1]])
    block.append_op("lookup_table", {"W": w, "Ids": input}, {"Out": out}, {})
    return out


def conv2d(
    input: Variable,
    num_filters: int,
    filter_size: int,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
    act: Optional[str] = None,
    name: Optional[str] = None,
) -> Variable:
    block = _block()
    name = name or block.program.unique_name("conv2d")
    in_c = input.desc.shape[0] if len(input.desc.shape) == 3 else input.desc.shape[-3]
    fan_in = in_c * filter_size * filter_size
    w = block.create_parameter(
        f"{name}.w",
        shape=[num_filters, in_c // groups, filter_size, filter_size],
        initializer=("normal", 0.0, math.sqrt(2.0 / fan_in)),
    )
    # spatial dims are data-dependent; channel count is what downstream
    # layers (batch_norm) need statically
    out = block.create_var(f"{name}.out", shape=[num_filters, None, None])
    block.append_op(
        "conv2d", {"Input": input, "Filter": w}, {"Output": out},
        {"strides": [stride, stride], "paddings": [padding, padding], "groups": groups},
    )
    return _activation(out, act, name)


def pool2d(
    input: Variable,
    pool_size: int = 2,
    pool_type: str = "max",
    pool_stride: Optional[int] = None,
    pool_padding: int = 0,
    global_pooling: bool = False,
    name: Optional[str] = None,
) -> Variable:
    block = _block()
    name = name or block.program.unique_name("pool2d")
    out = block.create_var(f"{name}.out", shape=input.desc.shape)
    block.append_op(
        "pool2d", {"X": input}, {"Out": out},
        {"ksize": [pool_size, pool_size], "pooling_type": pool_type,
         "strides": [pool_stride or pool_size] * 2,
         "paddings": [pool_padding, pool_padding],
         "global_pooling": global_pooling},
    )
    return out


def batch_norm(input: Variable, act: Optional[str] = None, name: Optional[str] = None) -> Variable:
    block = _block()
    name = name or block.program.unique_name("batch_norm")
    c = input.desc.shape[-3] if len(input.desc.shape) >= 3 else input.desc.shape[-1]
    scale = block.create_parameter(f"{name}.scale", shape=[c], initializer=("constant", 1.0))
    bias = block.create_parameter(f"{name}.bias", shape=[c], initializer=("constant", 0.0))
    mean = block.create_parameter(
        f"{name}_mean", shape=[c], initializer=("constant", 0.0), trainable=False
    )
    var = block.create_parameter(
        f"{name}_variance", shape=[c], initializer=("constant", 1.0), trainable=False
    )
    out = block.create_var(f"{name}.out", shape=input.desc.shape)
    block.append_op(
        "batch_norm",
        {"X": input, "Scale": scale, "Bias": bias, "Mean": mean, "Variance": var},
        # MeanOut/VarianceOut write back into the same running-stat vars
        {"Y": out, "MeanOut": mean, "VarianceOut": var},
        {},
    )
    return _activation(out, act, name)


def dropout(input: Variable, dropout_prob: float, name: Optional[str] = None) -> Variable:
    block = _block()
    name = name or block.program.unique_name("dropout")
    out = block.create_var(f"{name}.out", shape=input.desc.shape)
    mask = block.create_var(f"{name}.mask", shape=input.desc.shape)
    block.append_op("dropout", {"X": input}, {"Out": out, "Mask": mask},
                    {"dropout_prob": dropout_prob})
    return out


def softmax(input: Variable, name: Optional[str] = None) -> Variable:
    return _activation(input, "softmax", name or _block().program.unique_name("sm"))


def cross_entropy(input: Variable, label: Variable, soft_label: bool = False) -> Variable:
    block = _block()
    out = block.create_var(block.program.unique_name("xent"))
    block.append_op("cross_entropy", {"X": input, "Label": label}, {"Y": out},
                    {"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits: Variable, label: Variable) -> Variable:
    block = _block()
    loss = block.create_var(block.program.unique_name("loss"))
    sm = block.create_var(block.program.unique_name("softmax"))
    block.append_op("softmax_with_cross_entropy", {"Logits": logits, "Label": label},
                    {"Loss": loss, "Softmax": sm}, {})
    return loss


def mean(x: Variable) -> Variable:
    block = _block()
    out = block.create_var(block.program.unique_name("mean"), shape=[])
    block.append_op("mean", {"X": x}, {"Out": out}, {})
    return out


def accuracy(input: Variable, label: Variable, k: int = 1) -> Variable:
    block = _block()
    topk = block.create_var(block.program.unique_name("topk"))
    idx = block.create_var(block.program.unique_name("topk_idx"))
    block.append_op("top_k", {"X": input}, {"Out": topk, "Indices": idx}, {"k": k})
    acc = block.create_var(block.program.unique_name("acc"), shape=[])
    block.append_op("accuracy", {"Indices": idx, "Label": label}, {"Accuracy": acc}, {})
    return acc


def concat(inputs: Sequence[Variable], axis: int = 0) -> Variable:
    block = _block()
    out = block.create_var(block.program.unique_name("concat"))
    block.append_op("concat", {"X": list(inputs)}, {"Out": out}, {"axis": axis})
    return out


def reshape(x: Variable, shape: Sequence[int]) -> Variable:
    block = _block()
    out = block.create_var(block.program.unique_name("reshape"), shape=list(shape))
    block.append_op("reshape", {"X": x}, {"Out": out}, {"shape": list(shape)})
    return out
