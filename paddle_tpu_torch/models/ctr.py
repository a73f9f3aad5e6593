"""CTR wide&deep (counterpart of `paddle_tpu/models/ctr.py`): BASELINE
config #4.

Wide part: a dense multi-hot feature vector through one linear unit. Deep
part: one categorical id a slot through its own embedding table, the
slots' embeddings concatenated, then a relu MLP to one unit. The two units
are summed under a sigmoid (the click probability) and scored by soft
binary cross-entropy against the 0/1 click. Ids outside a table read NaN
rows, as the JAX package's `jnp.take` does (`layers.Embedding`)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.graph import ParamAttr


def ctr_wide_deep(
    wide_dim: int = 1000,
    slot_vocab_sizes: Sequence[int] = (1000, 1000, 500, 100),
    embed_dim: int = 32,
    hidden_dims: Sequence[int] = (128, 64),
    embedding_sharding: Optional[Tuple] = None,
):
    """Returns (inputs, label, prediction, cost); inputs = [wide_input,
    slot0_ids, slot1_ids, ...]. `embedding_sharding` is a LOGICAL-axes
    tuple, e.g. ("expert", None): every deep table's rows declare it, and
    the deployment's rules table decides whether that splits them (a mesh
    with an "expert" axis: each rank stores its rows, gathered for the
    step, `parallel/updaters.py`) or keeps them whole (a data-only mesh)."""
    wide_in = L.Data("wide_features", shape=(wide_dim,))
    slot_ids = [L.Data(f"slot{i}_id", shape=()) for i in range(len(slot_vocab_sizes))]
    label = L.Data("click", shape=(1,))

    wide = L.Fc(wide_in, 1, act=None, name="wide_lr")
    def attr():
        return (ParamAttr(logical_axes=tuple(embedding_sharding))
                if embedding_sharding is not None else None)

    embeds = [L.Embedding(ids, embed_dim, vocab_size=vocab, param_attr=attr(),
                          name=f"slot{i}_emb")
              for i, (ids, vocab) in enumerate(zip(slot_ids, slot_vocab_sizes))]
    deep = L.Concat(embeds, name="deep_concat")
    for j, h in enumerate(hidden_dims):
        deep = L.Fc(deep, h, act="relu", name=f"deep_fc{j}")
    deep_out = L.Fc(deep, 1, act=None, name="deep_out")

    prob = L.Addto([wide, deep_out], act="sigmoid", name="ctr_prob")
    cost = C.SoftBinaryCrossEntropy(prob, label, name="cost")
    return [wide_in] + slot_ids, label, prob, cost
