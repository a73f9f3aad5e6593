"""LSTM text classification (counterpart of `paddle_tpu/models/text_lstm.py`),
the reference's RNN benchmark (benchmark/paddle/rnn/rnn.py; BASELINE.md's
LSTM rows): embedding -> num_layers x (fc(4H) + lstmemory) -> max SeqPool
-> fc to the classes -> ClassificationCost.

As in the JAX package, the LSTM layers keep `Lstm`'s default peepholes,
so they run the plain step loop; the same graph with
`simple_lstm(..., use_peephole=False)` runs the fused LSTM kernels."""

from __future__ import annotations

from paddle_tpu_torch.nn import costs as C
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.recurrent import simple_lstm
from paddle_tpu_torch.nn.seq_layers import SeqPool


def text_lstm(
    vocab_size: int = 30000,
    embed_dim: int = 128,
    hidden_dim: int = 256,
    num_layers: int = 2,
    num_classes: int = 2,
):
    """Returns (data, label, logits, cost)."""
    ids = L.Data("word_ids", shape=(vocab_size,), is_seq=True)
    label = L.Data("label", shape=())
    x = L.Embedding(ids, embed_dim, vocab_size=vocab_size, name="emb")
    for i in range(num_layers):
        x = simple_lstm(x, hidden_dim, name=f"lstm{i}")
    pooled = SeqPool(x, "max", name="pool")
    logits = L.Fc(pooled, num_classes, act=None, name="logits")
    cost = C.ClassificationCost(logits, label, name="cost")
    return ids, label, logits, cost
