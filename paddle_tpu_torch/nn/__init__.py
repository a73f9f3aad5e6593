"""The v1 layer graph of the port (counterpart of `paddle_tpu/nn/`), the
parts the seq2seq training path uses: `graph.py` (Argument, ParamAttr,
Layer, Network), `layers.py` (Data, Fc, Embedding, Concat), `costs.py`,
`recurrent.py` (Gru, simple_gru, bidirectional_gru) and
`attention_layers.py` (AttentionDecoder); `convert.py` moves parameter dicts
to and from the JAX package."""
