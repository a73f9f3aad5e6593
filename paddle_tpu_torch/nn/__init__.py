"""The v1 layer graph of the port (counterpart of `paddle_tpu/nn/`), the
parts the ported paths use: `graph.py` (Argument with nested sub_lengths,
ParamAttr, Layer, Network, states), `layers.py` (every layer of the JAX
package's `nn/layers.py`), `costs.py` (every cost layer of the JAX
package's module), `struct_costs.py` (CTCCost, CRFCost, CRFDecoding,
NCECost, HierarchicalSigmoid, LambdaCost, CrossEntropyOverBeam),
`activations.py`, `recurrent.py` (Lstm, simple_lstm, bidirectional_lstm, Gru, simple_gru,
bidirectional_gru, SimpleRnn, MDLstm), `layers3d.py` (Conv3D,
Conv3DTranspose, Pool3D), `detection_layers.py` (PriorBox, MultiBoxLoss,
DetectionOutput and their packed v1 forms), `seq_layers.py` (SeqPool, LastSeq, FirstSeq, Expand,
SeqConcat, SeqReshape, SeqSlice, KmaxSeqScore, SubSeq, SubNestedSeq) and
`attention_layers.py` (AttentionDecoder), `beam_core.py` and
`beam_search.py` (beam-search generation); `convert.py` moves parameter and
state dicts to and from the JAX package."""
