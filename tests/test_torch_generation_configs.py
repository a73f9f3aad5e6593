"""Configs and batches shared by the generation tests of the port
(`tests/test_torch_generation*.py`).

`SEQ2SEQ_DEMO` is demo/seqToseq/seqToseq_net.py of PaddlePaddle v0.11 as
one config: `is_generating=0` builds the training network (the decoder a
recurrent_group over the target words), `is_generating=1` the generating
one (the same step under beam_search, the target embedding a
GeneratedInput named as the training table, a seqtext printer over
`sent_id` and `outputs('__beam_search_predict__')`). Its widths, beam and
length come from config args."""

import os
import textwrap

import numpy as np

SEQ2SEQ_DEMO = """
from paddle.trainer_config_helpers import *

is_generating = get_config_arg("is_generating", bool, False)
source_dict_dim = get_config_arg("vocab", int, 64)
target_dict_dim = source_dict_dim
word_vector_dim = encoder_size = decoder_size = get_config_arg("size", int, 16)
beam_size = get_config_arg("beam_size", int, 3)
max_length = get_config_arg("max_length", int, 8)
num_results = get_config_arg("num_results", int, 1)
settings(batch_size=4, learning_rate=5e-4, learning_method=AdamOptimizer())

src_word_id = data_layer(name="source_language_word", size=source_dict_dim)
src_embedding = embedding_layer(
    input=src_word_id, size=word_vector_dim,
    param_attr=ParamAttr(name="_source_language_embedding"))
src_forward = simple_gru(input=src_embedding, size=encoder_size, naive=True,
                         gru_layer_attr=ExtraLayerAttribute(error_clipping_threshold=50))
src_backward = simple_gru(input=src_embedding, size=encoder_size, reverse=True,
                          naive=True,
                          gru_layer_attr=ExtraLayerAttribute(error_clipping_threshold=50))
encoded_vector = concat_layer(input=[src_forward, src_backward])

with mixed_layer(size=decoder_size) as encoded_proj:
    encoded_proj += full_matrix_projection(input=encoded_vector)

backward_first = first_seq(input=src_backward)
with mixed_layer(size=decoder_size, act=TanhActivation()) as decoder_boot:
    decoder_boot += full_matrix_projection(input=backward_first)


def gru_decoder_with_attention(enc_vec, enc_proj, current_word):
    decoder_mem = memory(name="gru_decoder", size=decoder_size, boot_layer=decoder_boot)
    context = simple_attention(encoded_sequence=enc_vec, encoded_proj=enc_proj,
                               decoder_state=decoder_mem)
    with mixed_layer(size=decoder_size * 3) as decoder_inputs:
        decoder_inputs += full_matrix_projection(input=context)
        decoder_inputs += full_matrix_projection(input=current_word)
    gru_step = gru_step_layer(name="gru_decoder", input=decoder_inputs,
                              output_mem=decoder_mem, size=decoder_size)
    with mixed_layer(size=target_dict_dim, bias_attr=True,
                     act=SoftmaxActivation()) as out:
        out += full_matrix_projection(input=gru_step)
    return out


group_inputs = [StaticInput(input=encoded_vector, is_seq=True),
                StaticInput(input=encoded_proj, is_seq=True)]
if not is_generating:
    trg_embedding = embedding_layer(
        input=data_layer(name="target_language_word", size=target_dict_dim),
        size=word_vector_dim, param_attr=ParamAttr(name="_target_language_embedding"))
    group_inputs.append(trg_embedding)
    decoder = recurrent_group(name="decoder_group", step=gru_decoder_with_attention,
                              input=group_inputs)
    lbl = data_layer(name="target_language_next_word", size=target_dict_dim)
    outputs(classification_cost(input=decoder, label=lbl))
else:
    trg_embedding = GeneratedInput(size=target_dict_dim,
                                   embedding_name="_target_language_embedding",
                                   embedding_size=word_vector_dim)
    group_inputs.append(trg_embedding)
    beam_gen = beam_search(name="decoder_group", step=gru_decoder_with_attention,
                           input=group_inputs, bos_id=0, eos_id=1, beam_size=beam_size,
                           max_length=max_length, num_results_per_sample=num_results)
    seqtext_printer_evaluator(input=beam_gen, id_input=data_layer(name="sent_id", size=1),
                              dict_file="trg.dict", result_file="gen_result.txt")
    Outputs("__beam_search_predict__")
"""


def write_demo(dirname, vocab: int) -> str:
    """The demo config and its target dictionary (`<s>`, `<e>`, `<unk>`,
    then w3 ... w{vocab-1}) in `dirname` -> the config's path."""
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, "seqToseq_net.py")
    with open(path, "w") as f:
        f.write(textwrap.dedent(SEQ2SEQ_DEMO))
    words = ["<s>", "<e>", "<unk>"] + [f"w{i}" for i in range(3, vocab)]
    with open(os.path.join(dirname, "trg.dict"), "w") as f:
        f.write("\n".join(words) + "\n")
    return path


def demo_args(vocab=64, size=16, beam_size=3, max_length=8, num_results=1,
              is_generating=True) -> str:
    return (f"is_generating={int(is_generating)},vocab={vocab},size={size},"
            f"beam_size={beam_size},max_length={max_length},num_results={num_results}")


def source_batch(b=4, vocab=64, seed=0, lengths=(5, 3, 6, 2)):
    """Source sentences (ids in [2, vocab), bench.py's draws) and sent_id."""
    rs = np.random.RandomState(seed)
    lens = np.asarray(lengths[:b], np.int32)
    return {"source_language_word": rs.randint(2, vocab, (b, int(lens.max()))).astype(np.int32),
            "source_language_word.lengths": lens,
            "sent_id": np.arange(b, dtype=np.int32)}


def v2_nmt(paddle, vocab: int, size: int, is_generating: bool, simple_gru=None,
           gru_step=None, beam_size: int = 3, max_length: int = 50):
    """The machine translation network of the paddle.v2 book
    (08.machine_translation train.py `seqToseq_net`) over a `paddle.v2`
    module: two simple_gru encoders (the fused GRU), additive attention, a
    recurrent_group decoder of fc + gru_step + softmax fc; generating, the
    same step under beam_search with the target table a GeneratedInput.
    `simple_gru` / `gru_step` default to the module's own (the JAX
    package's v2 simple_gru drops its name, so its twin passes
    `nn.recurrent.simple_gru`, and its v2 layer module has no gru_step)."""
    simple_gru = simple_gru or paddle.networks.simple_gru
    gru_step = gru_step or paddle.layer.gru_step
    src = paddle.layer.data(name="source_language_word",
                            type=paddle.data_type.integer_value_sequence(vocab))
    src_emb = paddle.layer.embedding(input=src, size=size)
    fwd = simple_gru(input=src_emb, size=size, name="src_forward")
    bwd = simple_gru(input=src_emb, size=size, reverse=True, name="src_backward")
    encoded = paddle.layer.concat(input=[fwd, bwd])
    encoded_proj = paddle.layer.fc(act=paddle.activation.Linear(), size=size,
                                   bias_attr=False, input=encoded)
    boot = paddle.layer.fc(size=size, act=paddle.activation.Tanh(), bias_attr=False,
                           input=paddle.layer.first_seq(input=bwd))

    def decoder_step(enc_vec, enc_proj, current_word):
        mem = paddle.layer.memory(name="gru_decoder", size=size, boot_layer=boot)
        context = paddle.networks.simple_attention(encoded_sequence=enc_vec,
                                                   encoded_proj=enc_proj, decoder_state=mem)
        inputs = paddle.layer.fc(
            act=paddle.activation.Linear(), size=size * 3, bias_attr=False,
            input=[context, current_word],
            layer_attr=paddle.attr.ExtraLayerAttribute(error_clipping_threshold=100.0))
        gru = gru_step(name="gru_decoder", input=inputs, output_mem=mem, size=size)
        return paddle.layer.fc(size=vocab, bias_attr=True, act=paddle.activation.Softmax(),
                               input=gru)

    group_inputs = [paddle.layer.StaticInput(input=encoded),
                    paddle.layer.StaticInput(input=encoded_proj)]
    if not is_generating:
        trg = paddle.layer.embedding(
            input=paddle.layer.data(name="target_language_word",
                                    type=paddle.data_type.integer_value_sequence(vocab)),
            size=size, param_attr=paddle.attr.ParamAttr(name="_target_language_embedding"))
        decoder = paddle.layer.recurrent_group(name="decoder_group", step=decoder_step,
                                               input=group_inputs + [trg])
        label = paddle.layer.data(name="target_language_next_word",
                                  type=paddle.data_type.integer_value_sequence(vocab))
        return paddle.layer.classification_cost(input=decoder, label=label)
    trg = paddle.layer.GeneratedInput(size=vocab, embedding_name="_target_language_embedding",
                                      embedding_size=size)
    return paddle.layer.beam_search(name="decoder_group", step=decoder_step,
                                    input=group_inputs + [trg], bos_id=0, eos_id=1,
                                    beam_size=beam_size, max_length=max_length)


def nmt_samples(n: int, vocab: int, seed: int, lengths=(3, 7)):
    """(source ids, target ids, next target ids) as bench.py draws them:
    ids uniform in [2, vocab), the next words the target shifted then <e>."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = rs.randint(2, vocab, size=rs.randint(lengths[0], lengths[1] + 1))
        trg = rs.randint(2, vocab, size=rs.randint(lengths[0], lengths[1] + 1))
        out.append((src.tolist(), trg.tolist(), np.append(trg[1:], 1).tolist()))
    return out
