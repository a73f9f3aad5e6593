"""paddle.v2.networks analog (counterpart of `paddle_tpu/v2/networks.py`;
trainer_config_helpers/networks.py): prebuilt composites —
simple_img_conv_pool (:144), vgg_16_network (:468), simple_lstm (:553),
simple_gru (:981), simple_attention (:1304), text_conv_pool,
bidirectional_lstm."""

from __future__ import annotations

from typing import Sequence

from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn import recurrent as R
from paddle_tpu_torch.nn import seq_layers as S
from paddle_tpu_torch.nn.attention_layers import SimpleAttention
from paddle_tpu_torch.v2.activation import resolve as _act
from paddle_tpu_torch.v2.pooling import resolve as _pool


def simple_img_conv_pool(
    input, filter_size, num_filters, pool_size, pool_stride=None,
    act=None, pool_type=None, num_channel=None, param_attr=None, name=None, **_compat,
):
    conv = L.Conv2D(
        input, num_filters, filter_size, padding=(filter_size - 1) // 2,
        act=_act(act) or "relu", param_attr=param_attr,
        name=(name + "_conv") if name else None,
    )
    return L.Pool2D(conv, pool_size, _pool(pool_type), stride=pool_stride or pool_size,
                    name=(name + "_pool") if name else None)


def img_conv_group(
    input, conv_num_filter: Sequence[int], pool_size, conv_filter_size=3,
    conv_act=None, conv_with_batchnorm=False, pool_stride=None, pool_type=None, **_compat,
):
    x = input
    for i, nf in enumerate(conv_num_filter):
        x = L.Conv2D(x, nf, conv_filter_size, padding=(conv_filter_size - 1) // 2,
                     act=None if conv_with_batchnorm else (_act(conv_act) or "relu"))
        if conv_with_batchnorm:
            x = L.BatchNorm(x, act=_act(conv_act) or "relu")
    return L.Pool2D(x, pool_size, _pool(pool_type), stride=pool_stride or pool_size)


def vgg_16_network(input_image, num_channels=3, num_classes=1000):
    """vgg_16_network (networks.py:468)."""
    x = input_image
    for nf, reps in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        x = img_conv_group(x, [nf] * reps, pool_size=2, conv_with_batchnorm=True)
    x = L.Fc(x, 4096, act="relu")
    x = L.Dropout(x, 0.5)
    x = L.Fc(x, 4096, act="relu")
    x = L.Dropout(x, 0.5)
    return L.Fc(x, num_classes, act="softmax")


def simple_lstm(input, size, reverse=False, mat_param_attr=None,
                lstm_cell_attr=None, act=None, gate_act=None, state_act=None, **_compat):
    return R.simple_lstm(input, size, reverse=reverse)


def simple_gru(input, size, reverse=False, name=None, **_compat):
    """fc(3H) + the fused grumemory. `name` names the GRU (default "gru"),
    so two directions can sit in one network; the JAX package drops it
    (ROADMAP.md §3)."""
    return R.simple_gru(input, size, reverse=reverse, **({"name": name} if name else {}))


def bidirectional_lstm(input, size, return_seq=False, **_compat):
    out = R.bidirectional_lstm(input, size)
    if return_seq:
        return out
    return S.LastSeq(out)


def text_conv_pool(input, context_len=5, hidden_size=128, act=None, **_compat):
    """sequence_conv_pool: context window projection → fc → max-pool over time."""
    from paddle_tpu_torch.nn import projections as P

    ctx = L.Mixed([P.Context_(input, -(context_len // 2), context_len)],
                  size=input.cfg.get("size", hidden_size) if hasattr(input, "cfg") else hidden_size)
    h = L.Fc(ctx, hidden_size, act=_act(act) or "tanh")
    return S.SeqPool(h, "max")


sequence_conv_pool = text_conv_pool


def simple_attention(encoded_sequence, encoded_proj=None, decoder_state=None,
                     transform_param_attr=None, softmax_param_attr=None,
                     weight_act=None, name=None, **_compat):
    """simple_attention (networks.py:1304) — additive attention composed from
    the same primitive ops the reference uses (the encoded_proj transform is
    computed internally from encoded_sequence)."""
    return SimpleAttention(encoded_sequence, decoder_state, name=name)
