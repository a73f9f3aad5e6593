"""OCR CRNN + CTC (counterpart of `paddle_tpu/models/ocr_crnn.py`):
BASELINE config #5.

Three 3x3 convs with relu, max pools of 2, 2 and (2, 1) (the last keeps
the width, which becomes time) and a batch norm with moving statistics;
`BlockExpand` turns each column of the feature map into one frame; a
bidirectional LSTM reads the frames and an fc gives each frame's class
scores (class 0 is the CTC blank); `CTCCost` aligns them to the label
string. The LSTMs keep `Lstm`'s default peepholes, as in the JAX package,
so they run the plain step loop (`ops/rnn.lstm_step_loop`) on the card as
on the CPU: no fused kernel computes peepholes."""

from __future__ import annotations

from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn import struct_costs as SC
from paddle_tpu_torch.nn.recurrent import bidirectional_lstm


def ocr_crnn(
    image_height: int = 32,
    image_width: int = 128,
    num_channels: int = 1,
    num_classes: int = 80,
    rnn_hidden: int = 96,
):
    """Returns (image, label, frame_logits, cost); the label is an int
    sequence of ids in [1, num_classes]."""
    img = L.Data("image", shape=(image_height, image_width, num_channels))
    label = L.Data("label", shape=(), is_seq=True)

    x = L.Conv2D(img, 32, 3, padding=1, act="relu", name="c1")
    x = L.Pool2D(x, 2, "max", name="p1")
    x = L.Conv2D(x, 64, 3, padding=1, act="relu", name="c2")
    x = L.Pool2D(x, 2, "max", name="p2")
    x = L.Conv2D(x, 128, 3, padding=1, act="relu", name="c3")
    x = L.BatchNorm(x, act="relu", name="bn3")
    x = L.Pool2D(x, (2, 1), "max", stride=(2, 1), name="p3")

    seq = L.BlockExpand(x, block_x=1, block_y=image_height // 8, name="im2seq")
    rnn = bidirectional_lstm(seq, rnn_hidden, name="blstm")
    logits = L.Fc(rnn, num_classes + 1, act=None, name="frame_logits")
    cost = SC.CTCCost(logits, label, blank=0, name="cost")
    return img, label, logits, cost
