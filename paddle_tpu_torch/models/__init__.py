"""Model zoo of the port (counterpart of `paddle_tpu/models/`): the seq2seq
NMT model's training graph, the LSTM text classifier, ResNet and LeNet."""

from paddle_tpu_torch.models.lenet import lenet
from paddle_tpu_torch.models.resnet import resnet, resnet50
from paddle_tpu_torch.models.seq2seq import Seq2SeqModel, seq2seq
from paddle_tpu_torch.models.text_lstm import text_lstm

__all__ = ["Seq2SeqModel", "lenet", "resnet", "resnet50", "seq2seq", "text_lstm"]
