"""Model zoo of the port (counterpart of `paddle_tpu/models/`): the seq2seq
NMT model's training graph and the LSTM text classifier."""

from paddle_tpu_torch.models.seq2seq import Seq2SeqModel, seq2seq
from paddle_tpu_torch.models.text_lstm import text_lstm

__all__ = ["Seq2SeqModel", "seq2seq", "text_lstm"]
