"""Model zoo of the port (counterpart of `paddle_tpu/models/`): the seq2seq
NMT model's training graph."""

from paddle_tpu_torch.models.seq2seq import Seq2SeqModel, seq2seq

__all__ = ["Seq2SeqModel", "seq2seq"]
