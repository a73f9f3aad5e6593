"""Model zoo of the port (counterpart of `paddle_tpu/models/`): the seq2seq
NMT model's training graph, the LSTM text classifier, ResNet, LeNet, CTR
wide&deep, the OCR CRNN, VGG, and the reference's benchmark image models
AlexNet and GoogLeNet, and the SSD detector."""

from paddle_tpu_torch.models.alexnet import alexnet
from paddle_tpu_torch.models.ctr import ctr_wide_deep
from paddle_tpu_torch.models.googlenet import googlenet
from paddle_tpu_torch.models.lenet import lenet
from paddle_tpu_torch.models.ocr_crnn import ocr_crnn
from paddle_tpu_torch.models.resnet import resnet, resnet50
from paddle_tpu_torch.models.seq2seq import Seq2SeqModel, seq2seq
from paddle_tpu_torch.models.ssd import ssd
from paddle_tpu_torch.models.text_lstm import text_lstm
from paddle_tpu_torch.models.vgg import vgg, vgg16, vgg19

__all__ = ["Seq2SeqModel", "alexnet", "ctr_wide_deep", "googlenet", "lenet", "ocr_crnn",
           "resnet", "resnet50", "seq2seq", "ssd", "text_lstm", "vgg", "vgg16", "vgg19"]
