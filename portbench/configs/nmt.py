"""The program under test for the `nmt` configuration: the port's
seq2seq model (`paddle_tpu_torch.models.seq2seq`: the fused GRU kernels,
the attention decoder) in an `SGDTrainer` with Adam, f32 with TF32 off."""

from __future__ import annotations

from typing import Any, Mapping


def build_trainer(cfg: Mapping[str, Any], device, parallel=None):
    from paddle_tpu_torch.models import Seq2SeqModel
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    model = Seq2SeqModel(cfg["src_vocab"], cfg["trg_vocab"], embed_dim=cfg["embed_dim"],
                         hidden_dim=cfg["hidden_dim"])
    opt = cfg["optimizer"]
    return SGDTrainer(model.cost, Adam(learning_rate=opt["learning_rate"], beta1=opt["beta1"],
                                       beta2=opt["beta2"], epsilon=opt["epsilon"]),
                      device=device, precision=cfg["precision"], parallel=parallel)


def first_grads(cfg: Mapping[str, Any], slots: Mapping[str, Any]) -> dict:
    """The step-1 gradient of every parameter as the optimizer got it, from
    its state after that step: m1 = (1 - beta1) g."""
    return {k: s[0] / (1.0 - cfg["optimizer"]["beta1"]) for k, s in slots.items()}
