"""The program under test for the `resnet50` configuration: the port's
ResNet-50 (`paddle_tpu_torch.models.resnet`) in an `SGDTrainer` with
momentum SGD, at the configuration's precision."""

from __future__ import annotations

from typing import Any, Mapping


def build_trainer(cfg: Mapping[str, Any], device, parallel=None):
    from paddle_tpu_torch.models.resnet import resnet
    from paddle_tpu_torch.nn.graph import reset_name_scope
    from paddle_tpu_torch.optim import SGD
    from paddle_tpu_torch.trainer import SGDTrainer

    reset_name_scope()
    cost = resnet(cfg["depth"], num_classes=cfg["classes"], image_size=cfg["image_size"])[3]
    opt = cfg["optimizer"]
    return SGDTrainer(cost, SGD(learning_rate=opt["learning_rate"], momentum=opt["momentum"]),
                      device=device, precision=cfg["precision"], parallel=parallel)


def first_grads(cfg: Mapping[str, Any], slots: Mapping[str, Any]) -> dict:
    """The step-1 gradient of every parameter as the optimizer got it, from
    its state after that step: v1 = -lr g."""
    lr = cfg["optimizer"]["learning_rate"]
    return {k: -s[0] / lr for k, s in slots.items()}
