"""SSD-style single-shot detector over a small VGG-like backbone
(counterpart of `paddle_tpu/models/ssd.py`): three conv stages, each head a
(loc conv, conf conv, priorbox) triple, the multibox loss for training and
the detection output for inference."""

from __future__ import annotations

from typing import Sequence

from paddle_tpu_torch.nn import detection_layers as D
from paddle_tpu_torch.nn import layers as L


def ssd(image_size: int = 96, num_classes: int = 21, widths: Sequence[int] = (32, 64, 128)):
    """Returns (image, gt_boxes, gt_labels, cost_layer, detection_out). Four
    priors a cell (one min size, one geometric mean, aspect 2 and 1/2); the
    heads' anchor scales split 0.15..0.9 of the image into one band each."""
    img = L.Data("image", shape=(image_size, image_size, 3))
    gtb = L.Data("gt_boxes", shape=(None, 4))
    gtl = L.Data("gt_labels", shape=(None,))

    x = img
    feats = []
    for i, w in enumerate(widths):
        x = L.Conv2D(x, w, 3, padding=1, act="relu", name=f"conv{i}a")
        x = L.Conv2D(x, w, 3, padding=1, act="relu", name=f"conv{i}b")
        x = L.Pool2D(x, 2, "max", name=f"pool{i}")
        feats.append(x)

    k = 4
    bands = [0.15 + (0.9 - 0.15) * i / len(feats) for i in range(len(feats) + 1)]
    scale_min = [image_size * s for s in bands[:-1]]
    scale_max = [image_size * s for s in bands[1:]]
    locs, confs, pbs = [], [], []
    for i, f in enumerate(feats):
        locs.append(L.Conv2D(f, 4 * k, 3, padding=1, act=None, name=f"loc{i}"))
        confs.append(L.Conv2D(f, num_classes * k, 3, padding=1, act=None, name=f"conf{i}"))
        pbs.append(D.PriorBox(f, (image_size, image_size), [scale_min[i]], [scale_max[i]],
                              [2.0], name=f"pb{i}"))
    cost = D.MultiBoxLoss(locs, confs, pbs, gtb, gtl, num_classes=num_classes,
                          name="mbox_loss")
    out = D.DetectionOutput(locs, confs, pbs, num_classes=num_classes, name="detection")
    return img, gtb, gtl, cost, out
