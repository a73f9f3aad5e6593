"""SSD detection layers (counterpart of `paddle_tpu/nn/detection_layers.py`):
`PriorBox`, `MultiBoxLoss`, `DetectionOutput`, and the v1 config surface's
`MultiBoxLossV1` / `DetectionOutputV1` over the packed slot encodings.

Each `PriorBox` binds to a conv feature map; `MultiBoxLoss` and
`DetectionOutput` take lists of (loc conv, conf conv, priorbox) heads and
concatenate them along the prior axis. Ground truth feeds as padded
tensors: `gt_boxes` [B, G, 4] (normalised corners) and `gt_labels` [B, G],
with `<slot>.lengths` (or, without lengths, an all-zero box is padding).

The priors are host constants (`ops/detection.prior_boxes`), as in the
JAX package, where they are baked into the traced program. Here each
`PriorBox` moves its [P, 8] block to the device once per feature-map shape
and device and keeps it, so a step graph captured later holds the same
tensor and makes no host copy."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.nn.graph import Argument, Context, Layer
from paddle_tpu_torch.ops import detection as det_ops



def _batch_mean(ctx: Context, cost: torch.Tensor) -> torch.Tensor:
    """The mean of a per-image cost over the global batch (the JAX
    package's `jnp.mean`, which takes no row mask); under a mesh this rank's
    share of it, so the ranks' costs add up to the mean."""
    world = getattr(ctx, "world", 1)
    if world == 1:
        return cost.mean()
    return cost.sum() / (cost.shape[0] * world)

class PriorBox(Layer):
    """Anchor generator bound to a conv feature map (PriorBox.cpp). Output:
    the [P, 8] block of 4 box coordinates and 4 variances, one row a prior,
    shared by every image of the batch."""

    type_name = "priorbox"

    def __init__(self, input: Layer, image_size: Tuple[int, int], min_size: Sequence[float],
                 max_size: Sequence[float] = (), aspect_ratio: Sequence[float] = (2.0,),
                 variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2), clip: bool = True,
                 name: Optional[str] = None):
        super().__init__(input, name=name)
        self.image_size = image_size
        self.min_size = list(min_size)
        self.max_size = list(max_size)
        self.aspect_ratio = list(aspect_ratio)
        self.variance = list(variance)
        self.clip = clip
        self._packed: Dict[tuple, torch.Tensor] = {}

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        feat = ins[0].value  # [B, H, W, C]
        key = (int(feat.shape[1]), int(feat.shape[2]), feat.device)
        packed = self._packed.get(key)
        if packed is None:
            boxes, var = det_ops.prior_boxes(key[:2], self.image_size, self.min_size,
                                             self.max_size, self.aspect_ratio,
                                             self.variance, self.clip)
            packed = self._packed[key] = torch.from_numpy(
                np.concatenate([boxes, var], axis=1)).to(feat.device)
        return Argument(packed)


def gather_heads(ins: List[Argument], n: int):
    """Inputs [loc..., conf..., prior...] (n each) -> (loc [B, P, 4], conf
    [B, P, C], priors [P, 4], variances [P, 4]), each head's priors
    concatenated along P. A loc head is a conv output [B, H, W, 4K], a conf
    head [B, H, W, C*K]."""
    locs, confs, priors, variances = [], [], [], []
    for i in range(n):
        loc = ins[i].value
        locs.append(loc.reshape(loc.shape[0], -1, 4))
    for i in range(n):
        conf = ins[n + i].value
        confs.append(conf.reshape(conf.shape[0], locs[i].shape[1], -1))
        packed = ins[2 * n + i].value
        priors.append(packed[:, :4])
        variances.append(packed[:, 4:])
    return (torch.cat(locs, dim=1), torch.cat(confs, dim=1), torch.cat(priors, dim=0),
            torch.cat(variances, dim=0))


def _pad_classes(conf: torch.Tensor, num_classes: int) -> torch.Tensor:
    """A conf block narrower than num_classes padded with zero logits (the
    v1 layers take any parse-time conf width, as the JAX package's do)."""
    if conf.shape[-1] < num_classes:
        conf = torch.nn.functional.pad(conf, (0, num_classes - conf.shape[-1]))
    return conf


class MultiBoxLoss(Layer):
    """SSD training loss (MultiBoxLossLayer.cpp): the batch mean of
    `ops/detection.multibox_loss`."""

    type_name = "multibox_loss"

    def __init__(self, loc_layers: Sequence[Layer], conf_layers: Sequence[Layer],
                 priorbox_layers: Sequence[Layer], gt_boxes: Layer, gt_labels: Layer,
                 num_classes: int, overlap_threshold: float = 0.5,
                 neg_pos_ratio: float = 3.0, background_id: int = 0,
                 name: Optional[str] = None):
        loc_layers, conf_layers = list(loc_layers), list(conf_layers)
        priorbox_layers = list(priorbox_layers)
        if not len(loc_layers) == len(conf_layers) == len(priorbox_layers):
            raise ValueError(f"multibox_loss {name}: {len(loc_layers)} loc, "
                             f"{len(conf_layers)} conf and {len(priorbox_layers)} "
                             "priorbox layers: want one of each a head")
        super().__init__(loc_layers + conf_layers + priorbox_layers + [gt_boxes, gt_labels],
                         name=name)
        self.n_heads = len(loc_layers)
        self.num_classes = num_classes
        self.overlap_threshold = overlap_threshold
        self.neg_pos_ratio = neg_pos_ratio
        self.background_id = background_id

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        n = self.n_heads
        loc, conf, priors, variances = gather_heads(ins, n)
        gtb_arg, gtl_arg = ins[3 * n], ins[3 * n + 1]
        gtb = gtb_arg.value
        if gtb_arg.lengths is not None:
            g = gtb.shape[1]
            valid = (torch.arange(g, device=gtb.device)[None, :]
                     < gtb_arg.lengths.to(gtb.device)[:, None])
        else:  # a gt row of all zeros is padding
            valid = (gtb != 0).any(dim=-1)
        cost = det_ops.multibox_loss(
            loc, conf, priors, variances, gtb, gtl_arg.value.long(), valid,
            overlap_threshold=self.overlap_threshold, neg_pos_ratio=self.neg_pos_ratio,
            background_id=self.background_id)
        return Argument(_batch_mean(ctx, cost))


class DetectionOutput(Layer):
    """Decode + per-class NMS -> [B, keep_top_k, 6] (DetectionOutputLayer.cpp;
    a row is label, score, xmin, ymin, xmax, ymax; rows of score 0 are
    padding)."""

    type_name = "detection_output"

    def __init__(self, loc_layers: Sequence[Layer], conf_layers: Sequence[Layer],
                 priorbox_layers: Sequence[Layer], num_classes: int, background_id: int = 0,
                 nms_threshold: float = 0.45, nms_top_k: int = 400, keep_top_k: int = 200,
                 confidence_threshold: float = 0.01, name: Optional[str] = None):
        loc_layers, conf_layers = list(loc_layers), list(conf_layers)
        super().__init__(loc_layers + conf_layers + list(priorbox_layers), name=name)
        self.n_heads = len(loc_layers)
        self.num_classes = num_classes
        self.background_id = background_id
        self.nms_threshold = nms_threshold
        self.nms_top_k = nms_top_k
        self.keep_top_k = keep_top_k
        self.confidence_threshold = confidence_threshold

    def detect(self, loc, conf, priors, variances) -> torch.Tensor:
        return det_ops.detection_output(
            loc, conf, priors, variances, num_classes=self.num_classes,
            background_id=self.background_id, nms_threshold=self.nms_threshold,
            nms_top_k=self.nms_top_k, keep_top_k=self.keep_top_k,
            confidence_threshold=self.confidence_threshold)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        return Argument(self.detect(*gather_heads(ins, self.n_heads)))


def _v1_heads(ins: List[Argument], first: int, n: int, num_classes: int):
    """The v1 slots' loc and conf heads from ins[first:] -> (loc [B, P, 4],
    conf [B, P, C] padded to num_classes)."""
    locs = [ins[first + i].value.reshape(ins[first + i].value.shape[0], -1, 4)
            for i in range(n)]
    confs = [ins[first + n + i].value.reshape(locs[i].shape[0], locs[i].shape[1], -1)
             for i in range(n)]
    return torch.cat(locs, dim=1), _pad_classes(torch.cat(confs, dim=1), num_classes)


class MultiBoxLossV1(Layer):
    """The v1 config surface's MultiBoxLoss (multibox_loss_layer): inputs in
    the reference's slot order [priorbox, label, loc..., conf...], with the
    packed v1 encodings (priorbox rows of 8: 4 coordinates + 4 variances;
    label rows of 6: class, x1, y1, x2, y2, difficult), through the same
    `ops/detection.multibox_loss`."""

    type_name = "multibox_loss"

    def __init__(self, input_loc: Sequence[Layer], input_conf: Sequence[Layer],
                 priorbox: Layer, label: Layer, num_classes: int,
                 overlap_threshold: float = 0.5, neg_pos_ratio: float = 3.0,
                 neg_overlap: float = 0.5, background_id: int = 0,
                 name: Optional[str] = None):
        locs, confs = list(input_loc), list(input_conf)
        super().__init__([priorbox, label] + locs + confs, name=name)
        self.n_heads = len(locs)
        self.num_classes = num_classes
        self.overlap_threshold = overlap_threshold
        self.neg_pos_ratio = neg_pos_ratio
        self.neg_overlap = neg_overlap
        self.background_id = background_id

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        packed = ins[0].value.reshape(ins[0].value.shape[0], -1, 8)[0]
        lab = ins[1].value
        lab = lab.reshape(lab.shape[0], -1, 6)
        loc, conf = _v1_heads(ins, 2, self.n_heads, self.num_classes)
        p = loc.shape[1]
        cost = det_ops.multibox_loss(
            loc, conf, packed[:p, :4], packed[:p, 4:], lab[:, :, 1:5],
            lab[:, :, 0].long(), (lab != 0).any(dim=-1),
            overlap_threshold=self.overlap_threshold, neg_pos_ratio=self.neg_pos_ratio,
            background_id=self.background_id)
        return Argument(_batch_mean(ctx, cost))


class DetectionOutputV1(DetectionOutput):
    """The v1 config surface's DetectionOutput: slots [priorbox, loc...,
    conf...], packed as MultiBoxLossV1's; each output row is 7 wide, the
    image's index in the batch first (getDetectionOutput's layout)."""

    def __init__(self, input_loc: Sequence[Layer], input_conf: Sequence[Layer],
                 priorbox: Layer, num_classes: int, nms_threshold: float = 0.45,
                 nms_top_k: int = 400, keep_top_k: int = 200,
                 confidence_threshold: float = 0.01, background_id: int = 0,
                 name: Optional[str] = None):
        locs, confs = list(input_loc), list(input_conf)
        Layer.__init__(self, [priorbox] + locs + confs, name=name)
        self.n_heads = len(locs)
        self.num_classes = num_classes
        self.nms_threshold = nms_threshold
        self.nms_top_k = nms_top_k
        self.keep_top_k = keep_top_k
        self.confidence_threshold = confidence_threshold
        self.background_id = background_id

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        packed = ins[0].value.reshape(ins[0].value.shape[0], -1, 8)[0]
        loc, conf = _v1_heads(ins, 1, self.n_heads, self.num_classes)
        p = loc.shape[1]
        out = self.detect(loc, conf, packed[:p, :4], packed[:p, 4:])
        b, k = out.shape[0], out.shape[1]
        img = torch.arange(b, dtype=out.dtype, device=out.device)[:, None, None]
        return Argument(torch.cat([img.expand(b, k, 1), out], dim=-1))
