"""SSD detection ops (counterpart of `paddle_tpu/ops/detection.py`): prior
boxes, IoU, box coding, matching, the multibox loss, NMS and the detection
output.

Boxes are normalised corners (xmin, ymin, xmax, ymax) throughout. The JAX
package writes the per-image stages for one example and `vmap`s them; here
every stage takes the batch axis itself, so one call is a fixed number of
batched kernels and nothing is read back to the host: matching is G rounds
of a global argmax over [B, P, G], NMS one loop of k steps over every
(image, class) pair at once, each step a few elementwise kernels. All of it
runs inside a captured CUDA graph.

Ties are broken as XLA breaks them: `lax.top_k` and `jnp.argsort` keep the
lower index first among equal values, and so does a stable `torch.sort`
(`torch.topk` does not promise it). The detection output's padding rows,
every one of score exactly 0, are chosen by that order too."""

from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

import numpy as np
import torch


def prior_boxes(
    feature_hw: Tuple[int, int],
    image_hw: Tuple[int, int],
    min_sizes: Sequence[float],
    max_sizes: Sequence[float],
    aspect_ratios: Sequence[float],
    variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
    clip: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor grid of one feature map -> ([P, 4] boxes, [P, 4] variances), f32
    numpy (host constants). Per cell, in PriorBoxLayer::forward's order: an
    aspect-1 box per min size, the sqrt(min*max) box when a max size is
    given, then one box per extra aspect ratio and its reciprocal."""
    fh, fw = feature_hw
    ih, iw = image_hw
    ratios = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - r) > 1e-6 for r in ratios):
            ratios.append(ar)
        recip = 1.0 / ar
        if all(abs(recip - r) > 1e-6 for r in ratios):
            ratios.append(recip)
    boxes = []
    for y, x in itertools.product(range(fh), range(fw)):
        cx = (x + 0.5) / fw
        cy = (y + 0.5) / fh
        for k, msize in enumerate(min_sizes):
            bw, bh = msize / iw, msize / ih
            boxes.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
            if k < len(max_sizes):
                s = math.sqrt(msize * max_sizes[k])
                bw, bh = s / iw, s / ih
                boxes.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
            for ar in ratios:
                if abs(ar - 1.0) < 1e-6:
                    continue
                bw = msize * math.sqrt(ar) / iw
                bh = msize / math.sqrt(ar) / ih
                boxes.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
    out = np.asarray(boxes, np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.tile(np.asarray(variances, np.float32)[None, :], (out.shape[0], 1))
    return out, var


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] Jaccard overlap."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp_min(a[..., 2] - a[..., 0], 0.0)
              * torch.clamp_min(a[..., 3] - a[..., 1], 0.0))
    area_b = (torch.clamp_min(b[..., 2] - b[..., 0], 0.0)
              * torch.clamp_min(b[..., 3] - b[..., 1], 0.0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12),
                       torch.zeros_like(union))


def _to_center(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + w / 2, boxes[..., 1] + h / 2, w, h


def encode_boxes(priors: torch.Tensor, variances: torch.Tensor,
                 gt: torch.Tensor) -> torch.Tensor:
    """Centre-form offset targets (encodeBBoxWithVar)."""
    pcx, pcy, pw, ph = _to_center(priors)
    gcx, gcy, gw, gh = _to_center(gt)
    pw = torch.clamp_min(pw, 1e-12)
    ph = torch.clamp_min(ph, 1e-12)
    tx = (gcx - pcx) / pw / variances[..., 0]
    ty = (gcy - pcy) / ph / variances[..., 1]
    tw = torch.log(torch.clamp_min(gw / pw, 1e-12)) / variances[..., 2]
    th = torch.log(torch.clamp_min(gh / ph, 1e-12)) / variances[..., 3]
    return torch.stack([tx, ty, tw, th], dim=-1)


def decode_boxes(priors: torch.Tensor, variances: torch.Tensor,
                 loc: torch.Tensor) -> torch.Tensor:
    """Inverse of `encode_boxes` (decodeBBoxWithVar)."""
    pcx, pcy, pw, ph = _to_center(priors)
    cx = loc[..., 0] * variances[..., 0] * pw + pcx
    cy = loc[..., 1] * variances[..., 1] * ph + pcy
    w = torch.exp(loc[..., 2] * variances[..., 2]) * pw
    h = torch.exp(loc[..., 3] * variances[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                 overlap_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD matching, batched: priors [P, 4], gt_boxes [B, G, 4], gt_valid
    [B, G] bool -> (match [B, P] int64, the gt index or -1; match_iou [B, P]).
    Threshold stage: a prior takes its best valid gt when the IoU passes
    the threshold. Bipartite stage (generateMatchIndices): G rounds, each
    locking in the globally best still-free (prior, gt) pair of each image,
    so every valid gt ends with a prior of its own."""
    b, g = gt_boxes.shape[0], gt_boxes.shape[1]
    p = priors.shape[0]
    iou = iou_matrix(priors.expand(b, p, 4), gt_boxes)  # [B, P, G]
    valid = gt_valid[:, None, :]
    iou = torch.where(valid, iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=2)  # the first maximum, as jnp.argmax
    passed = best_iou > overlap_threshold
    match = torch.where(passed, best_gt, torch.full_like(best_gt, -1))
    match_iou = torch.where(passed, best_iou, torch.zeros_like(best_iou))
    work = torch.where(valid, iou, torch.full_like(iou, -math.inf))
    rows = torch.arange(p, device=priors.device)[None, :]
    cols = torch.arange(g, device=priors.device)[None, :]
    for _ in range(g):
        best, flat = work.reshape(b, -1).max(dim=1)
        p_star, g_star = flat // g, flat % g
        ok = (best >= 0.0)[:, None]
        hit = ok & (rows == p_star[:, None])  # [B, P]
        match = torch.where(hit, g_star[:, None], match)
        match_iou = torch.where(hit, best[:, None], match_iou)
        gone = ok[:, :, None] & (hit[:, :, None] | (cols == g_star[:, None])[:, None, :])
        work = torch.where(gone, torch.full_like(work, -math.inf), work)
    return match, match_iou


def multibox_loss(
    loc_preds: torch.Tensor,
    conf_preds: torch.Tensor,
    priors: torch.Tensor,
    variances: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    overlap_threshold: float = 0.5,
    neg_pos_ratio: float = 3.0,
    background_id: int = 0,
) -> torch.Tensor:
    """Batched SSD loss -> per-example cost [B]. loc_preds [B, P, 4],
    conf_preds [B, P, C] logits, priors / variances [P, 4], gt_boxes
    [B, G, 4], gt_labels [B, G] class ids, gt_valid [B, G] bool. Positives
    get smooth-L1 on the encoded offsets and softmax CE on their class;
    negatives are mined by background CE at `neg_pos_ratio` x the positive
    count (one stable sort per example); the sum over both, over the
    positive count (at least 1)."""
    p = priors.shape[0]
    match, _ = match_priors(priors, gt_boxes, gt_valid, overlap_threshold)
    pos = match >= 0
    n_pos = pos.sum(dim=1)
    safe = torch.clamp_min(match, 0)
    matched_gt = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    loc_target = encode_boxes(priors, variances, matched_gt)
    diff = loc_preds - loc_target
    adiff = diff.abs()
    smooth_l1 = torch.where(adiff < 1.0, 0.5 * diff * diff, adiff - 0.5)
    zero = torch.zeros((), dtype=smooth_l1.dtype, device=smooth_l1.device)
    loc_loss = torch.where(pos[..., None], smooth_l1, zero).sum(dim=(1, 2))

    labels = torch.gather(gt_labels.long(), 1, safe)
    cls_target = torch.where(pos, labels, torch.full_like(labels, background_id))
    logp = torch.log_softmax(conf_preds, dim=-1)
    ce = -torch.gather(logp, 2, cls_target[..., None])[..., 0]  # [B, P]

    neg_score = torch.where(pos, torch.full_like(ce, -math.inf),
                            -logp[..., background_id]).detach()
    order = torch.argsort(-neg_score, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(p, device=order.device).expand_as(order))
    n_neg = torch.minimum((neg_pos_ratio * n_pos.float()).to(torch.int64), p - n_pos)
    neg = ~pos & (rank < n_neg[:, None])
    conf_loss = torch.where(pos | neg, ce, zero).sum(dim=1)
    denom = torch.clamp_min(n_pos, 1).to(loc_loss.dtype)
    return (loc_loss + conf_loss) / denom


def _sorted_desc(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` along the last axis: the k largest, the lower index first
    among ties."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.45,
        top_k: int = 100, score_threshold: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over the last axis, batched over any leading axes: boxes
    [..., N, 4], scores [..., N] -> (keep [..., K] bool over the score-sorted
    prefix of K = min(top_k, N), idx [..., K] into the input). One loop of K
    steps: step i drops every later box that overlaps box i, if box i is
    still kept."""
    k = min(top_k, scores.shape[-1])
    top_scores, idx = _sorted_desc(scores, k)
    top_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    iou = iou_matrix(top_boxes, top_boxes)  # [..., K, K]
    keep = top_scores > score_threshold
    later = torch.triu(torch.ones(k, k, dtype=torch.bool, device=scores.device), 1)
    overlaps = (iou > iou_threshold) & later
    for i in range(k):
        keep = keep & ~(keep[..., i, None] & overlaps[..., i, :])
    return keep, idx


def detection_output(
    loc_preds: torch.Tensor,
    conf_preds: torch.Tensor,
    priors: torch.Tensor,
    variances: torch.Tensor,
    num_classes: int,
    background_id: int = 0,
    nms_threshold: float = 0.45,
    nms_top_k: int = 400,
    keep_top_k: int = 200,
    confidence_threshold: float = 0.01,
) -> torch.Tensor:
    """[B, P, 4] locs + [B, P, C] logits -> [B, keep_top_k, 6] detections
    (label, score, xmin, ymin, xmax, ymax); rows of score 0 are padding.
    Per-class NMS over every (image, class) at once, then the global
    keep_top_k per image, as DetectionOutputLayer does."""
    b, p = loc_preds.shape[0], priors.shape[0]
    probs = torch.softmax(conf_preds, dim=-1)
    decoded = decode_boxes(priors, variances, loc_preds)  # [B, P, 4]
    # the classes but the background, ascending, built on the device (no
    # host copy, so a captured graph may hold this too)
    n_cls = num_classes - 1 if 0 <= background_id < num_classes else num_classes
    cls = torch.arange(n_cls, device=probs.device)
    if n_cls < num_classes:
        cls = cls + (cls >= background_id).to(cls.dtype)
    scores = probs.index_select(2, cls).transpose(1, 2)  # [B, C', P]
    boxes = decoded[:, None].expand(b, n_cls, p, 4)
    keep, idx = nms(boxes, scores, nms_threshold, min(nms_top_k, p), confidence_threshold)
    k = idx.shape[-1]
    top = torch.gather(scores, 2, idx)
    sc = torch.where(keep, top, torch.zeros_like(top)).reshape(b, n_cls * k)
    kept_boxes = torch.gather(decoded, 1, idx.reshape(b, n_cls * k, 1).expand(-1, -1, 4))
    labels = cls.to(torch.float32)[:, None].expand(n_cls, k).reshape(1, n_cls * k)
    labels = labels.expand(b, -1)
    kk = min(keep_top_k, n_cls * k)
    top_s, ti = _sorted_desc(sc, kk)
    out = torch.cat([torch.gather(labels, 1, ti)[..., None].to(top_s.dtype),
                     top_s[..., None],
                     torch.gather(kept_boxes, 1, ti[..., None].expand(-1, -1, 4))], dim=-1)
    if kk < keep_top_k:
        out = torch.nn.functional.pad(out, (0, 0, 0, keep_top_k - kk))
    return out
