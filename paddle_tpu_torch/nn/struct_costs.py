"""Structured-prediction costs (counterpart of `paddle_tpu/nn/struct_costs.py`):
`CTCCost`, `CRFCost` and `CRFDecoding` over `ops/ctc.py` and `ops/crf.py`;
`NCECost` (noise-contrastive estimation), `HierarchicalSigmoid`,
`LambdaCost` (LambdaRank) and `CrossEntropyOverBeam` with its `BeamInput`.

Each cost is the mean of its per-example vector over the batch, as the JAX
package's `_mean_over_examples` computes it: a padded batch's rows weigh
their sample mask and the denominator is the global real row count; under
a mesh the batch is this rank's rows and the denominator the global
batch's.

NCE draws its noise classes from `ctx.next_rng(name)` with
`core/prng.randint` / `prng.categorical`, jax's threefry bits, so the port
samples the classes the JAX package samples for the same key. Rankings
(LambdaCost's) sort stably, keeping the lower index first among equal
scores, as `jnp.argsort` does."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.nn import init as init_mod
from paddle_tpu_torch.nn.graph import Argument, Context, Layer, batch_rows
from paddle_tpu_torch.nn.layers import _attr
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import ctc as ctc_ops


def _mean_over_examples(ctx: Context, per_sample: torch.Tensor) -> torch.Tensor:
    """Mean over a per-example cost vector honouring `ctx.sample_mask`
    (`paddle_tpu/nn/struct_costs.py` `_mean_over_examples`): a vector that
    flattens [B] rows per timestep repeats the mask per step; a layout that
    does not divide the mask keeps the unmasked mean, with the reference's
    warning. Unmasked on one rank it is the plain mean, bit for bit."""
    smask = getattr(ctx, "sample_mask", None)
    world = getattr(ctx, "world", 1)
    if smask is None:
        if world == 1:
            return per_sample.mean()
        return per_sample.sum() / (per_sample.shape[0] * world)
    n, b = per_sample.shape[0], smask.shape[0]
    if not b or n % b != 0:
        import logging

        logging.getLogger("paddle_tpu_torch.costs").warning(
            "struct cost cannot apply the pad-row mask: per-sample vector of %d rows "
            "does not divide the [%d] sample mask — the padded rows join this batch's "
            "mean unmasked (duplicates of the last real row). Size batches divisibly "
            "by the mesh data axis to avoid the bias.", n, b)
        return per_sample.mean()
    reps = n // b
    w = smask.to(per_sample.dtype)
    if reps > 1:
        w = w.repeat_interleave(reps)
    count = getattr(ctx, "sample_count", None)
    count = count if count is not None else smask.float().sum()
    return (per_sample * w).sum() / torch.clamp(count * reps, min=1.0)


class CTCCost(Layer):
    """CTC negative log-likelihood. Inputs (logits [B, T, C], labels
    [B, L]), both sequences with lengths; labels are fed as
    `Data(shape=(), is_seq=True)`. `size` (the alphabet with the blank) is
    the config surface's value and not read."""

    type_name = "ctc"
    is_cost = True

    def __init__(self, input: Layer, label: Layer, blank: int = 0,
                 norm_by_times: bool = False, size: Optional[int] = None,
                 name: Optional[str] = None, coeff: float = 1.0):
        super().__init__([input, label], name=name)
        self.blank = blank
        self.norm_by_times = norm_by_times
        self.size = size
        self.coeff = coeff

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        logits, labels = ins
        if not (logits.is_seq and labels.is_seq):
            raise ValueError(f"{self.name}: ctc needs sequence inputs")
        nll = ctc_ops.ctc_loss(logits.value, logits.lengths, labels.value,
                               labels.lengths, blank=self.blank,
                               norm_by_times=self.norm_by_times)
        return Argument(self.coeff * _mean_over_examples(ctx, nll))


class CRFCost(Layer):
    """Linear-chain CRF negative log-likelihood over the packed (C+2, C)
    weight `w` (row 0 start, row 1 end, rows 2.. transitions)."""

    type_name = "crf"
    is_cost = True

    def __init__(self, input: Layer, label: Layer, size: Optional[int] = None,
                 param_attr: Any = None, name: Optional[str] = None, coeff: float = 1.0):
        super().__init__([input, label], name=name)
        self.size = size
        self.param_attr = _attr(param_attr)
        self.coeff = coeff

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        emit, labels = ins
        if not emit.is_seq:
            raise ValueError(f"{self.name}: crf needs a sequence input")
        c = self.size or emit.value.shape[-1]
        w = ctx.param(self, "w", (c + 2, c), init_mod.smart_normal, self.param_attr)
        nll = crf_ops.crf_nll(emit.value, emit.lengths, labels.value, w)
        return Argument(self.coeff * _mean_over_examples(ctx, nll))


class CRFDecoding(Layer):
    """Viterbi decode over the CRF weight (shared by `param_attr` name):
    the best tags [B, T], or with a label input the per-step error
    indicators (1.0 where the decoded tag is not the gold one)."""

    type_name = "crf_decoding"

    def __init__(self, input: Layer, size: Optional[int] = None,
                 label: Optional[Layer] = None, param_attr: Any = None,
                 name: Optional[str] = None):
        super().__init__([input] + ([label] if label is not None else []), name=name)
        self.size = size
        self.param_attr = _attr(param_attr)
        self.has_label = label is not None

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        emit = ins[0]
        c = self.size or emit.value.shape[-1]
        w = ctx.param(self, "w", (c + 2, c), init_mod.smart_normal, self.param_attr)
        tags = crf_ops.crf_decode(emit.value, emit.lengths, w)
        if self.has_label:
            err = (tags != ins[1].value.to(tags.dtype)).float()
            return Argument(err, emit.lengths)
        return Argument(tags, emit.lengths)


def _bce_logits(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Stable sigmoid cross entropy of logits s against 0/1 targets y."""
    return torch.clamp_min(s, 0.0) - s * y + torch.log1p(torch.exp(-s.abs()))


class NCECost(Layer):
    """Noise-contrastive estimation (NCELayer.cpp). In training, draws
    `num_neg_samples` noise classes an example (uniform, or by
    `neg_distribution`: the reference's MultinomialSampler), scores the
    label and the noise against the [num_classes, D] weight `w` (and bias
    `b`), and applies the logistic loss with the log(k q) correction. In
    eval mode, the full softmax cross entropy (the reference's test path).
    A sequence input flattens per step; an optional third input weights
    each example's cost."""

    type_name = "nce"
    is_cost = True

    def __init__(self, input: Layer, label: Layer, num_classes: int,
                 num_neg_samples: int = 10, neg_distribution: Optional[Any] = None,
                 bias: bool = True, param_attr: Any = None, weight: Optional[Layer] = None,
                 name: Optional[str] = None):
        super().__init__([input, label] + ([weight] if weight is not None else []), name=name)
        self.has_weight = weight is not None
        self.num_classes = num_classes
        self.num_neg_samples = num_neg_samples
        self.neg_distribution = (None if neg_distribution is None
                                 else np.asarray(neg_distribution, np.float32))
        self.bias = bias
        self.param_attr = _attr(param_attr)
        self._dist: Dict[torch.device, torch.Tensor] = {}

    def _noise(self, device: torch.device) -> torch.Tensor:
        """The noise distribution on `device`, moved there once (a graph
        captured later holds this tensor, with no host copy)."""
        d = self._dist.get(device)
        if d is None:
            d = self._dist[device] = torch.from_numpy(self.neg_distribution).to(device)
        return d

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        x = ins[0].value
        if x.dim() > 2:  # a sequence input: one example a step
            x = x.reshape(-1, x.shape[-1])
        label = ins[1].value.reshape(-1).long()
        bsz, d = x.shape
        w = ctx.param(self, "w", (self.num_classes, d), init_mod.smart_normal,
                      self.param_attr)
        b = ctx.param(self, "b", (self.num_classes,), init_mod.zeros) if self.bias else None
        sample_w = ins[2].value.reshape(-1) if self.has_weight else None

        def reduce(per_sample):
            if sample_w is not None:
                per_sample = per_sample * sample_w
            return _mean_over_examples(ctx, per_sample)

        if not ctx.train:
            logits = x @ w.t() + (b if b is not None else 0.0)
            nll = -torch.gather(torch.log_softmax(logits, dim=-1), 1, label[:, None])[:, 0]
            return Argument(reduce(nll))

        k = self.num_neg_samples
        key = ctx.next_rng(self.name)
        if self.neg_distribution is None:
            samples = batch_rows(
                ctx, lambda shape: prng.randint(key, shape, 0, self.num_classes), (bsz, k))
            logq_pos = logq_neg = torch.full((), -math.log(self.num_classes),
                                             dtype=x.dtype, device=x.device)
        else:
            noise = self._noise(x.device)
            dist = noise / noise.sum()
            samples = batch_rows(
                ctx, lambda shape: prng.categorical(key, torch.log(dist), shape), (bsz, k))
            logq_pos = torch.log(dist[label])
            logq_neg = torch.log(dist[samples])
        ids = torch.cat([label[:, None], samples], dim=1)  # [B, 1+k]
        s = torch.einsum("bd,bkd->bk", x, w[ids])
        if b is not None:
            s = s + b[ids]
        logq = torch.cat([logq_pos.expand(bsz)[:, None], logq_neg.expand(bsz, k)], dim=1)
        s = s - (math.log(k) + logq)
        y = torch.cat([torch.ones_like(s[:, :1]), torch.zeros_like(s[:, 1:])], dim=1)
        return Argument(reduce(_bce_logits(s, y).sum(dim=1)))


class HierarchicalSigmoid(Layer):
    """Hierarchical sigmoid over an implicit complete binary tree
    (HierarchicalSigmoidLayer.cpp + MatrixBitCode.cpp): the leaf of class c
    is node c + num_classes, internal node j (1-based heap order) owns row
    j-1 of the [num_classes-1, D] weight `w` (and of the bias `b`); the
    cost is the sum of the binary cross entropies along the root-to-leaf
    path, one gathered pass of static depth. Several feature inputs are
    concatenated (one wide weight is the reference's sum of per-input
    projections)."""

    type_name = "hsigmoid"
    is_cost = True

    def __init__(self, input: Any, label: Layer, num_classes: int, bias: bool = True,
                 param_attr: Any = None, name: Optional[str] = None):
        feats = list(input) if isinstance(input, (list, tuple)) else [input]
        super().__init__(feats + [label], name=name)
        self.n_feats = len(feats)
        self.num_classes = num_classes
        self.bias = bias
        self.param_attr = _attr(param_attr)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        n = self.n_feats
        x = torch.cat([a.value for a in ins[:n]], dim=-1)
        label = ins[n].value.reshape(-1).long()
        c = self.num_classes
        w = ctx.param(self, "w", (c - 1, x.shape[1]), init_mod.smart_normal,
                      self.param_attr)
        b = ctx.param(self, "b", (c - 1,), init_mod.zeros) if self.bias else None
        depth = int(math.ceil(math.log2(max(2, c)))) + 1
        leaf = label + c  # [B], in [C, 2C)
        ds = torch.arange(1, depth + 1, device=x.device)  # levels up from the leaf
        parents = leaf[:, None] >> ds[None, :]  # [B, depth]
        bits = (leaf[:, None] >> (ds[None, :] - 1)) & 1
        rows = torch.clamp(parents - 1, 0, c - 2)
        s = torch.einsum("bd,bkd->bk", x, w[rows])
        if b is not None:
            s = s + b[rows]
        loss = _bce_logits(s, bits.to(s.dtype))
        loss = torch.where(parents >= 1, loss, torch.zeros_like(loss))
        return Argument(_mean_over_examples(ctx, loss.sum(dim=1)))


class LambdaCost(Layer):
    """LambdaRank's listwise cost (CostLayer.cpp LambdaCost): over each
    query's sequence of documents, the pairwise logistic losses weighted by
    |delta NDCG| of swapping the pair, the discounts truncated at
    `ndcg_num`. Inputs: the scores and the relevance labels, both
    sequences ([B, T] or [B, T, 1]; a wider score input is read by its
    first column, as the reference reads one score a document)."""

    type_name = "lambda_cost"
    is_cost = True

    def __init__(self, input: Layer, score: Layer, ndcg_num: int = 5,
                 name: Optional[str] = None, coeff: float = 1.0):
        super().__init__([input, score], name=name)
        self.ndcg_num = ndcg_num
        self.coeff = coeff

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        pred, rel = ins
        if not pred.is_seq:
            raise ValueError(f"{self.name}: lambda_cost needs sequence inputs")
        pv = pred.value
        if pv.dim() == 3 and pv.shape[-1] != 1:
            pv = pv[..., :1]
        s = pv.reshape(pv.shape[0], pv.shape[1])
        g = rel.value.reshape(s.shape).float()
        mask = pred.mask(s.dtype)
        t = s.shape[1]
        valid = mask > 0
        inf = torch.full_like(g, math.inf)

        k = min(self.ndcg_num, t)
        top_g = torch.topk(torch.where(valid, g, -inf), k, dim=1).values
        top_g = torch.where(torch.isfinite(top_g), top_g, torch.zeros_like(top_g))
        disc = 1.0 / torch.log2(torch.arange(2, k + 2, device=s.device, dtype=torch.float32))
        idcg = torch.clamp_min(((torch.exp2(top_g) - 1.0) * disc[None, :]).sum(dim=1), 1e-6)

        # 1-based rank of each document by its current score
        order = torch.argsort(torch.where(valid, -s.detach(), inf), dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(
            1, order, torch.arange(t, device=s.device).expand_as(order)) + 1
        gain = torch.exp2(g) - 1.0
        dfac = torch.where(ranks <= self.ndcg_num, 1.0 / torch.log2(1.0 + ranks.float()),
                           torch.zeros_like(gain))
        dndcg = ((gain[:, :, None] - gain[:, None, :]) * (dfac[:, :, None] - dfac[:, None, :])
                 ).abs() / idcg[:, None, None]
        diff = s[:, :, None] - s[:, None, :]
        pair_loss = torch.log1p(torch.exp(-diff.abs())) + torch.clamp_min(-diff, 0.0)
        rel_gt = (g[:, :, None] > g[:, None, :]).to(s.dtype)
        pmask = mask[:, :, None] * mask[:, None, :]
        loss = (dndcg * pair_loss * rel_gt * pmask).sum(dim=(1, 2))
        return Argument(self.coeff * _mean_over_examples(ctx, loss))


class BeamInput:
    """One beam expansion of CrossEntropyOverBeam: the trainer_config_helpers
    triple (candidate_scores, selected_candidates, gold) (layers.py:6038)."""

    def __init__(self, candidate_scores: Layer, selected_candidates: Layer, gold: Layer):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


class CrossEntropyOverBeam(Layer):
    """Globally normalised cross entropy over beam expansions
    (CrossEntropyOverBeam.cpp, learning to search). Dense encoding, as the
    JAX package's: expansion t has candidate_scores [B, N_t] (flattened over
    its subsequences), selected_candidates [B, K_t] flat indices into N_t
    (-1 pads) and gold [B] a flat index into N_t; subsequence s of
    expansion t+1 descends from selected candidate s of expansion t. Path
    scores add up along the selections; the cost is -log softmax over the
    beam's paths at the expansion where gold falls off the beam (or the
    last), the gold path appended when it is not among them."""

    type_name = "cross_entropy_over_beam"
    is_cost = True

    def __init__(self, input: List[BeamInput], name: Optional[str] = None):
        self.beams = list(input)
        srcs: List[Layer] = []
        for b in self.beams:
            srcs += [b.candidate_scores, b.selected_candidates, b.gold]
        super().__init__(srcs, name=name)

    def forward(self, ctx: Context, ins: List[Argument]) -> Argument:
        n_beams = len(self.beams)

        def flat_scores(v):
            if v.dim() > 2 and v.shape[-1] == 1:
                v = v[..., 0]
            return v.reshape(v.shape[0], -1)

        scores = [flat_scores(ins[3 * i].value).float() for i in range(n_beams)]
        selected = [ins[3 * i + 1].value.long() for i in range(n_beams)]
        gold = [ins[3 * i + 2].value.reshape(-1).long() for i in range(n_beams)]
        bsz = scores[0].shape[0]
        dev = scores[0].device
        neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
        costs = []
        gold_prefix = torch.zeros(bsz, dtype=torch.float32, device=dev)
        sel_prefix = None  # [B, K_prev]: the selected paths' scores so far
        gold_in = torch.ones(bsz, dtype=torch.bool, device=dev)
        first_off = torch.full((bsz,), n_beams - 1, dtype=torch.int64, device=dev)
        for t in range(n_beams):
            sc = scores[t]
            n = sc.shape[1]
            k_prev = 1 if sel_prefix is None else sel_prefix.shape[1]
            parent = torch.arange(n, device=dev) // (n // k_prev)
            base = torch.zeros_like(sc) if sel_prefix is None else sel_prefix[:, parent]
            path_scores = base + sc
            sel = selected[t]
            valid = sel >= 0
            sel_scores = torch.where(valid, torch.gather(path_scores, 1, sel.clamp_min(0)), neg)
            g = gold[t]
            gold_score = gold_prefix + torch.gather(sc, 1, g[:, None])[:, 0]
            hit = (valid & (sel == g[:, None])).any(dim=1)
            extra = torch.where(hit, neg, gold_score)
            logits = torch.cat([sel_scores, extra[:, None]], dim=1)
            costs.append(torch.logsumexp(logits, dim=1) - gold_score)
            fell_now = gold_in & ~hit
            first_off = torch.where(fell_now, torch.full_like(first_off, t), first_off)
            gold_in = gold_in & hit
            gold_prefix = gold_score
            sel_prefix = sel_scores
        cost_mat = torch.stack(costs, dim=1)
        per_sample = torch.gather(cost_mat, 1, first_off[:, None])[:, 0]
        return Argument(_mean_over_examples(ctx, per_sample))
