"""Plain PyTorch reference of the `nmt` configuration's training step, and
the arithmetic the benchmark counts it by.

Independent of the program: plain `torch` operations, written from
RNNsearch (Bahdanau et al. 2014) as Paddle's seqToseq demo builds it.
Source embedding -> a bidirectional GRU encoder (each direction an input
projection to 3H, then a GRU whose padded steps carry h; the reverse one
walks from the last position) -> the attention decoder: h0 = tanh(enc[:, 0]
W_init); at target step t, additive attention of the previous h over the
encoder (v . tanh(enc W_enc + h W_dec), softmax over the source's valid
steps), then a GRU step on [emb_t, context] (padded target steps carry h)
-> the vocabulary projection -> softmax cross-entropy summed over the
valid target steps and divided by the batch's rows -> Adam with the bias
corrections 1 - beta^t.

GRU step (Paddle's gru: the reset gate applies to h before the recurrent
product): z, r = sigmoid(x_zr + h W_zr), c = tanh(x_c + (r * h) W_c),
h' = (1 - z) h + z c, the gate bias added to the input projection.

Precision as the configuration states it: f32 with TF32 off. The control
(`tf32`) runs the same with TF32 on for every matmul."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

Shapes = Dict[str, Tuple[Tuple[int, ...], str]]
NEG = -1e9


def param_shapes(cfg: Mapping[str, Any]) -> Shapes:
    """name -> (shape, init): weights `smart` (N(0, 1 / sqrt(fan_in))),
    biases `zeros`."""
    e, h, a = cfg["embed_dim"], cfg["hidden_dim"], cfg["attention_dim"]
    d = 2 * h
    out: Shapes = {"src_emb.w": ((cfg["src_vocab"], e), "smart")}
    for side in ("fw", "bw"):
        out[f"enc.{side}.input_proj.w"] = ((e, 3 * h), "smart")
        out[f"enc.{side}.input_proj.b"] = ((3 * h,), "zeros")
        out[f"enc.{side}.w_hzr"] = ((h, 2 * h), "smart")
        out[f"enc.{side}.w_hc"] = ((h, h), "smart")
        out[f"enc.{side}.b"] = ((3 * h,), "zeros")
    out.update({
        "trg_emb_table": ((cfg["trg_vocab"], e), "smart"),
        "decoder.att.w_enc": ((d, a), "smart"),
        "decoder.att.w_dec": ((h, a), "smart"),
        "decoder.att.v": ((a,), "smart"),
        "decoder.w_in": ((e + d, 3 * h), "smart"),
        "decoder.gru.w_hzr": ((h, 2 * h), "smart"),
        "decoder.gru.w_hc": ((h, h), "smart"),
        "decoder.gru.b": ((3 * h,), "zeros"),
        "decoder.w_init": ((d, h), "smart"),
        "out_w": ((h, cfg["trg_vocab"]), "smart"),
        "out_b": ((cfg["trg_vocab"],), "zeros"),
    })
    return out


def initial_states(cfg: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    return {}


def make_params(cfg: Mapping[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from `seed`: one normal draw on `device`, cut and
    scaled leaf by leaf."""
    shapes = param_shapes(cfg)
    rand = [(n, s) for n, (s, k) in shapes.items() if k == "smart"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(math.prod(s) for _, s in rand), generator=g, device=device)
    out, at = {}, 0
    for name, shape in rand:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] / math.sqrt(shape[0])).reshape(shape)
        at += n
    for name, (shape, kind) in shapes.items():
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name in shapes}


# -- arithmetic -----------------------------------------------------------------

def row_flops(cfg: Mapping[str, Any], s: int, t: int) -> float:
    """Multiply-adds x 2 of one pair's forward at source length s and
    target length t (its real lengths): the encoder's projections and
    recurrences, the decoder's attention, GRU and initial state, and the
    vocabulary projection."""
    e, h, a, v = cfg["embed_dim"], cfg["hidden_dim"], cfg["attention_dim"], cfg["trg_vocab"]
    d = 2 * h
    enc = 2 * s * (e * 3 * h + h * 3 * h)
    att = s * d * a + t * (h * a + s * a + s * d)
    dec = d * h + t * ((e + d) * 3 * h + h * 3 * h)
    out = t * h * v
    return 2.0 * (enc + att + dec + out)


def step_flops(cfg: Mapping[str, Any], batch: Mapping[str, Any]) -> float:
    """Forward and backward (3 x the forward) of one step, over every
    row's real lengths."""
    return 3.0 * sum(row_flops(cfg, int(s), int(t)) for s, t in
                     zip(batch["source_ids.lengths"], batch["target_ids.lengths"]))


def work(cfg: Mapping[str, Any], batch: Mapping[str, Any]) -> int:
    """Real (unpadded) target tokens a step on `batch` trains on."""
    return int(np.sum(batch["target_ids.lengths"]))


def gru_bound_s(lens, t: int, b: int, h: int, peaks: Mapping[str, float]) -> Dict[str, float]:
    """The least time of one GRU direction's forward and backward kernels
    over a [T, B] batch of lengths `lens` (f32): each the larger of its
    bytes at the card's memory rate and its operations at the f32 peak.
    Operations are the function's over the valid steps alone, whatever
    walk a kernel takes: forward h W_zr and (r h) W_c, 2 x steps x H x 3H;
    backward (walk and dW) the W^T products and dW, twice that. Bytes are
    the padded tensors the function reads and writes, each once: forward
    proj, mask, the weights, bias and h0 in, hs and the gates out;
    backward the gates, hs, h0, mask, the weights and the cotangents in,
    dproj, dW, db and dh0 out."""
    f, bw, ops = 4, peaks["hbm_bytes_per_s"], peaks["f32"]
    fwd_bytes = f * (t * b * 3 * h + t * b + 3 * h * h + 3 * h + b * h
                     + t * b * h + t * b * 3 * h)
    mm = 2 * int(sum(int(n) for n in lens)) * h * 3 * h
    bwd_bytes = f * (t * b * 3 * h + t * b * h + b * h + t * b + 3 * h * h
                     + t * b * h + b * h + t * b * 3 * h + 3 * h * h + 3 * h + b * h)
    return {"fwd": max(fwd_bytes / bw, mm / ops),
            "bwd": max(bwd_bytes / bw, 2 * mm / ops)}


# -- the training step -----------------------------------------------------------

def _gru_step(x, h, w_hzr, w_hc, b):
    hd = h.shape[-1]
    x = x + b
    rz = h @ w_hzr
    z = torch.sigmoid(x[:, :hd] + rz[:, :hd])
    r = torch.sigmoid(x[:, hd:2 * hd] + rz[:, hd:])
    c = torch.tanh(x[:, 2 * hd:] + (r * h) @ w_hc)
    return (1 - z) * h + z * c


def _gru(x, mask, w_hzr, w_hc, b, reverse):
    bsz, t_len, _ = x.shape
    h = x.new_zeros(bsz, w_hc.shape[0])
    hs = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        m = mask[:, t, None]
        h = m * _gru_step(x[:, t], h, w_hzr, w_hc, b) + (1 - m) * h
        hs[t] = h
    return torch.stack(hs, dim=1)


def loss_fn(cfg: Mapping[str, Any], p: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    src, trg, lab = batch["source_ids"].long(), batch["target_ids"].long(), batch["label_ids"].long()
    s_len, t_len = batch["source_ids.lengths"].long(), batch["target_ids.lengths"].long()
    bsz, ts = src.shape
    tt = trg.shape[1]
    s_mask = (torch.arange(ts, device=src.device)[None] < s_len[:, None]).float()
    t_mask = (torch.arange(tt, device=src.device)[None] < t_len[:, None]).float()
    x = p["src_emb.w"][src]
    enc = torch.cat([
        _gru(x @ p[f"enc.{d}.input_proj.w"] + p[f"enc.{d}.input_proj.b"], s_mask,
             p[f"enc.{d}.w_hzr"], p[f"enc.{d}.w_hc"], p[f"enc.{d}.b"], d == "bw")
        for d in ("fw", "bw")], dim=-1)
    e_dim = cfg["embed_dim"]
    w_in = p["decoder.w_in"]
    enc_proj = enc @ p["decoder.att.w_enc"]
    h = torch.tanh(enc[:, 0] @ p["decoder.w_init"])
    emb_proj = p["trg_emb_table"][trg] @ w_in[:e_dim]
    hs = []
    for t in range(tt):
        q = h @ p["decoder.att.w_dec"]
        scores = torch.tanh(enc_proj + q[:, None]) @ p["decoder.att.v"]
        weights = torch.softmax(torch.where(s_mask > 0, scores, NEG), dim=1) * s_mask
        context = (weights[:, :, None] * enc).sum(dim=1)
        h_new = _gru_step(emb_proj[:, t] + context @ w_in[e_dim:], h,
                          p["decoder.gru.w_hzr"], p["decoder.gru.w_hc"], p["decoder.gru.b"])
        m = t_mask[:, t, None]
        h = m * h_new + (1 - m) * h
        hs.append(h)
    logits = torch.stack(hs, dim=1) @ p["out_w"] + p["out_b"]
    xent = torch.nn.functional.cross_entropy(logits.reshape(bsz * tt, -1), lab.reshape(-1),
                                             reduction="none")
    return (xent * t_mask.reshape(-1)).sum() / bsz


def train_steps(cfg: Mapping[str, Any], params: Mapping[str, torch.Tensor],
                states: Mapping[str, torch.Tensor], batches: List[Mapping[str, Any]],
                precision: str, device) -> Dict[str, Any]:
    """len(batches) Adam steps from `params` -> {"losses", "first_grad",
    "params", "states"}. `precision`: "f32" (TF32 off, the reference) or
    "tf32" (the control)."""
    opt = cfg["optimizer"]
    lr, b1, b2, eps = opt["learning_rate"], opt["beta1"], opt["beta2"], opt["epsilon"]
    if precision not in ("f32", "tf32"):
        raise ValueError(f"nmt reference: precision {precision!r} is not f32/tf32")
    tf32 = precision == "tf32"
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        p = {k: v.detach().clone().float().to(device).requires_grad_(True)
             for k, v in params.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, first = [], None
        for step, batch in enumerate(batches, start=1):
            dev = {k: torch.as_tensor(np.asarray(x)).to(device) for k, x in batch.items()}
            loss = loss_fn(cfg, p, dev)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            t32 = torch.tensor(float(step), device=device)
            bc1 = 1.0 - torch.pow(torch.tensor(b1, device=device), t32)
            bc2 = 1.0 - torch.pow(torch.tensor(b2, device=device), t32)
            with torch.no_grad():
                g = dict(zip(p, grads))
                if first is None:
                    first = {k: x.clone() for k, x in g.items()}
                for k in p:
                    m[k].mul_(b1).add_((1 - b1) * g[k])
                    v2[k].mul_(b2).add_((1 - b2) * g[k] * g[k])
                    p[k].sub_(lr * (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps))
            del loss, grads
        return {"losses": losses, "first_grad": first,
                "params": {k: x.detach() for k, x in p.items()}, "states": {}}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
