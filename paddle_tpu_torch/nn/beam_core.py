"""The beam-search engine (counterpart of `paddle_tpu/nn/beam_core.py`;
RecurrentGradientMachine.h:309 beamSearch).

`expand_beams` is the one top-k + finished-beam EOS-masking step;
`beam_search_scan` runs it for `max_len` steps as a plain loop (the JAX
package's `lax.scan`), then orders the beams best first. The carry is a
tensor or a dict / list / tuple of them (the JAX engine's pytree); every
leaf follows the chosen beams. The loop reads nothing back to the host.

Ties decide ids: `lax.top_k` puts the lower index first among equal values,
and a finished beam offers a whole row of equal `score - 1e9` candidates.
`torch.topk` promises no order among ties, so the top k here come from a
stable descending sort of the flat [K*V] candidates (equal values keep the
lower flat index first), and the final ordering is a stable argsort, as
`jnp.argsort` is."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e9


class BeamResult(NamedTuple):
    history: torch.Tensor  # [B, K, L] token ids, beams sorted best-first
    scores: torch.Tensor   # [B, K] cumulative log-probs (penalized if requested)
    lengths: torch.Tensor  # [B, K] lengths up to and including EOS


def expand_beams(cand_logp: torch.Tensor, pre_scores: torch.Tensor,
                 finished: torch.Tensor, eos_id: int, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam expansion. cand_logp [B, K, V] are the TOTAL candidate
    scores of the live beams, pre_scores [B, K] the incoming beams' scores,
    finished [B, K] bool. Finished beams propagate EOS at their unchanged
    score. -> (top_scores [B, k], beam_idx [B, k], tok [B, k] int32)."""
    b, _, v = cand_logp.shape
    # built on the device (an indexed write of a Python number would copy
    # from the host, which a CUDA graph capture refuses)
    vocab = torch.arange(v, device=cand_logp.device)
    eos_only = torch.where(vocab == eos_id, 0.0, NEG_INF).to(cand_logp.dtype)
    cand = torch.where(finished[:, :, None], pre_scores[:, :, None] + eos_only,
                       cand_logp)
    top_scores, top_idx = torch.sort(cand.reshape(b, -1), dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    return top_scores, top_idx // v, (top_idx % v).to(torch.int32)


def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """`jax.tree.map` over a tensor or a dict / list / tuple of them."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree: Any) -> Optional[torch.Tensor]:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return next((leaf for leaf in map(_first_leaf, tree) if leaf is not None), None)
    return tree


def _gather_beams(tree: Any, idx: torch.Tensor, batch: int, k: int) -> Any:
    """Select beams: every leaf [B*K, ...] (or [B, K, ...]) reindexed by
    idx [B, K']."""
    rows = torch.arange(batch, device=idx.device)[:, None]

    def one(x: torch.Tensor) -> torch.Tensor:
        flat = x.shape[0] == batch * k
        xb = x.reshape((batch, k) + tuple(x.shape[1:])) if flat else x
        sel = xb[rows, idx]
        return sel.reshape((batch * idx.shape[1],) + tuple(x.shape[1:])) if flat else sel

    return _tree_map(one, tree)


def beam_search_scan(step_fn: Callable[[torch.Tensor, Any, int], Tuple[torch.Tensor, Any]],
                     carry0: Any, batch: int, vocab: int, bos_id: int,
                     eos_id: int, beam_size: int, max_len: int,
                     length_penalty: float = 0.0,
                     device: Optional[torch.device] = None) -> BeamResult:
    """Beam search for `max_len` steps.

    step_fn(tokens [B*K] int32, carry, t) -> (logp [B*K, V] f32 log-probs,
    new carry); the carry's leaves are [B*K, ...] tensors (already tiled
    across beams). Beam 0 is the only live beam at t=0, so the first
    expansion is not K duplicates. Finished beams emit EOS with zero score
    delta. `device` defaults to the carry's (the first leaf's)."""
    k = beam_size
    dev = device if device is not None else _first_leaf(carry0).device
    tokens = torch.full((batch, k), bos_id, dtype=torch.int32, device=dev)
    scores = torch.tensor([0.0] + [NEG_INF] * (k - 1), dtype=torch.float32,
                          device=dev).repeat(batch, 1)
    finished = torch.zeros((batch, k), dtype=torch.bool, device=dev)
    history = torch.zeros((batch, k, max_len), dtype=torch.int32, device=dev)
    carry = carry0
    rows = torch.arange(batch, device=dev)[:, None]
    for t in range(max_len):
        logp, new_carry = step_fn(tokens.reshape(-1), carry, t)
        logp = logp.reshape(batch, k, vocab).float()
        top_scores, beam_idx, tok_idx = expand_beams(scores[:, :, None] + logp, scores,
                                                     finished, eos_id, k)
        carry = _gather_beams(new_carry, beam_idx, batch, k)
        history = history[rows, beam_idx]
        history[:, :, t] = tok_idx
        finished = finished[rows, beam_idx] | (tok_idx == eos_id)
        tokens, scores = tok_idx, top_scores

    is_eos = history == eos_id
    any_eos = is_eos.any(dim=-1)
    first_eos = is_eos.int().argmax(dim=-1)
    lengths = torch.where(any_eos, first_eos + 1, max_len).to(torch.int32)
    if length_penalty > 0:
        scores = scores / lengths.float().pow(length_penalty)
    order = torch.argsort(-scores, dim=-1, stable=True)
    return BeamResult(history=history[rows, order],
                      scores=torch.gather(scores, -1, order),
                      lengths=torch.gather(lengths, -1, order))
