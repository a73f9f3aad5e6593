"""Prompt-lookup speculative drafting: no second model.

The port's copy of `paddle_tpu/serving/speculation.py` (pure host Python).

The drafter is an n-gram index over ONE request's committed tokens (prompt
+ everything generated so far). To draft, it looks up the sequence's last
`n` tokens; if that n-gram occurred earlier, the K tokens that FOLLOWED the
earlier occurrence become the draft — the "prompt lookup" trick: templated
and repetitive text (code, structured prompts, self-repeating generations)
re-walks its own n-grams constantly, so the continuation after the last
match is a strong guess at the continuation now.

Correctness never depends on draft quality: the verify chunk samples the
TARGET model's token at every draft position through the request's own
(seed, emitted-token-index) key, and the host only accepts drafts that
exactly match those samples — a bad draft costs a wasted lane, never a
wrong token. That is what lets the drafter be this simple.

Determinism is load-bearing (the replay contract): a drafter's output is a
pure function of the committed token sequence — no clocks, no RNG, no
engine-step state — so a crash replay or router failover that regrows the
sequence from the prompt reproduces the exact same draft at every round.

Host-side, pure Python, O(1) dict ops per committed token; one instance per
active request (the serving session keys them by slot + request id and
drops them at retirement)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def next_draft_k(k_eff: int, k_max: int, drafted: int, accepted: int) -> int:
    """Adaptive draft length: the effective K for a
    request's NEXT verify round, given what just happened. A PURE rule —
    no clocks, no RNG, no engine state — so crash replay / router failover
    regrow the same K sequence from the same acceptance history and every
    round stays bitwise.

    Additive-increase / fall-to-observed:
      * full acceptance (every drafted token matched) -> grow by 1 toward
        `k_max` — the stream is in a predictable stretch, draft deeper;
      * partial/zero acceptance -> fall to `accepted + 1` — the draft
        diverged after `accepted` tokens, so drafting further than one past
        the observed match depth just burns verify lanes.

    The [1, K_max+1] verify program zero-pads short drafts, so the shape —
    and therefore the verify call's signature — never changes with K (it stays 1);
    only HOW MANY lanes carry real draft tokens does."""
    k_eff = max(1, min(int(k_eff), int(k_max)))
    if drafted <= 0:
        return k_eff  # no draft existed: no evidence, keep the current K
    if accepted >= drafted:
        return min(int(k_max), k_eff + 1)
    return max(1, int(accepted) + 1)


class PromptLookupDrafter:
    """Incremental n-gram index + drafts for one request.

    `feed()` consumes newly committed tokens (prompt first, then each
    emitted token, in order); `draft(k)` proposes up to `k` continuation
    tokens after the most recent earlier occurrence of the current
    `ngram`-token suffix, or [] when the suffix never occurred before
    (the caller then falls back to plain decode for that slot)."""

    def __init__(self, ngram: int = 2):
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        self.ngram = int(ngram)
        # n-gram -> (latest, previous) continuation-start indices (the
        # position right AFTER the gram). Two generations are kept because
        # the LATEST occurrence of the sequence's own suffix is the suffix
        # itself — drafting needs the one before it (think a period-1
        # repetition: the previous occurrence is what predicts the next
        # token); most-recent-wins keeps drafts tracking the live text
        self._index: Dict[Tuple[int, ...], Tuple[int, Optional[int]]] = {}
        self._ctx: List[int] = []

    def __len__(self) -> int:
        return len(self._ctx)

    def feed(self, tokens: Sequence[int]) -> None:
        """Append committed tokens and index every complete n-gram they
        close (latest occurrence, keeping the one it displaces)."""
        n = self.ngram
        ctx = self._ctx
        for t in tokens:
            ctx.append(int(t))
            if len(ctx) >= n:
                g = tuple(ctx[-n:])
                old = self._index.get(g)
                self._index[g] = (len(ctx), old[0] if old else None)

    def sync(self, prompt: Sequence[int], generated: Sequence[int]) -> None:
        """Catch the index up to `prompt + generated` (the request's
        committed sequence): feeds only the unseen tail, so callers can
        re-sync every round without re-walking the whole history."""
        total = len(prompt) + len(generated)
        have = len(self._ctx)
        if have >= total:
            return
        if have < len(prompt):
            self.feed(prompt[have:])
            have = len(self._ctx)
        self.feed(generated[have - len(prompt):])

    def draft(self, k: int) -> List[int]:
        """Up to `k` proposed continuation tokens; [] when the current
        suffix never occurred before. Tokens are drafted one at a time
        against the committed context — each drafted token slides the
        lookup window, so a cyclic tail (the common case for repetitive
        text) drafts the whole cycle forward, not just to the end of the
        match. Stops early at the first window with no earlier occurrence;
        the verify chunk's acceptance test makes any draft safe."""
        ctx, n = self._ctx, self.ngram
        total = len(ctx)
        if k <= 0 or total < n:
            return []
        out: List[int] = []
        window = list(ctx[-n:])  # committed suffix, slid over drafted tokens
        p: Optional[int] = None  # next source position in the committed ctx
        while len(out) < k:
            if p is None or p >= total:
                e = self._index.get(tuple(window))
                if e is None:
                    break
                latest, prev = e
                # a continuation start at the very end has nothing after
                # it (it IS the current suffix / the just-slid window):
                # fall back to the occurrence it displaced
                p = latest if latest < total else prev
                if p is None:
                    break
            out.append(ctx[p])
            window = window[1:] + [ctx[p]]
            p += 1
        return out
