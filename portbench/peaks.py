"""Published peaks of the cards the benchmark knows, dense (no sparsity),
at the card's full power limit: NVIDIA's H100 data sheet. A share of a
peak is stated against these, with the card's power limit beside it."""

from __future__ import annotations

from typing import Dict

# device name as torch.cuda.get_device_name() gives it -> peaks
CARDS: Dict[str, Dict[str, float]] = {
    # SXM5 part
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def card(name: str) -> Dict[str, float]:
    """The peaks of the card called `name`; raises for a card not in the
    table (a share of an unknown peak is no number)."""
    if name not in CARDS:
        raise KeyError(f"no published peaks for {name!r} in portbench/peaks.py")
    return CARDS[name]
