"""The one traffic generator: a configuration's input slots (`inputs` in
`configs/<config>.json`) and a mix's parameters (`traffic/<mix>.json`)
-> a pool of host batches, made from the seed.

Slot kinds:
  dense  f32 N(0, 1) of the slot's `shape` a row (images);
  ids    int32 uniform in [low, high); with `lengths: <name>`, a padded
         sequence of the mix's `width`, its `<name>.lengths` slot beside
         it and 0 past each row's length.

Sequence lengths (the mix's `lengths`): `fixed` (every row `value`),
`lognormal` (median, sigma) and `ratio` (another length times U(low,
high)), each rounded and clipped to [min, max]. Every seed gets the same
multiset of lengths: the pool's rows take the distribution's quantiles at
(i + 0.5) / N, and the seed only decides which row gets which (stratified,
so every batch holds about the same number of real tokens). The seed
changes the values and the order, never the amount of work.

Values are drawn with a `torch.Generator` on `device` (the card in a run:
a few large calls) and handed over as numpy arrays, as a data loader hands
them to the feed."""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def _clip_round(x: float, lo: int, hi: int) -> int:
    return int(min(max(round(x), lo), hi))


def length_table(spec: Mapping[str, Any], n: int) -> Dict[str, np.ndarray]:
    """The mix's lengths for n rows, before the seed's shuffle: one int32
    array of n a name, in the order the quantiles give them."""
    out: Dict[str, np.ndarray] = {}
    normal = statistics.NormalDist()
    for name, d in spec.items():
        kind = d["dist"]
        if kind == "fixed":
            vals = [int(d["value"])] * n
        elif kind == "lognormal":
            vals = [_clip_round(d["median"] * math.exp(d["sigma"] * normal.inv_cdf((i + 0.5) / n)),
                                d["min"], d["max"]) for i in range(n)]
        elif kind == "ratio":
            base = out[d["of"]]
            # a fixed low-discrepancy walk over U(low, high), decorrelated
            # from the base's quantile order
            vals = [_clip_round(base[i] * (d["low"] + (d["high"] - d["low"])
                                           * ((i * GOLDEN) % 1.0)), d["min"], d["max"])
                    for i in range(n)]
        else:
            raise ValueError(f"length {name}: unknown dist {kind!r}")
        out[name] = np.asarray(vals, dtype=np.int32)
    return out


def assign_rows(table: Dict[str, np.ndarray], pool: int, batch: int,
                gen: np.random.Generator, key: str) -> Dict[str, np.ndarray]:
    """Deal the table's n = pool x batch rows out to [pool, batch], by the
    seed: rows sorted by `key` fall into `batch` strata of `pool` rows, each
    batch takes one row of every stratum, so the batches' totals of `key`
    differ by little; then rows are shuffled within each batch."""
    order = np.argsort(table[key], kind="stable")
    strata = order.reshape(batch, pool)
    picks = np.stack([gen.permutation(s) for s in strata], axis=1)  # [pool, batch]
    for row in picks:
        gen.shuffle(row)
    return {name: v[picks] for name, v in table.items()}


def make_pool(config: Mapping[str, Any], traffic: Mapping[str, Any], seed: int,
              device: Any = "cpu") -> List[Dict[str, np.ndarray]]:
    """`traffic["pool"]` host batches of `traffic["batch"]` rows each."""
    pool, batch = int(traffic["pool"]), int(traffic["batch"])
    gen = np.random.default_rng(seed)
    lengths = {}
    if traffic.get("lengths"):
        table = length_table(traffic["lengths"], pool * batch)
        key = next(reversed(table))  # the last one named: the tokens counted
        lengths = assign_rows(table, pool, batch, gen, key)
    tgen = torch.Generator(device=device)
    tgen.manual_seed(int(seed) % (1 << 63))
    out: List[Dict[str, np.ndarray]] = [{} for _ in range(pool)]
    for name, slot in config["inputs"].items():
        kind = slot["kind"]
        if kind == "dense":
            shape = (batch,) + tuple(slot["shape"])
            for b in out:
                b[name] = torch.randn(shape, generator=tgen, device=device).cpu().numpy()
        elif kind == "ids":
            seq = slot.get("lengths")
            shape = (pool, batch, int(traffic["width"])) if seq else (pool, batch)
            ids = torch.randint(int(slot["low"]), int(slot["high"]), shape, generator=tgen,
                                device=device, dtype=torch.int32).cpu().numpy()
            if seq:
                lens = lengths[seq]
                ids[np.arange(shape[2])[None, None, :] >= lens[..., None]] = 0
            for i, b in enumerate(out):
                b[name] = ids[i]
                if seq:
                    b[f"{name}.lengths"] = lengths[seq][i].copy()
        else:
            raise ValueError(f"input {name}: unknown kind {kind!r}")
    return out
