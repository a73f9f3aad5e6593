"""UCI Boston housing readers (python/paddle/v2/dataset/uci_housing.py).

Records: (features: float32[13] normalized, price: float32[1]).
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.datasets import common

URL = "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/housing.data"
MD5 = "d4accdce7a25600298819f8e28e8d593"
FEATURE_NUM = 13


def _load(path: str):
    data = np.loadtxt(path)
    feats, prices = data[:, :FEATURE_NUM], data[:, FEATURE_NUM:]
    maxs, mins, avgs = feats.max(0), feats.min(0), feats.mean(0)
    feats = (feats - avgs) / (maxs - mins + 1e-8)
    return feats.astype(np.float32), prices.astype(np.float32)


def _synthetic(n: int, tag: str):
    rs = common.rng("uci_housing." + tag)
    w = common.rng("uci_housing.w").randn(FEATURE_NUM).astype(np.float32)
    feats = rs.randn(n, FEATURE_NUM).astype(np.float32)
    prices = (feats @ w + 0.1 * rs.randn(n)).astype(np.float32)[:, None] + 22.0
    return feats, prices


def _make(split: str):
    def fetch():
        feats, prices = _load(common.download(URL, "uci_housing", MD5))
        return _reader(feats, prices, split)

    def synth():
        feats, prices = _synthetic(506, "all")
        return _reader(feats, prices, split)

    return common.fetch_or_synthetic(fetch, synth, f"uci_housing.{split}")


def _reader(feats, prices, split: str):
    n = len(feats)
    cut = int(n * 0.8)
    lo, hi = (0, cut) if split == "train" else (cut, n)

    def reader():
        for i in range(lo, hi):
            yield feats[i], prices[i]

    return reader


def train():
    return _make("train")


def test():
    return _make("test")
