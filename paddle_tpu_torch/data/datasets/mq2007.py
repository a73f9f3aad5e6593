"""MQ2007 learning-to-rank readers (python/paddle/v2/dataset/mq2007.py).

Two formats, as in the reference:
- format="pointwise": (feature[46], relevance)
- format="pairwise":  (feature_hi[46], feature_lo[46]) with rel(hi)>rel(lo)
- format="listwise":  (query_list_of_features, query_list_of_scores)
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.datasets import common

FEATURE_DIM = 46


def _synthetic_queries(n_queries: int, tag: str):
    rs = common.rng("mq2007." + tag)
    w = common.rng("mq2007.w").randn(FEATURE_DIM).astype(np.float32)
    queries = []
    for _ in range(n_queries):
        n_docs = int(rs.randint(5, 20))
        feats = rs.randn(n_docs, FEATURE_DIM).astype(np.float32)
        scores = feats @ w + 0.05 * rs.randn(n_docs)
        rel = np.digitize(scores, np.percentile(scores, [60, 85])).astype(np.int32)
        queries.append((feats, rel))
    return queries


def _make(split: str, fmt: str):
    def synth():
        queries = _synthetic_queries(300 if split == "train" else 60, split)

        def pointwise():
            for feats, rel in queries:
                for i in range(len(rel)):
                    yield feats[i], int(rel[i])

        def pairwise():
            rs = common.rng(f"mq2007.pair.{split}")
            for feats, rel in queries:
                idx = np.argsort(-rel)
                for a in range(len(idx)):
                    for b in range(a + 1, len(idx)):
                        if rel[idx[a]] > rel[idx[b]]:
                            if rs.rand() < 0.25:  # subsample pairs
                                yield feats[idx[a]], feats[idx[b]]

        def listwise():
            for feats, rel in queries:
                yield feats, rel.astype(np.float32)

        return {"pointwise": pointwise, "pairwise": pairwise, "listwise": listwise}[fmt]

    return common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("MQ2007 mirror needs network")),
        synth,
        f"mq2007.{split}",
    )


def train(format: str = "pairwise"):
    return _make("train", format)


def test(format: str = "pairwise"):
    return _make("test", format)
