"""NLTK movie-reviews sentiment readers (python/paddle/v2/dataset/sentiment.py).

Records: (word_ids, label 0/1).
"""

from __future__ import annotations

from typing import Dict

from paddle_tpu_torch.data.datasets import common

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 4000


def get_word_dict() -> Dict[str, int]:
    def synth():
        return {f"w{i}": i for i in range(_VOCAB)}

    return common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("nltk corpus fetch needs network")),
        synth,
        "sentiment.word_dict",
    )


def _synthetic(n: int, tag: str):
    def reader():
        rs = common.rng("sentiment." + tag)
        for _ in range(n):
            label = int(rs.randint(0, 2))
            length = int(rs.randint(10, 60))
            ids = rs.randint(100, _VOCAB, length).tolist()
            cue_base = 10 if label == 0 else 50
            for _k in range(max(2, length // 10)):
                ids[int(rs.randint(0, length))] = cue_base + int(rs.randint(0, 30))
            yield ids, label

    return reader


def train():
    return common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("nltk corpus fetch needs network")),
        lambda: _synthetic(NUM_TRAINING_INSTANCES, "train"),
        "sentiment.train",
    )


def test():
    return common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("nltk corpus fetch needs network")),
        lambda: _synthetic(NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES, "test"),
        "sentiment.test",
    )
