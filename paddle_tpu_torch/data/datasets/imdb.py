"""IMDB sentiment readers (python/paddle/v2/dataset/imdb.py).

word_dict() → {word: idx}; train(word_idx)/test(word_idx) yield
([word_ids...], label 0/1) — the v2 record schema for text classification.
"""

from __future__ import annotations

import re
import tarfile
from typing import Dict

from paddle_tpu_torch.data.datasets import common

URL = "https://ai.stanford.edu/~amaas/data/sentiment/aclImdb_v1.tar.gz"
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"

_WORDS = re.compile(r"[a-z]+")

# deterministic synthetic vocabulary: positive/negative cue words + filler
_SYN_VOCAB = 5000
_SYN_POS = list(range(10, 60))
_SYN_NEG = list(range(60, 110))


def _tokenize(text: str):
    return _WORDS.findall(text.lower())


def _build_dict_from_tar(path: str, pattern: str, cutoff: int = 150) -> Dict[str, int]:
    freq: Dict[str, int] = {}
    pat = re.compile(pattern)
    with tarfile.open(path) as tar:
        for member in tar.getmembers():
            if not pat.match(member.name):
                continue
            f = tar.extractfile(member)
            if f is None:
                continue
            for w in _tokenize(f.read().decode("latin1")):
                freq[w] = freq.get(w, 0) + 1
    words = [w for w, c in freq.items() if c > cutoff]
    words.sort(key=lambda w: (-freq[w], w))
    return {w: i for i, w in enumerate(words)}


def word_dict() -> Dict[str, int]:
    def fetch():
        path = common.download(URL, "imdb", MD5)
        return _build_dict_from_tar(path, r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$")

    def synth():
        return {f"w{i}": i for i in range(_SYN_VOCAB)}

    return common.fetch_or_synthetic(lambda: fetch(), lambda: synth(), "imdb.word_dict")


def _reader_from_tar(word_idx: Dict[str, int], pattern_pos: str, pattern_neg: str):
    path = common.download(URL, "imdb", MD5)
    unk = len(word_idx)

    def read_label(pattern, label):
        pat = re.compile(pattern)
        with tarfile.open(path) as tar:
            for member in tar.getmembers():
                if not pat.match(member.name):
                    continue
                f = tar.extractfile(member)
                if f is None:
                    continue
                ids = [word_idx.get(w, unk) for w in _tokenize(f.read().decode("latin1"))]
                if ids:
                    yield ids, label

    def reader():
        yield from read_label(pattern_pos, 0)
        yield from read_label(pattern_neg, 1)

    return reader


def _synthetic_reader(word_idx: Dict[str, int], n: int, tag: str):
    def reader():
        rs = common.rng("imdb." + tag)
        v = max(len(word_idx), 200)
        for _ in range(n):
            label = int(rs.randint(0, 2))
            length = int(rs.randint(20, 120))
            ids = rs.randint(110, v, size=length).tolist()
            cues = _SYN_POS if label == 0 else _SYN_NEG
            for _k in range(max(3, length // 8)):
                ids[int(rs.randint(0, length))] = int(cues[rs.randint(0, len(cues))])
            yield ids, label

    return reader


def train(word_idx: Dict[str, int]):
    return common.fetch_or_synthetic(
        lambda: _reader_from_tar(word_idx, r"aclImdb/train/pos/.*\.txt$", r"aclImdb/train/neg/.*\.txt$"),
        lambda: _synthetic_reader(word_idx, 1024, "train"),
        "imdb.train",
    )


def test(word_idx: Dict[str, int]):
    return common.fetch_or_synthetic(
        lambda: _reader_from_tar(word_idx, r"aclImdb/test/pos/.*\.txt$", r"aclImdb/test/neg/.*\.txt$"),
        lambda: _synthetic_reader(word_idx, 256, "test"),
        "imdb.test",
    )
