"""PTB (imikolov) language-model readers (python/paddle/v2/dataset/imikolov.py).

build_dict() → vocab; train(word_idx, n)/test(word_idx, n) yield n-gram tuples
(w0, ..., wn-1) of word ids — the word2vec / n-gram LM schema.
"""

from __future__ import annotations

import tarfile
from typing import Dict

from paddle_tpu_torch.data.datasets import common

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
MD5 = "30177ea32e27c525793142b6bf2c8e2d"

TRAIN_FILE = "./simple-examples/data/ptb.train.txt"
TEST_FILE = "./simple-examples/data/ptb.valid.txt"


def _lines_from_tar(fname: str):
    path = common.download(URL, "imikolov", MD5)
    with tarfile.open(path) as tar:
        f = tar.extractfile(fname)
        assert f is not None
        for line in f.read().decode().splitlines():
            yield line.strip().split()


def build_dict(min_word_freq: int = 50) -> Dict[str, int]:
    def fetch():
        freq: Dict[str, int] = {}
        for words in _lines_from_tar(TRAIN_FILE):
            for w in words:
                freq[w] = freq.get(w, 0) + 1
        freq.pop("<unk>", None)
        kept = [w for w, c in freq.items() if c > min_word_freq]
        kept.sort(key=lambda w: (-freq[w], w))
        d = {w: i for i, w in enumerate(kept)}
        d["<unk>"] = len(d)
        return d

    def synth():
        d = {f"w{i}": i for i in range(2000)}
        d["<unk>"] = len(d)
        return d

    return common.fetch_or_synthetic(fetch, synth, "imikolov.build_dict")


def _ngram_reader(word_idx: Dict[str, int], n: int, fname: str):
    common.download(URL, "imikolov", MD5)  # fail fast here, not inside the generator
    unk = word_idx["<unk>"]
    eos = word_idx.get("<e>", unk)  # sentence end maps to UNK like the reference

    def reader():
        for words in _lines_from_tar(fname):
            ids = [word_idx.get(w, unk) for w in words] + [eos]
            for i in range(n, len(ids) + 1):
                yield tuple(ids[i - n : i])

    return reader


def _synthetic_ngrams(word_idx: Dict[str, int], n: int, count: int, tag: str):
    v = len(word_idx)

    def reader():
        rs = common.rng("imikolov." + tag)
        # markov-ish stream: next word depends on previous (learnable signal)
        w = int(rs.randint(0, v))
        buf = [w]
        for _ in range(count + n):
            w = (w * 31 + int(rs.randint(0, 7))) % v
            buf.append(w)
            if len(buf) >= n:
                yield tuple(buf[-n:])

    return reader


def train(word_idx: Dict[str, int], n: int):
    return common.fetch_or_synthetic(
        lambda: _ngram_reader(word_idx, n, TRAIN_FILE),
        lambda: _synthetic_ngrams(word_idx, n, 4096, "train"),
        "imikolov.train",
    )


def test(word_idx: Dict[str, int], n: int):
    return common.fetch_or_synthetic(
        lambda: _ngram_reader(word_idx, n, TEST_FILE),
        lambda: _synthetic_ngrams(word_idx, n, 512, "test"),
        "imikolov.test",
    )
