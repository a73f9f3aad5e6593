"""MNIST readers (python/paddle/v2/dataset/mnist.py).

train()/test() yield (image: float32[784] in [-1,1], label: int) — the exact
v2 record schema.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from paddle_tpu_torch.data.datasets import common

URL_PREFIX = "https://storage.googleapis.com/cvdf-datasets/mnist/"
TRAIN_IMAGES = ("train-images-idx3-ubyte.gz", "f68b3c2dcbeaaa9fbdd348bbdeb94873")
TRAIN_LABELS = ("train-labels-idx1-ubyte.gz", "d53e105ee54ea40749a09fcbcd1e9432")
TEST_IMAGES = ("t10k-images-idx3-ubyte.gz", "9fb629c4189551a2d022fa330f9573f3")
TEST_LABELS = ("t10k-labels-idx1-ubyte.gz", "ec29112dd5afa0611ce80d1b7f02629c")


def _reader_from_idx(img_file: str, lbl_file: str):
    def reader():
        with gzip.open(img_file, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            assert magic == 2051
            images = np.frombuffer(f.read(n * rows * cols), np.uint8)
            images = images.reshape(n, rows * cols).astype(np.float32)
            images = images / 255.0 * 2.0 - 1.0
        with gzip.open(lbl_file, "rb") as f:
            magic, n2 = struct.unpack(">II", f.read(8))
            assert magic == 2049 and n2 == n
            labels = np.frombuffer(f.read(n), np.uint8).astype(np.int64)
        for i in range(n):
            yield images[i], int(labels[i])

    return reader


def _synthetic(n: int, tag: str):
    def reader():
        rs = common.rng("mnist." + tag)
        for _ in range(n):
            label = int(rs.randint(0, 10))
            img = rs.randn(784).astype(np.float32) * 0.25
            # class-dependent blob so models can actually learn from it
            img[label * 70 : label * 70 + 70] += 1.0
            yield np.clip(img, -1, 1), label

    return reader


def train():
    return common.fetch_or_synthetic(
        lambda: _reader_from_idx(
            common.download(URL_PREFIX + TRAIN_IMAGES[0], "mnist", TRAIN_IMAGES[1]),
            common.download(URL_PREFIX + TRAIN_LABELS[0], "mnist", TRAIN_LABELS[1]),
        ),
        lambda: _synthetic(2048, "train"),
        "mnist.train",
    )


def test():
    return common.fetch_or_synthetic(
        lambda: _reader_from_idx(
            common.download(URL_PREFIX + TEST_IMAGES[0], "mnist", TEST_IMAGES[1]),
            common.download(URL_PREFIX + TEST_LABELS[0], "mnist", TEST_LABELS[1]),
        ),
        lambda: _synthetic(512, "test"),
        "mnist.test",
    )
