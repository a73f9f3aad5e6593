"""CIFAR-10/100 readers (python/paddle/v2/dataset/cifar.py).

Records: (image: float32[3072] in [0,1] CHW-flattened, label: int).
"""

from __future__ import annotations

import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.data.datasets import common

URL10 = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
MD5_10 = "c58f30108f718f92721af3b95e74349a"
URL100 = "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz"
MD5_100 = "eb9058c3a382ffc7106e4002c42a8d85"


def _reader_from_tar(path: str, sub_name: str, label_key: str):
    def reader():
        with tarfile.open(path) as tar:
            for member in tar.getmembers():
                if sub_name not in member.name:
                    continue
                f = tar.extractfile(member)
                assert f is not None
                batch = pickle.load(f, encoding="latin1")
                data = np.asarray(batch["data"], np.float32) / 255.0
                labels = batch[label_key]
                for i in range(len(labels)):
                    yield data[i], int(labels[i])

    return reader


def _synthetic(n: int, classes: int, tag: str):
    def reader():
        rs = common.rng("cifar." + tag)
        for _ in range(n):
            label = int(rs.randint(0, classes))
            img = rs.rand(3072).astype(np.float32) * 0.5
            img[label :: classes] = np.minimum(img[label :: classes] + 0.4, 1.0)
            yield img, label

    return reader


def train10():
    return common.fetch_or_synthetic(
        lambda: _reader_from_tar(common.download(URL10, "cifar", MD5_10), "data_batch", "labels"),
        lambda: _synthetic(2048, 10, "train10"),
        "cifar.train10",
    )


def test10():
    return common.fetch_or_synthetic(
        lambda: _reader_from_tar(common.download(URL10, "cifar", MD5_10), "test_batch", "labels"),
        lambda: _synthetic(512, 10, "test10"),
        "cifar.test10",
    )


def train100():
    return common.fetch_or_synthetic(
        lambda: _reader_from_tar(common.download(URL100, "cifar", MD5_100), "train", "fine_labels"),
        lambda: _synthetic(2048, 100, "train100"),
        "cifar.train100",
    )


def test100():
    return common.fetch_or_synthetic(
        lambda: _reader_from_tar(common.download(URL100, "cifar", MD5_100), "test", "fine_labels"),
        lambda: _synthetic(512, 100, "test100"),
        "cifar.test100",
    )
