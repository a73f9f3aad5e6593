"""Pascal VOC2012 segmentation readers (python/paddle/v2/dataset/voc2012.py).

Records: (image float32[3,H,W] in [0,1], label int32[H,W] class map).
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.datasets import common

NUM_CLASSES = 21
IMG = (3, 128, 128)  # synthetic fallback size; real data is variable-size


def _synthetic(n: int, tag: str):
    def reader():
        rs = common.rng("voc2012." + tag)
        for _ in range(n):
            img = rs.rand(*IMG).astype(np.float32)
            label = np.zeros(IMG[1:], np.int32)
            # a rectangle of one class per image
            c = int(rs.randint(1, NUM_CLASSES))
            y0, x0 = rs.randint(0, IMG[1] // 2, 2)
            h, w = rs.randint(16, IMG[1] // 2, 2)
            label[y0 : y0 + h, x0 : x0 + w] = c
            img[0, y0 : y0 + h, x0 : x0 + w] += 0.01 * c
            yield np.clip(img, 0, 1), label

    return reader


def train(mapper=None):
    return common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("VOC tarball needs network")),
        lambda: _synthetic(512, "train"),
        "voc2012.train",
    )


def test(mapper=None):
    return common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("VOC tarball needs network")),
        lambda: _synthetic(128, "test"),
        "voc2012.test",
    )


def val(mapper=None):
    return test(mapper)
