"""Oxford-102 flowers readers (python/paddle/v2/dataset/flowers.py).

Records: (image float32[3,224,224] CHW in [0,1], label int in [0,102)).
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.data.datasets import common

NUM_CLASSES = 102
IMAGE_SHAPE = (3, 224, 224)


def _synthetic(n: int, tag: str):
    def reader():
        rs = common.rng("flowers." + tag)
        for _ in range(n):
            label = int(rs.randint(0, NUM_CLASSES))
            img = rs.rand(*IMAGE_SHAPE).astype(np.float32) * 0.5
            ch = label % 3
            img[ch] = np.minimum(img[ch] + 0.3 + 0.002 * label, 1.0)
            yield img, label

    return reader


def train(mapper=None, buffered_size: int = 1024, use_xmap: bool = True):
    r = common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("flowers tarball needs network")),
        lambda: _synthetic(1024, "train"),
        "flowers.train",
    )
    return _maybe_map(r, mapper)


def test(mapper=None, buffered_size: int = 1024, use_xmap: bool = True):
    r = common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("flowers tarball needs network")),
        lambda: _synthetic(256, "test"),
        "flowers.test",
    )
    return _maybe_map(r, mapper)


def valid(mapper=None, **kw):
    return test(mapper, **kw)


def _maybe_map(reader, mapper):
    if mapper is None:
        return reader
    from paddle_tpu_torch.data.reader import map_readers

    return map_readers(mapper, reader)
