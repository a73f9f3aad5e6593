"""Image preprocessing utilities (python/paddle/v2/image.py parity:
load/resize/center-crop/random-crop/flip/to_chw/simple_transform) in pure
numpy — the host-side feed path (the port's copy of
`paddle_tpu/data/image.py`)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Resize so the short edge equals `size`. Always returns float32 HWC
    (grayscale gets a channel axis) so batched pipelines see one dtype/rank
    regardless of which inputs already matched the target size."""
    h, w = im.shape[:2]
    if h < w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    return _bilinear_resize(im, nh, nw)


def _bilinear_resize(im: np.ndarray, nh: int, nw: int) -> np.ndarray:
    h, w = im.shape[:2]
    if (h, w) == (nh, nw):
        out = im.astype(np.float32)
        return out[:, :, None] if out.ndim == 2 else out
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    im = im.astype(np.float32)
    if im.ndim == 2:
        im = im[:, :, None]
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(np.float32)


def center_crop(im: np.ndarray, size: int) -> np.ndarray:
    h, w = im.shape[:2]
    y = max(0, (h - size) // 2)
    x = max(0, (w - size) // 2)
    return im[y : y + size, x : x + size]


def random_crop(im: np.ndarray, size: int, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    h, w = im.shape[:2]
    y = rng.randint(0, max(h - size, 0) + 1)
    x = rng.randint(0, max(w - size, 0) + 1)
    return im[y : y + size, x : x + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    return im[:, ::-1]


def to_chw(im: np.ndarray) -> np.ndarray:
    """HWC → CHW (the reference's layout; our layers are NHWC — use only for
    interchange with reference-formatted data)."""
    return np.transpose(im, (2, 0, 1))


def simple_transform(
    im: np.ndarray,
    resize_size: int,
    crop_size: int,
    is_train: bool,
    mean: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """The reference's standard pipeline: resize-short → crop (+flip when
    training) → float32 → mean-subtract. Returns HWC float32."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng)
        if (rng or np.random).rand() > 0.5:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    im = im.astype(np.float32)
    if mean is not None:
        im = im - mean
    return im
