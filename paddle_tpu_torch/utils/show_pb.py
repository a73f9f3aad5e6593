"""Inspect a merged model file (counterpart of `paddle_tpu/utils/show_pb.py`;
python/paddle/utils/show_pb.py): prints the stored TrainerConfig text and
the parameter table of a `merge_model` .npz (`capi/merge_model.py`)."""

from __future__ import annotations

import io
import sys
from typing import Optional, TextIO

import numpy as np


def show_merged_model(path: str, out: Optional[TextIO] = None) -> str:
    buf = io.StringIO()
    with np.load(path, allow_pickle=False) as z:
        if "__trainer_config__" in z.files:
            buf.write(str(z["__trainer_config__"]))
            buf.write("\n")
        buf.write("parameters:\n")
        for k in sorted(z.files):
            if k.startswith("param/"):
                a = z[k]
                buf.write(f"  {k[6:]}: shape={tuple(a.shape)} dtype={a.dtype}\n")
    text = buf.getvalue()
    (out or sys.stdout).write(text)
    return text
