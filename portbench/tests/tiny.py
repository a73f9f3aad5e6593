"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
harness's tests (widths and batches cut here only; the cells run at the
configurations' own sizes)."""

from __future__ import annotations

from portbench import manifest

# limits for these sizes on the CPU, from what sound runs read there: the
# seq2seq's f32 paths agree to ~1e-7; ResNet-50's f32 batch norm (one pass
# against the reference's two) and lr 0.1 leave ~1e-2 on the worst leaf
# ~2e-1 on the worst change after three steps and ~1e-1 on the third
# step's loss (the trajectory swings at this size). A planted fault reads
# 0.3 or more on the median leaf of one of them.
LIMITS = {
    "resnet50": {"loss_gap": 0.5, "loss1_gap": 1e-3, "grad_gap": 5e-2, "grad_gap_med": 1e-2,
                 "delta_gap": 1.0, "delta_gap_med": 5e-2},
    "nmt": {"loss_gap": 1e-4, "loss1_gap": 1e-4, "grad_gap": 1e-3, "grad_gap_med": 1e-3,
            "delta_gap": 1e-2, "delta_gap_med": 1e-3},
}


def cell(name: str) -> manifest.Cell:
    c = manifest.load(name)
    cfg = c.config
    if cfg["name"] == "resnet50":
        # f32: at 64 x 64 and 16 images bf16 rounding swamps what is compared
        cfg.update(image_size=64, classes=10, precision="f32")
        cfg["inputs"]["image"]["shape"] = [64, 64, 3]
        cfg["inputs"]["label"]["high"] = 10
        c.traffic.update(batch=16, pool=4, trace_steps=2)
    else:
        cfg.update(src_vocab=100, trg_vocab=100, embed_dim=16, hidden_dim=16, attention_dim=16)
        for slot in cfg["inputs"].values():
            slot["high"] = 100
        c.traffic.update(batch=8, pool=4, width=8, trace_steps=2)
        for d in c.traffic["lengths"].values():
            if d["dist"] == "fixed":
                d["value"] = 8
            else:
                d.update(min=2, max=8)
                if d["dist"] == "lognormal":
                    d["median"] = 5
    c.limits = dict(LIMITS[cfg["name"]])
    return c
