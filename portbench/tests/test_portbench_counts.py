"""The FLOP and byte counts the per-layer metrics divide by."""

import math

import pytest
import torch

from portbench import manifest, peaks


def test_resnet50_forward_flops():
    ref = manifest.load("resnet50.b256").reference()
    cfg = manifest.load("resnet50.b256").config
    # the v1 layout (stride on the first 1x1 conv) counts 7.716 GFLOP an
    # image; v1.5 (stride on the 3x3), the 8.18 GFLOP often quoted, more
    assert ref.forward_flops_per_image(cfg) == pytest.approx(7.715946496e9, rel=1e-9)
    assert ref.forward_flops_per_image(cfg) < 8.18e9
    batch = {"label": [0] * 256}
    assert ref.step_flops(cfg, batch) == pytest.approx(3 * 256 * 7.715946496e9)


def test_gru_bound_counts_the_valid_steps():
    """At phase 3's shape (T = 50, B = 128, H = 512, lengths 30-50 from seed
    5) the backward's bound is the PERF.md kernel table's 0.240 ms, by
    operations at the f32 peak. The forward's operations are counted over
    the valid steps alone (2 x steps x H x 3H), under the table's 0.132 ms,
    which counted the kernel's walk: (r h) W_c at every padded row and
    h W_zr once past each row's last step. Where every length is T the two
    counts agree."""
    ref = manifest.load("nmt.full").reference()
    card = peaks.card("NVIDIA H100 80GB HBM3")
    g = torch.Generator().manual_seed(5)
    lens = torch.randint(30, 51, (128,), generator=g)
    lens[0] = 50
    bound = ref.gru_bound_s(lens.tolist(), 50, 128, 512, card)
    assert bound["bwd"] * 1e3 == pytest.approx(0.240, abs=5e-4)
    steps = int(lens.sum())
    assert bound["fwd"] == pytest.approx(2 * steps * 512 * 3 * 512 / card["f32"])
    assert bound["fwd"] * 1e3 < 0.132 - 5e-4
    full = ref.gru_bound_s([50] * 128, 50, 128, 512, card)
    walk = (2 * 50 * 128 * 512 * 2 * 512 + 2 * 50 * 128 * 512 * 512) / card["f32"]
    assert full["fwd"] == pytest.approx(walk)
    assert full["bwd"] == pytest.approx(2 * walk)


def test_nmt_flops_follow_real_lengths():
    cell = manifest.load("nmt.ragged")
    ref, cfg = cell.reference(), cell.config
    full = ref.row_flops(cfg, 50, 50)
    # the vocabulary projection dominates: 2 x 50 x 512 x 30000 of the forward
    assert 2 * 50 * 512 * 30000 / full > 0.6
    assert ref.row_flops(cfg, 25, 25) < 0.55 * full
    batch = {"source_ids.lengths": [50, 25], "target_ids.lengths": [50, 25]}
    assert ref.step_flops(cfg, batch) == pytest.approx(
        3 * (full + ref.row_flops(cfg, 25, 25)))
    assert ref.work(cfg, batch) == 75


@pytest.mark.parametrize("config", ["resnet50.b256", "nmt.full"])
def test_params_from_the_seed(config):
    cell = manifest.load(config)
    ref, cfg = cell.reference(), dict(cell.config)
    if cfg["name"] == "nmt":
        cfg.update(src_vocab=50, trg_vocab=50, embed_dim=8, hidden_dim=8, attention_dim=8)
    else:
        cfg.update(classes=10)
    a, b = ref.make_params(cfg, 3, "cpu"), ref.make_params(cfg, 3, "cpu")
    shapes = ref.param_shapes(cfg)
    assert list(a) == list(shapes)
    for k, (shape, kind) in shapes.items():
        assert tuple(a[k].shape) == shape
        assert torch.equal(a[k], b[k])
        if kind in ("he", "smart") and math.prod(shape) > 1000:
            fan_in = math.prod(shape[:-1]) if kind == "he" else shape[0]
            want = math.sqrt(2 / fan_in) if kind == "he" else 1 / math.sqrt(fan_in)
            assert float(a[k].std()) == pytest.approx(want, rel=0.1)
