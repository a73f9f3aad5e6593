"""The traffic generator: the seed decides the values and their order,
never the amount of work."""

import numpy as np
import pytest

from portbench import generator, manifest


def _pool(cell, seed):
    c = manifest.load(cell)
    if c.config["name"] == "resnet50":
        c.config["inputs"]["image"]["shape"] = [8, 8, 3]
        c.traffic.update(batch=4, pool=3)
    return c, generator.make_pool(c.config, c.traffic, seed)


@pytest.mark.parametrize("cell", ["resnet50.b256", "nmt.ragged", "nmt.full"])
def test_same_seed_same_batches(cell):
    _, a = _pool(cell, 2 ** 31 + 7)
    _, b = _pool(cell, 2 ** 31 + 7)
    _, c = _pool(cell, 5)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert any(not np.array_equal(x[k], y[k]) for x, y in zip(a, c) for k in x)


def test_ragged_lengths_clipped_and_the_same_multiset_for_every_seed():
    c, a = _pool("nmt.ragged", 1)
    _, b = _pool("nmt.ragged", 99)
    spec = c.traffic["lengths"]
    for name in ("source_ids", "target_ids"):
        d = spec["source" if name == "source_ids" else "target"]
        la = np.concatenate([p[f"{name}.lengths"] for p in a])
        lb = np.concatenate([p[f"{name}.lengths"] for p in b])
        assert la.min() >= d["min"] and la.max() <= d["max"]
        assert la.min() == d["min"] and la.max() == d["max"]  # the tails reach the clips
        np.testing.assert_array_equal(np.sort(la), np.sort(lb))
    # the work a batch holds hardly depends on the seed's deal
    per_batch = [int(p["target_ids.lengths"].sum()) for p in a]
    assert max(per_batch) - min(per_batch) <= 0.02 * np.mean(per_batch)
    src = np.concatenate([p["source_ids.lengths"] for p in a])
    assert 20 <= np.median(src) <= 28


def test_padding_is_zero_and_labels_follow_targets():
    _, pool = _pool("nmt.ragged", 3)
    for p in pool:
        for name in ("source_ids", "target_ids", "label_ids"):
            ids, lens = p[name], p[f"{name}.lengths"]
            steps = np.arange(ids.shape[1])[None]
            assert (ids[steps >= lens[:, None]] == 0).all()
            assert (ids[steps < lens[:, None]] >= 2).all()
        np.testing.assert_array_equal(p["target_ids.lengths"], p["label_ids.lengths"])


def test_full_traffic_is_every_row_at_the_width():
    _, pool = _pool("nmt.full", 4)
    for p in pool:
        assert (p["source_ids.lengths"] == 50).all() and (p["target_ids.lengths"] == 50).all()
