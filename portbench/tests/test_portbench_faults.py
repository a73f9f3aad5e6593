"""The comparison that decides `correct`, driven through the harness's
whole run on the CPU (the look for a card skipped, sizes cut): sound runs
come out correct, and each fault a training cell can have, planted under
the timed path, comes out not correct."""

import threading
import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = ["resnet50.b256", "nmt.ragged"]


def _run(cell, seed=2 ** 31 + 11):
    return harness.run_rank(cell, seed, 0.5, False, harness.Coord(), torch.device("cpu"),
                            time.time())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(tiny.cell(name))
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared"
    assert r["window"]["steps"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(name, monkeypatch):
    from paddle_tpu_torch.optim import optimizers

    monkeypatch.setattr(optimizers.Optimizer, "update", lambda self, *a, **k: None)
    r = _run(tiny.cell(name))
    assert not r["correct"]
    assert r["compared"]["delta_gap"]["value"] >= 0.5


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out(name, monkeypatch):
    from paddle_tpu_torch.trainer.trainer import SGDTrainer

    body = SGDTrainer._step_body

    def half(self, batch, weight=1):
        n = len(next(iter(batch.values()))) // 2
        return body(self, {k: v[:n] for k, v in batch.items()}, weight)

    monkeypatch.setattr(SGDTrainer, "_step_body", half)
    r = _run(tiny.cell(name))
    assert not r["correct"]


def _ranks(cell, world):
    """`world` thread ranks over gloo, as a multi-card run's processes."""
    from paddle_tpu_torch.parallel.mesh import new_gloo_group

    store = torch.distributed.HashStore()
    out, errs = [None] * world, []

    def rank(r):
        try:
            coord = harness.Coord(rank=r, world=world, store=store,
                                  group=new_gloo_group(store, r, world))
            out[r] = harness.run_rank(cell, 77, 0.5, False, coord, torch.device("cpu"),
                                      time.time())
        except Exception as e:  # noqa: BLE001 (handed to the test)
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    if errs:
        raise errs[0]
    return out[0]


def _dp_cell():
    c = tiny.cell("resnet50.dp4")
    c.traffic.update(batch=16, pool=3)
    return c


def test_two_ranks_sound():
    r = _ranks(_dp_cell(), 2)
    assert r["correct"], r["compared"]
    assert r["device"]["count"] == 2


def test_exchange_left_out(monkeypatch):
    from paddle_tpu_torch.parallel.data_parallel import DataParallel

    monkeypatch.setattr(DataParallel, "reduce_grads", lambda self, grads, cost: (grads, cost))
    r = _ranks(_dp_cell(), 2)
    assert not r["correct"]
