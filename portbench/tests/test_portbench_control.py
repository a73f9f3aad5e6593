"""The control on the card: the reference computed in the precision below
the configuration's (fp8 for ResNet-50's bf16, TF32 for the seq2seq's f32)
put in the program's place comes out not correct at the cell's own size,
where the program itself comes out correct. Needs a card; skipped without
one."""

import pytest
import torch

from portbench import compare, manifest
from portbench.harness import Coord, Setup

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["resnet50.b256", "nmt.ragged", "nmt.full"])
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")
    cell = manifest.load(name)
    s = Setup(cell, Coord(), torch.device("cuda", 0))
    first = s.first_steps(987654321)
    s.trainer.graphs.clear()
    torch.cuda.empty_cache()
    ref = s.reference(first)
    ok, _ = compare.judge(compare.numbers(first["prog"], ref), cell.limits)
    assert ok
    control = s.reference(first, precision=cell.config["control"])
    ok, compared = compare.judge(compare.numbers(control, ref), cell.limits)
    assert not ok, compared
