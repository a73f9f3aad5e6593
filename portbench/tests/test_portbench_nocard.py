"""A run that finds no card, or fewer than its cell asks for, fails and
prints no result."""

import subprocess
import sys

import pytest
import torch

from portbench.manifest import ROOT


@pytest.mark.parametrize("cell", ["resnet50.b256", "resnet50.dp4"])
def test_no_card_no_result(cell):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has the cards the cells ask for")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    if cell == "resnet50.b256" and torch.cuda.is_available():
        pytest.skip("one card is enough for this cell")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the program is absent: the run fails."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "nmt.full",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
