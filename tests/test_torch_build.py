"""The port's kernel build cache (`paddle_tpu_torch/ops/build.py`), on the
CPU: a library's path is keyed by its source, every shared header under
`csrc/` and the flags, so editing a header that two sources include
rebuilds both; an unchanged tree reuses the library without calling nvcc.
Each test works on a temporary CSRC_DIR and BUILD_DIR."""

import pytest

from paddle_tpu_torch.ops import build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "one.cu").write_text('#include "shared.cuh"\nextern "C" int one() { return 1; }\n')
    (csrc / "two.cu").write_text('#include "shared.cuh"\nextern "C" int two() { return 2; }\n')
    (csrc / "shared.cuh").write_text("#pragma once\nconstexpr int kDepth = 16;\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)

    def no_nvcc(*a, **k):
        raise AssertionError("nvcc must not be called")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build.subprocess, "Popen", no_nvcc)
    return csrc


def test_editing_a_shared_header_changes_every_library_path(tree):
    before = {n: build.library_path(n) for n in ("one", "two")}
    assert before == {n: build.library_path(n) for n in ("one", "two")}  # stable
    (tree / "shared.cuh").write_text("#pragma once\nconstexpr int kDepth = 32;\n")
    after = {n: build.library_path(n) for n in ("one", "two")}
    assert all(after[n] != before[n] for n in after)
    assert all(p.parent == build.BUILD_DIR and p.name.startswith(n + "-")
               for n, p in after.items())


@pytest.mark.parametrize("change", ["add_header", "rename_header", "edit_source"])
def test_other_changes_to_the_tree_change_the_path(tree, change):
    before = build.library_path("one")
    if change == "add_header":
        (tree / "extra.cuh").write_text("#pragma once\n")
    elif change == "rename_header":
        (tree / "shared.cuh").rename(tree / "common.cuh")
    else:
        (tree / "one.cu").write_text('extern "C" int one() { return 11; }\n')
    assert build.library_path("one") != before


def test_editing_one_source_leaves_the_other_path(tree):
    before = build.library_path("two")
    (tree / "one.cu").write_text('extern "C" int one() { return 11; }\n')
    assert build.library_path("two") == before


def test_built_library_is_reused_without_nvcc(tree):
    lib = build.library_path("one")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert build.build(["one"]) == {"one": lib}
    assert build.headers() == [tree / "shared.cuh"]
