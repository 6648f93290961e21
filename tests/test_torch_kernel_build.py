"""The kernel libraries' build key: a library is rebuilt when its source or
any shared header under ``csrc`` changes, and only then (no ``nvcc`` is
needed: the key is a hash of bytes); and the alignment the bf16 kernels
require of their inputs."""

import shutil

import pytest
import torch

from applecider_tpu_torch.ops import kernel


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(kernel.CSRC, copy)
    monkeypatch.setattr(kernel, "CSRC", copy)
    return copy


def _keys():
    return {name: kernel._library_path(name).name for name in kernel.SOURCES}


@pytest.mark.parametrize("header", ["common.cuh", "mma.cuh"])
def test_every_library_key_covers_each_header(csrc, header):
    before = _keys()
    assert _keys() == before  # the key is a function of the bytes alone
    path = csrc / header
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = _keys()
    assert all(after[name] != before[name] for name in kernel.SOURCES), (before, after)


def test_a_new_header_changes_the_key(csrc):
    before = _keys()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _keys()
    assert all(after[name] != before[name] for name in kernel.SOURCES)


def test_a_source_edit_changes_only_its_own_key(csrc):
    before = _keys()
    path = csrc / "attention.cu"
    path.write_bytes(path.read_bytes() + b"\n")
    after = _keys()
    assert after["attention"] != before["attention"]
    assert all(after[name] == before[name] for name in kernel.SOURCES if name != "attention")


def test_require_aligned_refuses_offset_views():
    """The bf16 tensor-core kernels load q, k and v in 16-byte chunks; a
    view whose data starts off a 16-byte boundary is refused."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    kernel.require_aligned(base, base[8:])  # 16 bytes in: aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel.require_aligned(base, base[1:])
