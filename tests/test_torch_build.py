"""The port's kernel build cache and operand layout, on the CPU (no nvcc).

`ops/_build.py` names each library by a hash of what goes into it, so an
edit to a kernel's source, to any shared header or to the flags builds a
new library instead of loading a stale one."""

import pytest
import torch

from icra2021_multimodal_ad_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// mainloop, first draft\n")
    (tmp_path / "other.cu").write_text("// another kernel\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", [
    lambda d: (d / "k.cu").write_text('#include "shared.cuh"\n// edited\n'),
    lambda d: (d / "shared.cuh").write_text("// mainloop, second draft\n"),
    lambda d: (d / "new.cuh").write_text("// a header added later\n"),
    lambda d: (d / "shared.cuh").rename(d / "renamed.cuh"),
], ids=["source", "shared header", "new header", "renamed header"])
def test_library_path_follows_the_source_and_every_header(csrc, edit):
    before = _build.library_path("k")
    assert before.parent == _build.BUILD_DIR
    assert before.name.startswith("libk_") and before.suffix == ".so"
    edit(csrc)
    assert _build.library_path("k") != before


def test_library_path_is_stable_and_ignores_other_sources(csrc):
    before = _build.library_path("k")
    (csrc / "other.cu").write_text("// another kernel, edited\n")
    assert _build.library_path("k") == before


def test_library_path_follows_the_flags(csrc, monkeypatch):
    before = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("k") != before


@pytest.mark.parametrize("dtype,per", [(torch.float32, 4),
                                       (torch.bfloat16, 8)])
def test_padded_layout_rows_are_16_byte_aligned(dtype, per):
    for cols in (1, per, per + 1, 1402, 5482):
        t = _build.padded_empty(3, cols, dtype, "cpu")
        assert t.shape == (3, cols) and t.stride(1) == 1
        assert t.stride(0) % per == 0 and cols <= t.stride(0) < cols + per
        assert t.data_ptr() % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operand_copies_only_what_the_kernel_cannot_read(dtype):
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    ok = torch.randn(5, 8 * per).to(dtype)
    assert _build.operand(ok, dtype) is ok
    for x in (torch.randn(5, 8 * per + 1),                 # ragged rows
              torch.randn(5, 8 * per)[:, 1:],              # misaligned
              torch.randn(8 * per, 5).t(),                 # column-major
              torch.randn(5, 8 * per, dtype=torch.float64)):  # other dtype
        got = _build.operand(x, dtype)
        assert got.dtype == dtype and got.stride(0) % per == 0
        assert torch.equal(got, x.to(dtype))
