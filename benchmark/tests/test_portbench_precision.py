"""The e4m3 control on the CPU: every product and convolution takes its
two operands rounded to float8 e4m3, each under its own scale, and sums
in fp32; nothing else is rounded, and the rounding ends with the block."""

import pytest
import torch
import torch.nn.functional as F

from benchmark.reference.precision import (
    E4M3_MAX,
    part,
    precision,
    round_e4m3,
)


def _e4m3_values() -> torch.Tensor:
    """Every finite e4m3 value, from its 256 bit patterns, ascending."""
    v = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn).float()
    return v[torch.isfinite(v)].unique()


def _randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def test_an_operand_rounds_to_the_nearest_e4m3_value_under_its_scale():
    t = _randn(600, seed=1) * 3.0
    q = round_e4m3(t)
    scale = float(t.abs().max()) / E4M3_MAX
    grid = _e4m3_values()
    assert grid.max() == E4M3_MAX and len(grid) == 253
    nearest = grid[(t[:, None] / scale - grid[None, :]).abs().argmin(dim=1)]
    assert torch.equal(q, nearest * scale)
    # the largest magnitude lands on e4m3's largest, 3 bits of mantissa
    # hold the rest to 2^-4 of their size where they are normal
    assert float(q.abs().max()) == pytest.approx(float(t.abs().max()),
                                                 rel=1e-6)
    normal = (t / scale).abs() >= 2.0 ** -6
    assert ((q - t).abs() <= 2.0 ** -4 * t.abs())[normal].all()
    assert not torch.equal(q, t)
    assert torch.equal(round_e4m3(torch.zeros(3)), torch.zeros(3))


def test_products_and_convolutions_take_rounded_operands_in_the_block():
    a, b = _randn(7, 33, seed=2), _randn(33, 5, seed=3)
    bias = _randn(5, seed=4)
    x, w = _randn(2, 3, 9, 9, seed=5), _randn(4, 3, 2, 2, seed=6)
    x1, w1 = _randn(2, 1, 13, seed=7), _randn(8, 1, 3, seed=8)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with precision("e4m3") as dtype:
        assert dtype == torch.float32
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (False, False)
        got = {"matmul": a @ b, "mm": torch.mm(a, b),
               "linear": F.linear(a, b.t(), bias),
               "conv2d": F.conv2d(x, w, bias[:4], stride=2),
               "conv1d": F.conv1d(x1, w1, None, stride=2),
               "add": a + 1.0}
    ra, rb = round_e4m3(a), round_e4m3(b)
    want = {"matmul": ra @ rb, "mm": ra @ rb,
            "linear": ra @ round_e4m3(b.t()).t() + bias,
            "conv2d": F.conv2d(round_e4m3(x), round_e4m3(w), bias[:4],
                               stride=2),
            "conv1d": F.conv1d(round_e4m3(x1), round_e4m3(w1), None,
                               stride=2),
            "add": a + 1.0}
    for name in got:
        assert torch.equal(got[name], want[name]), name
    assert not torch.equal(got["matmul"], a @ b)
    assert torch.equal(a @ b, torch.mm(a, b))  # plain again after
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_the_e4m3_split_lowers_the_autoencoder_alone():
    assert [part("e4m3", p) for p in ("frontend", "fit", "ae")] == [
        "float32", "float64", "e4m3"]
    # a control without a split part runs it in its own precision
    assert part("tf32_ae", "fit") == "tf32_ae"
    assert part("tf32", "fit") == part("tf32", "ae") == "tf32"
