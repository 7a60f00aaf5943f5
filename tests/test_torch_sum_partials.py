"""The plain mirror of sum_partials (K2's cross-block gradient sum) and the
wrapper's checks, on the CPU.

The kernel itself runs only on the card (tests/test_torch_kernels.py holds
it equal to the mirror bit for bit). Here: the mirror against a float64 sum
and against partials.sum(0), its order with one group, the row split the
kernel shares, and the wrapper raising ValueError before any build.
"""
import numpy as np
import pytest
import torch

from implicit_image_tpu_torch.ops import cuda_build
from implicit_image_tpu_torch.ops import sine_mlp as sm

# (blocks, P): the main path's buffer (512^2, d8, w128 on 132 SMs), one
# slice, fewer rows than groups, and more rows than the main path
SHAPES = [(132, 99_844), (1, 8), (7, 1_000), (133, 4_096)]
REL_TOL = 1e-6  # fp32 sum of <= 133 terms of unit scale against the exact sum


def _partials(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _max_rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_float64_sum(shape):
    p = _partials(shape)
    got = sm.sum_partials_reference(torch.from_numpy(p)).numpy()
    assert got.dtype == np.float32 and got.shape == (shape[1],)
    assert _max_rel(got.astype(np.float64), p.astype(np.float64).sum(0)) <= REL_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_agrees_with_library_sum(shape):
    t = torch.from_numpy(_partials(shape, seed=1))
    assert _max_rel(sm.sum_partials_reference(t).numpy(), t.sum(0).numpy()) <= REL_TOL


def test_one_group_is_the_sequential_row_loop():
    t = torch.from_numpy(_partials((37, 1_000), seed=2))
    s = torch.zeros(1_000)
    for r in range(37):
        s = s + t[r]
    assert torch.equal(sm.sum_partials_reference(t, 1), s)


def test_groups_are_summed_apart_then_in_group_order():
    t = torch.from_numpy(_partials((133, 256), seed=3))
    sums = [sm.sum_partials_reference(t[r0:r1], 1)
            for r0, r1 in sm.sum_partials_row_groups(133, 16)]
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    assert torch.equal(sm.sum_partials_reference(t, 16), out)
    # a different split adds in another order: the bits differ somewhere
    assert not torch.equal(sm.sum_partials_reference(t, 16), sm.sum_partials_reference(t, 1))


@pytest.mark.parametrize("n_blocks", [1, 2, 7, 16, 132, 133, 264])
def test_row_groups_split_rows_contiguously(n_blocks):
    split = sm.sum_partials_row_groups(n_blocks, sm.SUM_PARTIALS_GROUPS)
    assert len(split) == min(n_blocks, sm.SUM_PARTIALS_GROUPS)
    assert split[0][0] == 0 and split[-1][1] == n_blocks
    assert all(a[1] == b[0] for a, b in zip(split, split[1:]))
    sizes = [r1 - r0 for r0, r1 in split]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if the wrapper reaches the library or nvcc."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "_nvcc", refuse)


@pytest.mark.parametrize("shape,dtype,match", [
    ((7, 1_000), torch.float32, "expected a tensor on"),  # a CPU tensor
    ((7, 1_002), torch.float32, "multiple of 4"),          # P = 4k + 2
    ((0, 8), torch.float32, "blocks >= 1"),
    ((8,), torch.float32, "blocks >= 1"),
    ((7, 1_000), torch.float64, "expected a tensor on"),
])
def test_sum_partials_raises_before_building(no_build, shape, dtype, match):
    before = sm.LAUNCHES["sum_partials"]
    with pytest.raises(ValueError, match=match):
        sm.sum_partials(torch.zeros(shape, dtype=dtype))
    assert sm.LAUNCHES["sum_partials"] == before
