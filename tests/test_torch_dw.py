"""The backward's dW paths on the CPU: the row split of the layer-wise
sine_mlp_layer_dw and its plain version, the width-192 backward's tiled dW
order (a plain mirror against the plain chain, the JAX package and the
Pallas kernels in interpret mode) and its pieces' positions; and the
knock-out tool's replacements against the current kernel source.

The kernels themselves run only on the card (tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.ops.sine_mlp import siren_apply_flat_pallas
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import cuda_build
from implicit_image_tpu_torch.ops import sine_mlp as sm
from implicit_image_tpu_torch.tools import kernel_breakdown

torch.set_num_threads(1)

# fp32 limit of the card (chip_smoke.py BWD_TOL): max abs error / max |ref|
FP32_REL_TOL = 1e-4


@pytest.mark.parametrize("n", [1, 63, 4099, 262_144])
@pytest.mark.parametrize("splits", [1, 7, 132])
def test_dw_row_splits_cover_rows_in_order(n, splits):
    ranges = sm.dw_row_splits(n, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (_, stop), (start, _) in zip(ranges, ranges[1:]):
        assert stop == start
    sizes = [r1 - r0 for r0, r1 in ranges]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("layers,n,hidden,splits", [
    (2, 4099, 192, 7), (1, 1000, 256, 132), (3, 300, 512, 1)])
def test_dw_reference_sums_to_the_float64_product(layers, n, hidden, splits):
    """layer_dw_reference (sine_mlp_layer_dw's plain version) summed by
    sum_partials_reference is A^T G: fp32 sums of at most 4,099 products,
    held to the card's fp32 limit."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (layers, n, hidden)).astype(np.float32)
    g = (rng.standard_normal((layers, n, hidden)) / n).astype(np.float32)
    parts = sm.layer_dw_reference(torch.from_numpy(a), torch.from_numpy(g), splits)
    assert tuple(parts.shape) == (splits, layers, hidden, hidden)
    got = sm.sum_partials_reference(parts).double().numpy()
    want = np.einsum("lni,lnj->lij", a.astype(np.float64), g.astype(np.float64))
    assert np.abs(got - want).max() <= FP32_REL_TOL * np.abs(want).max()


def test_dw_reference_bf16_rounds_its_operands():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(-1, 1, (1, 50, 192)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 50, 192)).astype(np.float32))
    rnd = [t.to(torch.bfloat16).float() for t in (a, g)]
    torch.testing.assert_close(sm.layer_dw_reference(a, g, 3, "bf16"),
                               sm.layer_dw_reference(*rnd, 3, "fp32"), rtol=0, atol=0)


def _setup(depth, hidden, seed=0):
    jm, jc = jbuild("siren", depth=depth, hidden_size=hidden)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    coords = np.array(jgrid(16, 16)).reshape(-1, 2)
    target = np.random.default_rng(seed + 1).uniform(size=(coords.shape[0], 3)).astype(
        np.float32)
    _, c = build_model("siren", depth=depth, hidden_size=hidden)
    return jm, jc, c, p, coords, target


def _chain_cotangent(tp, c, coords, target, precision):
    """x and the cotangent g of the chain output for the mean squared loss
    of siren_apply_flat_fused (output mapped by /2 + 0.5)."""
    x = (torch.from_numpy(coords) - 0.5) * 2.0
    out = sm.siren_chain_reference(tp, x, c, precision).requires_grad_(True)
    loss = ((out / 2.0 + 0.5 - torch.from_numpy(target)) ** 2).mean()
    return x, torch.autograd.grad(loss, out)[0]


# ------------------------------------- the width-192 backward's dW order
# The wgmma backward of kernel width 192 sums dW_l = a_{l-1}^T gz_l in the
# kernel: a block of a fixed grid takes tiles b, b + grid, ... of 64 rows,
# adds each tile's product into its partial slice in tile order (bulk
# reduce-adds, one add into a region at a time), and sum_partials adds the
# slices in its fixed order.

B2_TILE, B2_BLOCKS = sm.KERNEL_TILE_ROWS[192], 3  # 256 rows: 4 tiles, block 0 takes two


def _tiled_dw(a, gz, tile, blocks):
    """The mirror: a and gz (L, N, H) -> (blocks, L, H, H), block b's slice
    the fp32 sum, in tile order from 0, of a^T gz over its tiles' rows."""
    n = a.shape[1]
    parts = torch.zeros((blocks,) + (a.shape[0], a.shape[2], gz.shape[2]))
    for t in range(-(-n // tile)):
        rows = slice(t * tile, min(n, (t + 1) * tile))
        parts[t % blocks] = parts[t % blocks] + a[:, rows].transpose(1, 2) @ gz[:, rows]
    return parts


def _mirror_dw192(tp, c, x, g, precision):
    h = tp[0]["w"].shape[1]
    pad = sm.kernel_width(h) - h
    a, gz = (F.pad(t, (0, pad)) for t in sm.siren_chain_dw_operands(tp, x, g, c, precision))
    dw = sm.sum_partials_reference(_tiled_dw(a, gz, B2_TILE, B2_BLOCKS))
    return dw[:, :h, :h]


def test_fp32_mirror_of_the_width_192_dw_order_matches_the_chain_and_jax():
    """d4/w182 (kernel width 192) on 256 rows: the tiled mirror's hidden dW
    against siren_chain_backward_reference and JAX XLA fp32, at the card's
    fp32 limit (FP32_REL_TOL of the largest |dW|)."""
    jm, jc, c, p, coords, target = _setup(4, 182)
    tp = params_from_jax(p, "cpu")
    x, g = _chain_cotangent(tp, c, coords, target, "fp32")
    dw = _mirror_dw192(tp, c, x, g, "fp32")
    _, grads = sm.siren_chain_backward_reference(tp, x, g, c, "fp32")
    jg = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc) - target) ** 2))(p)
    assert dw.shape[0] == 2
    for l in (1, 2):
        for ref in (grads[l]["w"].numpy(), np.asarray(jg[l]["w"])):
            got = dw[l - 1].numpy()
            assert np.abs(got - ref).max() <= FP32_REL_TOL * np.abs(ref).max(), l


def test_bf16_mirror_of_the_width_192_dw_order_matches_pallas_interpret():
    """d4/w182 in the bf16 mode against the Pallas kernels in interpret mode
    (their backward, _bwd_kernel, included), under the error rule of
    tests/test_torch_sine_mlp.py's bf16 tests: the mirror's error against
    exact fp32 is at most max(2.5x the Pallas kernel's, 0.02) of the
    largest |dW|, for each hidden layer."""
    jm, jc, c, p, coords, target = _setup(4, 182)
    tp = params_from_jax(p, "cpu")
    x, g = _chain_cotangent(tp, c, coords, target, "bf16")
    dw = _mirror_dw192(tp, c, x, g, "bf16")
    with pltpu.force_tpu_interpret_mode():
        gp = jax.grad(lambda q: jnp.mean((siren_apply_flat_pallas(q, coords, jc) - target) ** 2))(p)
    gf = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc, None) - target) ** 2))(p)
    for l in (1, 2):
        ref, pallas = np.asarray(gf[l]["w"]), np.asarray(gp[l]["w"])
        scale = float(np.abs(ref).max())
        err_mirror = float(np.abs(dw[l - 1].numpy() - ref).max()) / scale
        err_pallas = float(np.abs(pallas - ref).max()) / scale
        assert err_mirror < max(2.5 * err_pallas, 0.02), (l, err_mirror, err_pallas)


def test_width_192_dw_positions_are_the_pieces_in_thread_order():
    """The width-192 backward leaves dW[i][j] at dw_position_index(192)[i][j]
    of the layer's floats: piece (i / 64, j / 96) of 64 x 96, in the order
    its warpgroup's threads hold it (csrc b2_stage_at); a permutation, which
    the wrapper's _unturn_dw undoes."""
    idx = sm.dw_position_index(192)
    assert sorted(idx.reshape(-1).tolist()) == list(range(192 * 192))
    for i, j in ((0, 0), (5, 97), (64, 3), (130, 191), (71, 95)):
        piece = (i // 64) * 2 + j // 96
        pi, pj = i % 64, j % 96
        thread = 32 * (pi // 16) + 4 * (pi % 8) + (pj % 8) // 2
        slot = 2 * (pj // 8) + (pi % 16) // 8
        assert int(idx[i, j]) == piece * 6144 + (slot * 128 + thread) * 2 + pj % 2
    dw = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 192, 192)))
    kernel = torch.empty_like(dw).reshape(2, 4, -1)
    kernel.scatter_(-1, idx.reshape(-1).expand(kernel.shape), dw.reshape(2, 4, -1))
    assert torch.equal(sm._unturn_dw(kernel.reshape(dw.shape)), dw)


def test_kernel_breakdown_variants_apply_to_the_current_source():
    """Every replacement of the knock-out tool is found in csrc/sine_mlp.cu
    (variants() raises otherwise), and every variant changes the source."""
    src = (cuda_build.CSRC / "sine_mlp.cu").read_text()
    found = kernel_breakdown.variants(src)
    assert found["full"] == src
    assert {"no_mma", "no_stash", "no_partial", "no_ring_wait"} <= set(found)
    for name, text in found.items():
        assert (text == src) == (name == "full"), name


def test_kernel_breakdown_knockouts_reach_the_w192_forward():
    """The knock-outs of the width-192 forward on wgmma find its strings in
    csrc/sine_mlp.cu: no_mma guards its products, no_ring_wait gives its
    ring's copies barriers of their own and drains them at the kernel's end,
    no_sine reaches the sine it calls (b2_sine) and no_ring_copy its ring's
    fills."""
    src = (cuda_build.CSRC / "sine_mlp.cu").read_text()
    kb = kernel_breakdown
    for text in (kb.F2_SS, kb.F2_END, kb.RING_BAR, kb.RING_INIT, kb.RING_COPY):
        assert src.count(text) == 1, text
    found = kb.variants(src)
    assert "if (u == 12345) " + kb.F2_SS.lstrip() in found["no_mma"]
    assert kb.F2_END + kb.F2_DRAIN in found["no_ring_wait"]
    assert kb.F2_COPY + kb.RING_COPY in found["no_ring_wait"]
    assert kb.RING_BAR + kb.RING_LAND in found["no_ring_wait"]
    kernel = src[src.index("sine_mlp_fwd_wg192_kernel(Chain"):]
    assert "b2_sine<BF16, MX, false>(" in kernel
    sine = src[src.index("__device__ __forceinline__ void b2_sine("):]
    assert "iit::fast_sin(omega * z0)" in sine[:sine.index("\n}\n")]
    assert kb.RING_COPY not in found["no_ring_copy"]

