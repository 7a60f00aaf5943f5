"""Port parity: the SIREN model and the fused sine-MLP chain.

On the CPU the port's chain runs its plain-torch versions; they are held
against the JAX model (fp32) and against the Pallas kernel run in interpret
mode (bf16), on the same weights copied from the JAX init. The kernels
themselves are tested in test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.ops.sine_mlp import siren_apply_flat_pallas
from implicit_image_tpu_torch.convert import params_from_jax, params_to_numpy
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import sine_mlp as sm

torch.set_num_threads(1)

KEYS = ("w", "b")


def _setup(depth=4, hidden=32, hw=(12, 12), seed=0):
    jm, jc = jbuild("siren", depth=depth, hidden_size=hidden)
    np_params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    coords = np.array(jgrid(*hw)).reshape(-1, 2)
    target = np.random.default_rng(seed + 1).uniform(size=(coords.shape[0], 3)).astype(
        np.float32)
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    return jm, jc, m, c, np_params, coords, target


def _leaves(params, device="cpu"):
    tp = params_from_jax(params, device)
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    return tp


def _torch_grads(m, c, tp, coords, target, precision):
    out = m.apply_flat(tp, torch.from_numpy(coords), c, precision)
    loss = ((out - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    return out.detach().numpy(), [{k: layer[k].grad.numpy() for k in KEYS} for layer in tp]


def test_convert_round_trip():
    *_, np_params, _, _ = _setup()
    back = params_to_numpy(params_from_jax(np_params, "cpu"))
    for a, b in zip(back, np_params):
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k])


def test_siren_init_bounds_and_shapes():
    m, c = build_model("siren", depth=5, hidden_size=24)
    params = m.init(torch.Generator().manual_seed(0), c)
    assert [tuple(p["w"].shape) for p in params] == [tuple(d) for d in c.layer_dims]
    for i, layer in enumerate(params):
        assert float(layer["w"].abs().max()) <= c.weight_bound(i)
        assert float(layer["b"].abs().max()) <= 1.0 / np.sqrt(c.layer_dims[i][0])


def _check_fp32_against_jax(**setup):
    jm, jc, m, c, p, coords, target = _setup(**setup)
    tp = _leaves(p)
    out, grads = _torch_grads(m, c, tp, coords, target, "fp32")
    np.testing.assert_allclose(out, np.asarray(jm.apply_flat(p, coords, jc)), atol=2e-5)
    jg = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc) - target) ** 2))(p)
    for a, b in zip(grads, jg):
        for k in KEYS:
            ref = np.asarray(b[k])
            assert np.abs(a[k] - ref).max() <= 1e-4 * np.abs(ref).max(), k


def test_fp32_forward_and_grads_match_jax():
    _check_fp32_against_jax()


@pytest.mark.parametrize("depth,hidden", [(3, 182), (4, 256)])
def test_fp32_wide_forward_and_grads_match_jax(depth, hidden):
    """Widths above 128 (the reference's finals width 182, and 256; the card
    pads them to its kernel widths 192 and 256): the plain chain against
    JAX XLA fp32 on 256 pixels, at the same limits."""
    _check_fp32_against_jax(depth=depth, hidden=hidden, hw=(16, 16))


def test_siren_apply_grid_matches_flat():
    _, _, m, c, p, coords, _ = _setup()
    tp = params_from_jax(p, "cpu")
    grid = torch.from_numpy(coords).reshape(12, 12, 2)
    np.testing.assert_array_equal(m.apply(tp, grid, c).reshape(-1, 3).numpy(),
                                  m.apply_flat(tp, grid.reshape(-1, 2), c).numpy())


def _check_bf16_against_pallas(**setup):
    jm, jc, m, c, p, coords, target = _setup(**setup)
    with pltpu.force_tpu_interpret_mode():
        pallas_out = np.asarray(siren_apply_flat_pallas(p, coords, jc))
    tp = _leaves(p)
    out, grads = _torch_grads(m, c, tp, coords, target, "bf16")
    np.testing.assert_allclose(out, pallas_out, atol=8e-3)

    gx = jax.grad(lambda q: jnp.mean(
        (jm.apply_flat(q, coords, jc, jnp.bfloat16) - target) ** 2))(p)
    gf = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc, None) - target) ** 2))(p)
    for a, b, f in zip(grads, gx, gf):
        for k in KEYS:
            scale = float(np.abs(np.asarray(f[k])).max()) + 1e-12
            err_port = float(np.abs(a[k] - np.asarray(f[k])).max()) / scale
            err_xla = float(np.abs(np.asarray(b[k]) - np.asarray(f[k])).max()) / scale
            assert err_port < max(2.5 * err_xla, 0.02), (k, err_port, err_xla)


def test_bf16_chain_matches_pallas_interpret():
    """The bf16 mode computes what the Pallas kernel computes: forward within
    the 8e-3 bound of tests/test_pallas.py, gradients under its error rule
    (error vs exact fp32 at most max(2.5x the XLA-bf16 path's, 0.02))."""
    _check_bf16_against_pallas()


def test_bf16_wide_chain_matches_pallas_interpret():
    """The same at the finals width 182 (depth 3, 256 pixels): the Pallas
    kernel pads it to 256 lanes, the card to 192, zero units either way."""
    _check_bf16_against_pallas(depth=3, hidden=182, hw=(16, 16))


def test_bf16_coordinate_gradient_nonzero_and_close():
    jm, jc, m, c, p, coords, _ = _setup()
    tp = params_from_jax(p, "cpu")
    x = torch.from_numpy(coords).requires_grad_(True)
    (m.apply_flat(tp, x, c, "bf16") ** 2).sum().backward()
    gp = x.grad.numpy()
    gf = np.asarray(jax.grad(lambda cc: jnp.sum(jm.apply_flat(p, cc, jc, None) ** 2))(
        jnp.asarray(coords)))
    gx = np.asarray(jax.grad(lambda cc: jnp.sum(
        jm.apply_flat(p, cc, jc, jnp.bfloat16) ** 2))(jnp.asarray(coords)))
    assert np.abs(gp).max() > 0.0
    scale = np.abs(gf).max() + 1e-12
    err_port = np.abs(gp - gf).max() / scale
    err_xla = np.abs(gx - gf).max() / scale
    assert err_port < max(2.5 * err_xla, 0.02), (err_port, err_xla)


def test_backward_reference_matches_autograd():
    """fp32: the hand-written backward (derivative of sin via fast_cos) is
    autograd of the plain forward (derivative of the sine polynomial) to
    1e-5. (In bf16 autograd passes cotangents through the roundings
    unrounded, so the two are different computations there.)"""
    precision = "fp32"
    _, _, _, c, p, coords, target = _setup()
    tp = _leaves(p)
    x = ((torch.from_numpy(coords) - 0.5) * 2.0).requires_grad_(True)
    g = torch.from_numpy(target)
    out = sm.siren_chain_reference(tp, x, c, precision)
    leaves = [x] + [layer[k] for layer in tp for k in KEYS]
    auto = torch.autograd.grad((out * g).sum(), leaves)
    detached = [{k: v.detach() for k, v in layer.items()} for layer in tp]
    dx, grads = sm.siren_chain_backward_reference(detached, x.detach(), g, c, precision)
    ours = [dx] + [layer[k] for layer in grads for k in KEYS]
    for a, b in zip(ours, auto):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_cpu_function_is_the_plain_chain(precision):
    _, _, _, c, p, coords, target = _setup(depth=3, hidden=16)
    tp = _leaves(p)
    out = sm.siren_apply_flat_fused(tp, torch.from_numpy(coords), c, precision)
    plain = sm.siren_chain_reference(tp, (torch.from_numpy(coords) - 0.5) * 2.0, c, precision)
    torch.testing.assert_close(out, plain / 2.0 + 0.5, rtol=0, atol=0)
    before = dict(sm.LAUNCHES)
    out.sum().backward()
    assert sm.LAUNCHES == before  # the CPU path launches nothing


def test_depth_two_chain():
    jm, jc, m, c, p, coords, target = _setup(depth=2, hidden=8)
    tp = _leaves(p)
    out, _ = _torch_grads(m, c, tp, coords, target, "fp32")
    np.testing.assert_allclose(out, np.asarray(jm.apply_flat(p, coords, jc)), atol=2e-5)


@pytest.mark.parametrize("h,want", [(1, 128), (57, 128), (128, 128), (129, 192),
                                    (182, 192), (192, 192), (193, 256), (256, 256),
                                    (257, 384), (512, 512)])
def test_kernel_width_pads_to_the_next_kernel_width(h, want):
    """1-128 at 128 and 129-192 at 192 (the fused kernels, one activation
    tile of at most 64 KB), above 192 the next multiple of 128 (the
    layer-wise kernels, tiles of LAYER_TILE rows)."""
    assert sm.kernel_width(h) == want
    if want in sm.KERNEL_TILE_ROWS:
        assert sm.KERNEL_TILE_ROWS[want] * want <= 128 * 128
    else:
        assert want > sm.KERNEL_WIDTHS[-1] and want % sm.LAYER_TILE == 0


@pytest.mark.parametrize("h", [0, -1, -576])
def test_kernel_width_outside_the_kernels_raises(h):
    """Only a width below 1 has no kernel: every width above 192 runs on the
    layer-wise kernels (tests/test_torch_layer_kernels.py)."""
    with pytest.raises(NotImplementedError, match="1-128 at 128, 129-192 at 192 and above 192 "
                                                  "at the next multiple of 128"):
        sm.kernel_width(h)


@pytest.mark.parametrize("h,want", [(193, 256), (300, 384), (385, 512), (513, 640), (576, 640),
                                    (640, 640), (641, 768), (1024, 1024), (2048, 2048)])
def test_kernel_width_above_512_pads_to_a_multiple_of_128(h, want):
    """Above 192 (and so above 512) the kernel width is h rounded up to a
    multiple of 128."""
    assert sm.kernel_width(h) == want


# ------------------------------------------- split-precision product design
# The CUDA kernels run the hidden layers' products on the tensor cores. In
# the fp32 mode each product is 3xTF32: every operand x is split into
# hi = tf32(x) and lo = tf32(x - hi) and the product is hi·hi + hi·lo + lo·hi
# with fp32 accumulation. These tests emulate the splits on the CPU (the
# rounded parts multiplied in float64) on the d8/w128 chain and hold each
# scheme to the fp32 mode's limits on the card (1e-4 forward max abs, 1e-4
# backward max rel): 3xTF32 must pass with a margin of 10, 1-pass TF32 and
# 3xbf16 (what `tensorfloat32` meant on the TPU) must not. "3xtf32" is the
# forward kernels' own split (hi and lo both rounded to nearest); "6xbf16"
# the width-128 backward's on bf16 wgmma: three bf16 planes of each operand
# (h = bf16(x), m = bf16(x - h), l = bf16(x - h - m)) and the six products
# whose planes' orders add up to at most 2 (hh, hm, mh, hl, lh, mm).

_FP32_FWD_TOL, _FP32_BWD_TOL = 1e-4, 1e-4


def _round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Round float32 to `bits` explicit mantissa bits, nearest even
    (10 for TF32, 7 for bf16)."""
    drop = 23 - bits
    i = t.float().contiguous().view(torch.int32)
    i = i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)
    return (i & ~((1 << drop) - 1)).view(torch.float32)


def _planes(t: torch.Tensor, n: int):
    """The n bf16 planes of t: plane p rounds what planes 0 .. p-1 leave."""
    out, rest = [], t.float()
    for _ in range(n):
        out.append(_round_mantissa(rest, 7))
        rest = rest - out[-1]
    return out


def _product(scheme: str, k_group: int = 0):
    """The product of a scheme. k_group: K summed in groups of that many from
    zero (each group's passes in float64, rounded to fp32), the groups added
    in order by fp32 adds, as the layer-wise wgmma kernels sum them."""
    if scheme == "fp32":
        return lambda a, b: a @ b
    if scheme == "6xbf16":
        def mm6(a, b):
            pa, pb = _planes(a, 3), _planes(b, 3)

            def part(lo, hi):
                return sum(pa[i][:, lo:hi].double() @ pb[j][lo:hi].double()
                           for i in range(3) for j in range(3) if i + j <= 2).float()

            k = a.shape[1]
            step = k_group or k
            out = part(0, step)
            for lo in range(step, k, step):
                out = out + part(lo, lo + step)
            return out

        return mm6
    bits, passes = {"3xtf32": (10, 3), "tf32": (10, 1), "3xbf16": (7, 3)}[scheme]

    def mm(a, b):
        ah, bh = _round_mantissa(a, bits), _round_mantissa(b, bits)
        out = ah.double() @ bh.double()
        if passes == 3:
            al, bl = _round_mantissa(a - ah, bits), _round_mantissa(b - bh, bits)
            out = out + ah.double() @ bl.double() + al.double() @ bh.double()
        return out.float()

    return mm


def _emulated_chain(params, x, g, om, mm, mm_dw=None):
    """Forward and backward of the chain with every product (a·W, aᵀ·gz,
    gz·Wᵀ) taken by `mm` (aᵀ·gz by `mm_dw` where given). The kernels keep
    the first layer (K = in) and the last (N = out) on fp32 FMA, so for them
    this bounds the error from above."""
    from implicit_image_tpu_torch.ops.fast_math import fast_cos, fast_sin

    mm_dw = mm_dw or mm
    n = len(params)
    zs, a = [], x
    for i in range(n - 1):
        z = mm(a, params[i]["w"]) + params[i]["b"]
        zs.append(z)
        a = fast_sin(om[i] * z)
    out = mm(a, params[-1]["w"]) + params[-1]["b"]
    grads = [None] * n
    grads[-1] = {"w": mm_dw(a.t(), g), "b": g.sum(0)}
    ga = mm(g, params[-1]["w"].t())
    for i in range(n - 2, -1, -1):
        gz = ga * (om[i] * fast_cos(om[i] * zs[i]))
        a_prev = x if i == 0 else fast_sin(om[i - 1] * zs[i - 1])
        grads[i] = {"w": mm_dw(a_prev.t(), gz), "b": gz.sum(0)}
        ga = mm(gz, params[i]["w"].t())
    return out, ga, grads


def _split_errors(hidden=128, n=4099):
    """(forward max abs, backward max rel) of each scheme against the fp32
    chain: a d8 SIREN init of width `hidden`, n pixels."""
    _, _, _, c, np_params, _, _ = _setup(depth=8, hidden=hidden, hw=(2, 2), seed=3)
    params = params_from_jax(np_params, "cpu")
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((n, 3)) / n).astype(np.float32))
    om = [float(c.first_omega_0)] + [float(c.hidden_omega_0)] * (len(params) - 1)
    ref = _emulated_chain(params, x, g, om, _product("fp32"))

    def errors(scheme):
        if scheme == "6xbf16 grouped":  # the layer-wise kernels' sums
            mms = (_product("6xbf16", LAYER_K_GROUP), _product("6xbf16", LAYER_ROW_GROUP))
        else:
            mms = (_product(scheme),)
        out, dx, grads = _emulated_chain(params, x, g, om, *mms)
        pairs = [(dx, ref[1])] + [(grads[i][k], ref[2][i][k])
                                  for i in range(len(params)) for k in KEYS]
        rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)
        return float((out - ref[0]).abs().max()), rel

    return errors


@pytest.fixture(scope="module")
def split_errors():
    """The d8/w128 chain on 4,099 pixels."""
    return _split_errors()


def test_round_mantissa_is_nearest_even():
    # 1 + 2^-11 is halfway between two TF32 values: ties go to the even one
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-12, -1.0 - 2.0**-9])
    np.testing.assert_array_equal(
        _round_mantissa(x, 10).numpy(),
        np.array([1.0, 1.0 + 2.0**-9, 1.0, -1.0 - 2.0**-9], np.float32))
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_round_mantissa(y, 7).numpy(),
                                  y.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("scheme,passes", [
    ("3xtf32", True), ("tf32", False), ("3xbf16", False), ("6xbf16", True)])
def test_split_precision_against_fp32_limits(split_errors, scheme, passes):
    fwd, bwd = split_errors(scheme)
    if passes:
        assert fwd * 10 <= _FP32_FWD_TOL and bwd * 10 <= _FP32_BWD_TOL, (fwd, bwd)
    elif scheme == "tf32":
        assert fwd > _FP32_FWD_TOL and bwd > _FP32_BWD_TOL, (fwd, bwd)
    else:
        assert bwd > _FP32_BWD_TOL, (fwd, bwd)


# the layer-wise wgmma kernels (widths above 192) sum the chain products' K
# in groups of 128 (LW_K_GROUP x LW_KC of csrc/sine_mlp.cu) and dW's rows in
# groups of 1,024 (LW_DW_GROUP x LW_KC), each group from zero
LAYER_K_GROUP, LAYER_ROW_GROUP = 128, 1024


@pytest.mark.parametrize("scheme,passes", [("3xtf32", True), ("tf32", False), ("6xbf16", True),
                                           ("6xbf16 grouped", True)])
@pytest.mark.parametrize("hidden,n", [(256, 1000), (512, 400), (192, 1500), (640, 300),
                                      (1024, 160), (2048, 48)])
def test_split_precision_at_wide_widths(hidden, n, scheme, passes):
    """The error of a product grows with its depth K: at d8 with K = 192,
    256 and 512 (the fused kernels' widths up to 512 once, 3xTF32 their
    forward's split) and "6xbf16" (the width-192 backward's) still pass the
    fp32 mode's limits, with the margin of 10 of width 128, and 1-pass TF32
    still fails both. So do they at K = 640, 1024 and 2048 (the layer-wise
    kernels, every width above 192 now,
    whose hidden forward and dW are "6xbf16" with K summed in groups of 128
    and dW's rows in groups of 1,024: "6xbf16 grouped"; their backward's
    gz·Wᵀ stays 3xTF32)."""
    fwd, bwd = _split_errors(hidden, n)(scheme)
    if passes:
        assert fwd * 10 <= _FP32_FWD_TOL and bwd * 10 <= _FP32_BWD_TOL, (fwd, bwd)
    else:
        assert fwd > _FP32_FWD_TOL and bwd > _FP32_BWD_TOL, (fwd, bwd)


def _wgmma192_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the width-192 wgmma kernels sum it (K padded to a multiple of
    16): k-steps of 16 in ascending order, in each the six plane passes in
    the order s = 2 .. 0, i = 0 .. s (planes i of a and s - i of b), each
    pass's 16 exact products summed (float64) and added into the fp32
    accumulator."""
    pa, pb = _planes(a, 3), _planes(b, 3)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for lo in range(0, a.shape[1], 16):
        for s in (2, 1, 0):
            for i in range(s + 1):
                part = pa[i][:, lo:lo + 16].double() @ pb[s - i][lo:lo + 16].double()
                acc = (acc.double() + part).float()
    return acc


def test_w192_forward_6xbf16_in_kernel_order_matches_jax():
    """The width-192 forward's hidden products ("6xbf16" in its k-step and
    pass order, the width 182 zero-padded to 192; the first and last layers
    in fp32) on the d8/w182 chain hold the output within the fp32 mode's
    limit of the JAX package's fp32 forward, 1e-4 of max |out|, with the
    margin of 10 of the cases above."""
    from implicit_image_tpu_torch.ops.fast_math import fast_sin

    jm, jc, _, c, np_params, _, _ = _setup(depth=8, hidden=182, hw=(2, 2), seed=5)
    params = params_from_jax(np_params, "cpu")
    coords = np.random.default_rng(13).uniform(0.0, 1.0, (4099, 2)).astype(np.float32)
    want = np.asarray(jm.apply_flat(np_params, coords, jc))
    pad = 192 - 182
    om = [float(c.first_omega_0)] + [float(c.hidden_omega_0)] * (len(params) - 1)
    a = (torch.from_numpy(coords) - 0.5) * 2.0
    for i, layer in enumerate(params[:-1]):
        w = torch.nn.functional.pad(layer["w"], (0, pad, 0, pad if i else 0))
        b = torch.nn.functional.pad(layer["b"], (0, pad))
        z = (a @ w if i == 0 else _wgmma192_product(a, w)) + b
        a = fast_sin(om[i] * z)
    w_last = torch.nn.functional.pad(params[-1]["w"], (0, 0, 0, pad))
    out = ((a @ w_last + params[-1]["b"]) / 2.0 + 0.5).numpy()
    err = float(np.abs(out - want).max())
    assert err * 10 <= _FP32_FWD_TOL * float(np.abs(want).max()), err


# ------------------------------------ the width-128 backward's packed weights


def _check_weight_planes(planes, h):
    """ops/sine_mlp.weight_planes at width h (the wrapper's operand
    preparation for the wgmma kernels): plane p is _round_mantissa(W -
    planes 0 .. p-1, 7), three planes add up to W exactly, and each slice
    holds W's rows (image 0) or columns (image 1) in 8 x 8 core matrices of
    8 consecutive columns."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((2, 3, h, h)).astype(np.float32) / 11)
    packed = sm.weight_planes(w, planes)
    assert packed.dtype == torch.bfloat16
    rows = sm._RING_ROWS
    assert tuple(packed.shape) == (2, 2, 3, h // rows, planes, rows // 8, h // 8, 8, 8)
    want = _planes(w, planes)
    if planes == 3:
        assert torch.equal(want[0] + want[1] + want[2], w)
    # image, layer, slice, plane, K group, N group, row, column
    u, kg, ng, r, c = np.meshgrid(*(np.arange(k) for k in (h // rows, rows // 8, h // 8, 8, 8)),
                                  indexing="ij")
    for p in range(planes):
        fwd = want[p][..., rows * u + 8 * kg + r, 8 * ng + c]
        bwd = want[p][..., 8 * ng + r, rows * u + 8 * kg + c]
        assert torch.equal(packed[:, 0, :, :, p].float(), fwd)
        assert torch.equal(packed[:, 1, :, :, p].float(), bwd)


@pytest.mark.parametrize("planes", [1, 3])
def test_weight_planes_are_the_round_mantissa_planes_in_the_rings_layout(planes):
    """At width 128 (the forward and backward of that width)."""
    _check_weight_planes(planes, 128)


@pytest.mark.parametrize("planes", [1, 3])
def test_weight_planes_at_width_192(planes):
    """At width 192 (the width-192 backward): 12 slices of each image, 24
    N groups of core matrices a plane."""
    _check_weight_planes(planes, 192)


@pytest.mark.parametrize("shape", [(2, 256, 256), (2, 512, 512), (2, 130, 130), (2, 128, 192)])
def test_weight_planes_reject_other_widths(shape):
    with pytest.raises(ValueError, match="128, 192"):
        sm.weight_planes(torch.zeros(shape), 3)


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("h", [640, 1024])
def test_layer_weight_planes_in_the_layer_rings_layout(h, planes):
    """ops/sine_mlp.layer_weight_planes (the layer-wise hidden forward's W
    above width 512): plane p is _round_mantissa(W - planes 0 .. p-1, 7),
    three planes add up to W exactly, and chunk k of column tile c holds
    rows 32 k .. of W's columns 128 c .. in 4 x 16 core matrices of 8 x 8, 8
    consecutive columns a row (B N-major, csrc/hopper.cuh)."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((2, h, h)).astype(np.float32) / 13)
    packed = sm.layer_weight_planes(w, planes)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (2, h // 128, h // 32, planes, 4, 16, 8, 8)
    want = _planes(w, planes)
    if planes == 3:
        assert torch.equal(want[0] + want[1] + want[2], w)
        back = sum(packed[:, :, :, p].float() for p in range(3))
        rows = back.permute(0, 2, 3, 5, 1, 4, 6).reshape(2, h, h)  # (k, kg, r) x (c, ng, cc)
        assert torch.equal(rows, w)
    c, k, kg, ng, r, cc = np.meshgrid(*(np.arange(v) for v in (h // 128, h // 32, 4, 16, 8, 8)),
                                      indexing="ij")
    for p in range(planes):
        assert torch.equal(packed[:, :, :, p].float(),
                           want[p][:, 32 * k + 8 * kg + r, 128 * c + 8 * ng + cc])
    # one chunk (a bulk copy of the ring) is planes x 8 KB, contiguous
    assert packed[0, 0, 0].numel() * 2 == planes * 8192


@pytest.mark.parametrize("shape", [(2, 576, 576), (2, 640, 512), (64, 64)])
def test_layer_weight_planes_reject_other_shapes(shape):
    with pytest.raises(ValueError, match="multiple of 128"):
        sm.layer_weight_planes(torch.zeros(shape), 3)


def test_dw_turn_undoes_the_kernels_staging_turn():
    """The width-128 backward leaves dW[i][j] at column dw_turn_index[i][j]
    of row i (its 16-byte chunks turned by i % 8, csrc dw_stage_idx): a
    permutation of each row, which the wrapper's _unturn_dw undoes."""
    idx = sm.dw_turn_index()
    for i in (0, 1, 7, 8, 127):
        assert sorted(idx[i].tolist()) == list(range(128))
        for j in (0, 3, 4, 126):
            assert int(idx[i, j]) == (((j // 4 + i % 8) % 32) * 4 + j % 4)
    dw = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 128, 128)))
    turned = torch.empty_like(dw)
    turned.scatter_(-1, idx.expand(dw.shape), dw)
    assert torch.equal(sm._unturn_dw(turned), dw)

