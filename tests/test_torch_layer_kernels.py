"""Port parity at hidden widths above 192: the layer-wise kernels' widths,
their split of the sums and their plain versions.

On the CPU the port's chain runs its plain-torch versions; here they are
held against the JAX model (fp32, and XLA's bf16 chain for the bf16 mode)
at widths 256, 300 (kernel width 384), 512, 576, 640 and 1024, on weights
copied from the JAX init. The card
runs the same widths on the layer-wise kernels (csrc/sine_mlp.cu, "the
layer-wise kernels"), which tests/test_torch_kernels.py and chip_smoke.py
hold against these plain versions. Also here: the width rule over 1-4096,
the kernels' split of the rows into slices and dW splits (their plain
mirror, `siren_chain_layer_partials`, against the plain backward), and the
member axis at width 640 against the members' single fits.

Tolerances: fp32 as tests/test_torch_sine_mlp.py (forward 2e-5 absolute,
gradients 1e-4 of each leaf's largest magnitude); bf16 forward within 8e-3
of XLA's bf16 chain, gradients under tests/test_torch_sine_mlp.py's rule
(error against exact fp32 at most max(2.5 x XLA-bf16's, 0.02)); the
mirror's split sums within 2e-6 of the plain backward in fp32 (sums in
another order), 5e-3 in bf16 (the padded products may add in another order,
which can move an activation's bf16 rounding by one step) and 1e-2 under
"+mixed" (the bf16 rounding of the result too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid, synthetic_image
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import sine_mlp as sm
from implicit_image_tpu_torch.ops.fast_math import fast_cos, fast_sin
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)

KEYS = ("w", "b")


def _setup(depth, hidden, side=12, seed=0):
    jm, jc = jbuild("siren", depth=depth, hidden_size=hidden)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    coords = np.array(jgrid(side, side)).reshape(-1, 2)
    target = np.random.default_rng(seed + 1).uniform(size=(coords.shape[0], 3)).astype(
        np.float32)
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    return jm, jc, m, c, p, coords, target


def _torch_grads(m, c, p, coords, target, precision):
    tp = params_from_jax(p, "cpu")
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    out = m.apply_flat(tp, torch.from_numpy(coords), c, precision)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    return out.detach().numpy(), [{k: layer[k].grad.numpy() for k in KEYS} for layer in tp]


@pytest.mark.parametrize("depth,hidden", [(4, 256), (3, 300), (3, 512), (4, 576), (3, 640),
                                          (3, 1024)])
def test_wide_fp32_forward_and_grads_match_jax(depth, hidden):
    """The chain above 192 (300 runs as kernel width 384, 576 and 640 as
    640 on the card) against JAX XLA fp32 on 144 pixels."""
    jm, jc, m, c, p, coords, target = _setup(depth, hidden)
    out, grads = _torch_grads(m, c, p, coords, target, "fp32")
    np.testing.assert_allclose(out, np.asarray(jm.apply_flat(p, coords, jc)), atol=2e-5)
    jg = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc) - target) ** 2))(p)
    for a, b in zip(grads, jg):
        for k in KEYS:
            ref = np.asarray(b[k])
            assert np.abs(a[k] - ref).max() <= 1e-4 * np.abs(ref).max(), k


@pytest.mark.parametrize("depth,hidden", [(4, 256), (3, 300), (3, 512), (3, 576), (3, 640),
                                          (3, 1024)])
def test_wide_bf16_forward_and_grads_match_jax(depth, hidden):
    """The bf16 mode above 192 against JAX's bf16 chain (XLA,
    compute_dtype=bfloat16 products, f32 accumulation): forward within
    8e-3, gradients under the error rule against exact fp32."""
    jm, jc, m, c, p, coords, target = _setup(depth, hidden, seed=1)
    out, grads = _torch_grads(m, c, p, coords, target, "bf16")
    np.testing.assert_allclose(out, np.asarray(jm.apply_flat(p, coords, jc, jnp.bfloat16)),
                               atol=8e-3)
    gx = jax.grad(lambda q: jnp.mean(
        (jm.apply_flat(q, coords, jc, jnp.bfloat16) - target) ** 2))(p)
    gf = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc, None) - target) ** 2))(p)
    for a, b, f in zip(grads, gx, gf):
        for k in KEYS:
            scale = float(np.abs(np.asarray(f[k])).max()) + 1e-12
            err_port = float(np.abs(a[k] - np.asarray(f[k])).max()) / scale
            err_xla = float(np.abs(np.asarray(b[k]) - np.asarray(f[k])).max()) / scale
            assert err_port < max(2.5 * err_xla, 0.02), (k, err_port, err_xla)


def test_kernel_width_from_1_to_4096():
    """Every width runs: up to 192 on the first fused kernel width at or
    above it (128, 192), above on the layer-wise kernels at the next
    multiple of 128; the kernel width never adds more than 127 units above
    192."""
    assert sm.KERNEL_WIDTHS == (128, 192)
    for h in range(1, 4097):
        got = sm.kernel_width(h)
        if h <= sm.KERNEL_WIDTHS[-1]:
            assert got == next(k for k in sm.KERNEL_WIDTHS if h <= k), h
        else:
            assert got % sm.LAYER_TILE == 0 and h <= got < h + sm.LAYER_TILE, h


@pytest.mark.parametrize("n,hidden,sms", [(262144, 256, 132), (262144, 384, 132),
                                          (262144, 512, 132), (262144, 640, 132),
                                          (262144, 1024, 132), (262144, 2048, 132),
                                          (300, 640, 132), (1, 4096, 132),
                                          (262144, 16896, 132)])
def test_layer_slices_fill_one_wave_and_cover_the_rows(n, hidden, sms):
    """At most SMs / (H / 128) slices (one wave of (slice, column tile)
    blocks), at most one per 128-row tile, at least 1; their row ranges
    cover [0, n) in order, each at least one tile (the kernels store a
    slice's sums at its first tile)."""
    s = sm.layer_slices(n, hidden, sms)
    tiles = -(-n // sm.LAYER_TILE)
    assert 1 <= s <= max(1, min(tiles, sms // (hidden // sm.LAYER_TILE)))
    if n == 262144 and hidden <= 512:  # one wave of 132 blocks at the former fused widths
        assert s == {256: 66, 384: 44, 512: 33}[hidden]
    rows = sm.layer_slice_rows(n, s)
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(r1 > r0 for r0, r1 in rows)


def test_layer_band_rows_bound_the_forward_buffers():
    for hidden, members in ((640, 1), (2048, 1), (1024, 8), (8192, 64)):
        band = sm.layer_band_rows(hidden, members)
        assert band % sm.LAYER_TILE == 0 and band >= sm.LAYER_TILE
        assert band == sm.LAYER_TILE or 2 * band * hidden * members <= 1 << 28


@pytest.mark.parametrize("precision,tol", [("fp32", 2e-6), ("bf16", 5e-3),
                                           ("fp32+mixed", 1e-2)])
@pytest.mark.parametrize("depth,hidden,n,slices", [(4, 256, 300, 3), (3, 300, 260, 2),
                                                   (2, 512, 200, 2), (4, 576, 300, 3),
                                                   (2, 640, 200, 2), (3, 1024, 257, 1)])
def test_layer_partials_mirror_sums_to_the_plain_backward(precision, tol, depth, hidden, n,
                                                          slices):
    """The layer-wise backward's split of the sums (`siren_chain_layer_
    partials`: dW_0, the biases and the last layer per row slice, each
    hidden dW per dw_row_splits split), added in sum_partials' order, is
    the plain backward's gradients at the kernel width (padded units 0)."""
    m, c = build_model("siren", depth=depth, hidden_size=hidden)
    p = m.init(torch.Generator().manual_seed(0), c)
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((n, 2), generator=gen) * 2 - 1
    g = torch.randn((n, 3), generator=gen)
    _, grads = sm.siren_chain_backward_reference(p, x, g, c, precision)
    part = sm.siren_chain_layer_partials(p, x, g, c, precision, slices)
    wide = sm.kernel_width(hidden)
    sizes = (2 * wide, (depth - 2) * wide * wide, wide * 3, (depth - 1) * wide, 3)
    assert part.shape == (slices, -(-sum(sizes) // 4) * 4)
    flat = sm.sum_partials_reference(part)
    if precision.endswith(sm.MIXED):
        flat = flat.to(torch.bfloat16).float()
    ours = sm._split_grads(flat, (), sizes, depth, 2, wide, hidden, 3, turned=False)
    for a, b in zip(ours, grads):
        for k in KEYS:
            assert float((a[k] - b[k]).abs().max()) <= tol * float(b[k].abs().max()), k
    # the padded units' dW_m rows and columns are exactly 0
    dwm = part[:, sizes[0]: sizes[0] + sizes[1]].reshape(slices, depth - 2, wide, wide)
    assert float(dwm[..., hidden:, :].abs().sum()) == 0.0
    assert float(dwm[..., :, hidden:].abs().sum()) == 0.0


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_layer_dw_operands_and_split_dw_at_640(precision):
    """dW_l's operands as the layer-wise backward leaves them (A_l over
    z_{l-1}, G_l in its buffer) and their split sum (layer_dw_reference,
    sine_mlp_layer_dw's) give the plain backward's hidden dW."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    p = m.init(torch.Generator().manual_seed(2), c)
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((260, 2), generator=gen) * 2 - 1
    g = torch.randn((260, 3), generator=gen)
    a, gz = sm.siren_chain_dw_operands(p, x, g, c, precision)
    assert a.shape == gz.shape == (2, 260, 640)
    dw = sm.sum_partials_reference(sm.layer_dw_reference(a, gz, 3, precision))
    _, grads = sm.siren_chain_backward_reference(p, x, g, c, precision)
    for l in (1, 2):
        ref = grads[l]["w"]
        assert float((dw[l - 1] - ref).abs().max()) <= 2e-6 * float(ref.abs().max())


def test_member_axis_at_640_is_the_single_fits():
    """A 2-member batched fit at width 640 (16², d3, RigL, 6 steps) on the
    CPU: member i the single fit from member_generators(g, 2)[i], bit for
    bit (the plain chain runs each member on its own copies)."""
    from implicit_image_tpu_torch.parallel.batched import batched_fit, member_generators
    from implicit_image_tpu_torch.sparsity import MaskingConfig

    m, c = build_model("siren", depth=3, hidden_size=640)
    mk = MaskingConfig(density=0.5, end_when=4, interval=2)
    grid = get_grid(16, 16)
    imgs = np.stack([synthetic_image(16, 16, seed=s) for s in (0, 1)])
    tc, oc = TrainConfig(num_steps=6, log_steps=3), OptimConfig(lr=1e-3)
    res = batched_fit(torch.Generator().manual_seed(3), m, c, grid, imgs, tc, oc, mk,
                      device="cpu")
    gens = member_generators(torch.Generator().manual_seed(3), 2)
    for i in range(2):
        single = fit(gens[i], m, c, grid, imgs[i], tc, oc, mk)
        for a, b in zip(res.params, single.params):
            for k in b:
                assert torch.equal(a[k][i], b[k]), (i, k)
        np.testing.assert_array_equal(res.metrics["psnr"][i], single.metrics["psnr"])
        for a, b in zip(res.mask_state.masks, single.mask_state.masks):
            if b is not None:
                assert torch.equal(a[i], b)


def test_layer_dw_rejects_what_it_does_not_take_before_building():
    """sine_mlp_layer_dw raises ValueError, before the library is built, on
    a CPU tensor, on operands of two shapes, on a width that is not a
    multiple of 128, and on a region past the partial row; a CUDA tensor is
    the only thing it launches on."""
    a = torch.zeros((300, 640))
    part = torch.zeros((2, 640 * 640 + 8))
    with pytest.raises(ValueError, match="expected a tensor on"):
        sm.sine_mlp_layer_dw(a, a, part, 0, "fp32")
    with pytest.raises(ValueError, match="one shape"):
        sm.sine_mlp_layer_dw(a, a[:299], part, 0, "fp32")
    with pytest.raises(ValueError, match="multiple of 128"):
        sm.sine_mlp_layer_dw(a[:, :600], a[:, :600], part, 0, "fp32")
    with pytest.raises(ValueError, match="do not fit"):
        sm.sine_mlp_layer_dw(a, a, part, 16, "fp32")
    with pytest.raises(ValueError, match="more splits"):
        sm.sine_mlp_layer_dw(a, a, torch.zeros((4, 640 * 640 + 8)), 0, "fp32")


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
def test_layer_fwd_reference_is_the_chains_hidden_layer(precision):
    """layer_fwd_reference (the plain version of one hidden sine_mlp_layer_fwd
    launch) on the chain's a_0 and W_1, b_1 gives the chain's a_1 (the next
    layer's input, as siren_chain_dw_operands keeps it) bit for bit, in every
    mode; z is a_0 W_1 + b_1."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    p = m.init(torch.Generator().manual_seed(4), c)
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((200, 2), generator=gen) * 2 - 1
    g = torch.randn((200, 3), generator=gen)
    a, _ = sm.siren_chain_dw_operands(p, x, g, c, precision)
    bf16, mixed = sm.precision_modes(precision)
    layer = sm._rnd_params(p, mixed)[1]
    z, a1 = sm.layer_fwd_reference(a[0], layer["w"], layer["b"], float(c.hidden_omega_0),
                                   precision)
    assert torch.equal(a1, a[1])
    assert torch.equal(z, a[0] @ sm._rnd(layer["w"], bf16) + layer["b"])


def test_layer_fwd_rejects_what_it_does_not_take_before_building(monkeypatch):
    """sine_mlp_layer_fwd (one hidden layer) raises ValueError, before the
    library is built, on a CPU tensor, a width that is not a multiple of
    128, a bias or W of another width, and planes of another mode's count."""
    from implicit_image_tpu_torch.ops import cuda_build

    def refuse(*_args, **_kwargs):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "_nvcc", refuse)
    a, w, b = torch.zeros((300, 640)), torch.zeros((640, 640)), torch.zeros(640)
    with pytest.raises(ValueError, match="expected a tensor on"):
        sm.sine_mlp_layer_fwd(a, w, b, 30.0, "fp32")
    with pytest.raises(ValueError, match="multiple of 128"):
        sm.sine_mlp_layer_fwd(a[:, :600], w[:600, :600], b[:600], 30.0, "fp32")
    with pytest.raises(ValueError, match="multiple of 128"):
        sm.sine_mlp_layer_fwd(a, w, b[:600], 30.0, "fp32")
    with pytest.raises(ValueError, match="W"):
        sm.sine_mlp_layer_fwd(a, w[:512, :512], b, 30.0, "fp32")
    planes = sm._layer_planes(w[None], True, False)[0]  # one plane: the bf16 mode's
    with pytest.raises(ValueError, match="3 planes"):
        sm.sine_mlp_layer_fwd(a, planes, b, 30.0, "fp32")


def _chain_layers(p, c, x, g, precision):
    """The plain chain's backward walk at the model's width: its pre-
    activations z (recomputed as `_chain_backward` does), the params as it
    takes them, and per layer (a_prev, gzb, gz) (`_chain_backward`'s)."""
    bf16, mixed = sm.precision_modes(precision)
    params = sm._rnd_params(p, mixed)
    om = sm._omegas(c, len(params))
    a, zs = sm._rnd(x.float(), bf16 or mixed), []
    for i in range(len(params) - 1):
        zs.append(a @ sm._rnd(params[i]["w"], bf16) + params[i]["b"])
        a = sm._rnd(fast_sin(om[i] * zs[-1]), bf16 or mixed)
    layers = {}

    def layer(i, a_prev, gzb, gz):
        layers[i] = (a_prev, gzb, gz)

    sm._chain_backward(params, x, g, c, precision, layer)
    return params, om, zs, layers


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
def test_layer_bwd_reference_is_the_chains_hidden_layer(precision):
    """layer_bwd_reference (the plain version of one hidden sine_mlp_layer_bwd
    launch) on the chain's G_l, W_l and z_{l-1} gives the chain's G_{l-1},
    A_{l-1} (layer l's input), db_{l-1} and, at l = 1 with x, dW_0, bit for
    bit, at both hidden layers of a d4/w640 SIREN, in every mode."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    p = m.init(torch.Generator().manual_seed(9), c)
    gen = torch.Generator().manual_seed(10)
    x = torch.rand((200, 2), generator=gen) * 2 - 1
    g = torch.randn((200, 3), generator=gen)
    params, om, zs, layers = _chain_layers(p, c, x, g, precision)
    for l in (2, 1):
        gp, a, db, dw0 = sm.layer_bwd_reference(layers[l][1], params[l]["w"], zs[l - 1],
                                                om[l - 1], precision, x=x if l == 1 else None)
        assert torch.equal(gp, layers[l - 1][1]), l
        assert torch.equal(a, layers[l][0]), l
        assert torch.equal(db, layers[l - 1][2].sum(0)), l
        if l == 1:
            assert torch.equal(dw0, layers[0][0].t() @ layers[0][1])
        else:
            assert dw0 is None


@pytest.mark.parametrize("depth,hidden", [(4, 640), (3, 1024)])
def test_layer_bwd_reference_chain_matches_jax_grads(depth, hidden):
    """The layer-wise pieces' plain versions composed into the whole chain
    and backward, one per launch of each kind (layer_fwd_first_reference,
    layer_fwd_reference for each hidden layer, layer_fwd_last_reference;
    layer_bwd_last_reference, layer_bwd_reference for each hidden layer's
    G W^T and epilogue with dW_l = A_{l-1}^T G_l, layer_bwd_first_reference
    for dx) against JAX XLA fp32 on 144 pixels: the output within 2e-5,
    every gradient and the coordinates' within 1e-4 of its largest
    magnitude (the tolerances of test_wide_fp32_forward_and_grads_match_jax).
    The chain runs between siren_apply_flat's maps: x = 2 (coords - 0.5),
    out = chain / 2 + 0.5."""
    jm, jc, m, c, p, coords, target = _setup(depth, hidden, seed=2)
    tp = params_from_jax(p, "cpu")
    om = sm._omegas(c, depth)
    x = (torch.from_numpy(coords) - 0.5) * 2.0  # siren_apply_flat's input map
    z, a = sm.layer_fwd_first_reference(x, tp[0]["w"], tp[0]["b"], om[0])
    zs = [z]
    for l in range(1, depth - 1):
        z, a = sm.layer_fwd_reference(a, tp[l]["w"], tp[l]["b"], om[l])
        zs.append(z)
    out = sm.layer_fwd_last_reference(a, tp[-1]["w"], tp[-1]["b"]) / 2 + 0.5  # the output map
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply_flat(p, coords, jc)), atol=2e-5)
    g = (out - torch.from_numpy(target)) / out.numel()  # the loss's, through the output map
    grads = [{} for _ in range(depth)]
    gz, grads[depth - 2]["b"], grads[-1]["w"], grads[-1]["b"], _ = sm.layer_bwd_last_reference(
        g, tp[-1]["w"], zs[-1], om[depth - 2])
    for l in range(depth - 2, 0, -1):
        gp, a_prev, db, dw0 = sm.layer_bwd_reference(gz, tp[l]["w"], zs[l - 1], om[l - 1],
                                                     x=x if l == 1 else None)
        grads[l]["w"] = a_prev.t() @ gz
        grads[l - 1]["b"] = db
        gz = gp
    grads[0]["w"] = dw0
    dcoords = 2.0 * sm.layer_bwd_first_reference(gz, tp[0]["w"])  # through the input map

    def loss(q, cs):
        return jnp.mean((jm.apply_flat(q, cs, jc) - target) ** 2)

    jg, jc_grad = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(coords))
    for ours, ref in zip(grads, jg):
        for k in KEYS:
            want = np.asarray(ref[k])
            assert np.abs(ours[k].numpy() - want).max() <= 1e-4 * np.abs(want).max(), k
    want = np.asarray(jc_grad)
    assert np.abs(dcoords.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
def test_layer_fwd_kind_references_are_the_chains_layers(precision):
    """layer_fwd_first_reference and layer_fwd_last_reference (the plain
    versions of the forward's first- and last-layer launches) on the chain's
    x, a_L and weights give its z_0, a_0 and output bit for bit, at d4/w640,
    in every mode."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    p = m.init(torch.Generator().manual_seed(11), c)
    x = torch.rand((200, 2), generator=torch.Generator().manual_seed(12)) * 2 - 1
    _assert_fwd_kinds_are_the_chains(p, c, x, precision)


def _assert_fwd_kinds_are_the_chains(p, c, x, precision):
    bf16, mixed = sm.precision_modes(precision)
    params = sm._rnd_params(p, mixed)
    last = len(params) - 1
    om = sm._omegas(c, last + 1)
    out, zs = sm._chain_forward(p, x, c, precision, keep=True)
    z0, a0 = sm.layer_fwd_first_reference(x, params[0]["w"], params[0]["b"], om[0], precision)
    assert torch.equal(z0, zs[0])
    assert torch.equal(a0, sm._rnd(fast_sin(om[0] * zs[0]), bf16 or mixed))
    a_l = sm._rnd(fast_sin(om[last - 1] * zs[-1]), bf16 or mixed)
    assert torch.equal(sm.layer_fwd_last_reference(a_l, params[last]["w"], params[last]["b"],
                                                   precision), out)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("depth", [4, 2])
def test_layer_bwd_kind_references_are_the_chains_layers(precision, depth):
    """layer_bwd_last_reference and layer_bwd_first_reference (the plain
    versions of the backward's last- and first-layer launches) on the
    chain's g, z_L, G_0 and weights give its G_L, db_L, dW_{D-1}, db_{D-1}
    (and at depth 2, where the layer below the last is the first, dW_0) and
    dx bit for bit, at w640, in every mode."""
    m, c = build_model("siren", depth=depth, hidden_size=640)
    p = m.init(torch.Generator().manual_seed(13), c)
    gen = torch.Generator().manual_seed(14)
    x = torch.rand((200, 2), generator=gen) * 2 - 1
    g = torch.randn((200, 3), generator=gen)
    _assert_bwd_kinds_are_the_chains(p, c, x, g, precision)


def _assert_bwd_kinds_are_the_chains(p, c, x, g, precision):
    params, om, zs, layers = _chain_layers(p, c, x, g, precision)
    depth = len(params)
    last = depth - 1
    gl, db, dwl, dbl, dw0 = sm.layer_bwd_last_reference(g, params[last]["w"], zs[-1],
                                                        om[last - 1], precision,
                                                        x=x if depth == 2 else None)
    assert torch.equal(gl, layers[last - 1][1])
    assert torch.equal(db, layers[last - 1][2].sum(0))
    assert torch.equal(dwl, layers[last][0].t() @ layers[last][1])
    assert torch.equal(dbl, layers[last][2].sum(0))
    if depth == 2:
        assert torch.equal(dw0, layers[0][0].t() @ layers[0][1])
    else:
        assert dw0 is None
    dx = sm.layer_bwd_first_reference(layers[0][1], params[0]["w"], precision)
    assert torch.equal(dx, sm.siren_chain_backward_reference(p, x, g, c, precision)[0])


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("depth,in_size,out_size", [(4, 3, 6), (2, 3, 4)])
def test_layer_kind_references_at_other_counts_are_the_chains_layers(precision, depth, in_size,
                                                                     out_size):
    """The four kinds' plain versions at input and output counts other than
    an image's 2 and 3 (those whose launches run the streaming passes'
    guarded bodies) give the chain's z_0, a_0, output, G_L, db_L, dW_{D-1},
    db_{D-1} (depth 2: dW_0) and dx bit for bit, at w640, in every mode."""
    m, c = build_model("siren", depth=depth, hidden_size=640, input_size=in_size,
                       output_size=out_size)
    p = m.init(torch.Generator().manual_seed(15), c)
    gen = torch.Generator().manual_seed(16)
    x = torch.rand((200, in_size), generator=gen) * 2 - 1
    g = torch.randn((200, out_size), generator=gen)
    _assert_fwd_kinds_are_the_chains(p, c, x, precision)
    _assert_bwd_kinds_are_the_chains(p, c, x, g, precision)


def test_layer_kind_wrappers_reject_what_they_do_not_take_before_building(monkeypatch):
    """The first- and last-layer kinds' single-launch wrappers raise
    ValueError, before the library is built, on a CPU tensor, a width that
    is not a multiple of 128, more than 8 inputs or outputs, operands of
    other rows or widths, and a member axis on some operands only."""
    from implicit_image_tpu_torch.ops import cuda_build

    def refuse(*_args, **_kwargs):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "_nvcc", refuse)
    n, h = 300, 640
    x, w0, b0 = torch.zeros((n, 2)), torch.zeros((2, h)), torch.zeros(h)
    a, wl, bl = torch.zeros((n, h)), torch.zeros((h, 3)), torch.zeros(3)
    g, z = torch.zeros((n, 3)), torch.zeros((n, h))
    cases = [
        (sm.sine_mlp_layer_fwd_first, (x, w0, b0, 30.0, "fp32"), "expected a tensor on"),
        (sm.sine_mlp_layer_fwd_first, (x, w0[:, :600], b0[:600], 30.0, "fp32"), "multiple of"),
        (sm.sine_mlp_layer_fwd_first, (torch.zeros((n, 9)), torch.zeros((9, h)), b0, 30.0,
                                       "fp32"), "in <= 8"),
        (sm.sine_mlp_layer_fwd_first, (x[:, :1], w0, b0, 30.0, "fp32"), "expected"),
        (sm.sine_mlp_layer_fwd_first, (x[None], w0, b0, 30.0, "fp32"), "expected"),
        (sm.sine_mlp_layer_fwd_last, (a, wl, bl, "fp32"), "expected a tensor on"),
        (sm.sine_mlp_layer_fwd_last, (a[:, :600], wl[:600], bl, "fp32"), "multiple of"),
        (sm.sine_mlp_layer_fwd_last, (a, torch.zeros((h, 9)), torch.zeros(9), "fp32"),
         "out <= 8"),
        (sm.sine_mlp_layer_fwd_last, (a, wl, bl[:2], "fp32"), "expected"),
        (sm.sine_mlp_layer_fwd_last, (a, wl[None].expand(2, -1, -1), bl[None][:, :2], "fp32"),
         "expected"),
        (sm.sine_mlp_layer_bwd_last, (g, wl, z, 30.0, "fp32"), "expected a tensor on"),
        (sm.sine_mlp_layer_bwd_last, (g, wl, z[:299], 30.0, "fp32"), "expected"),
        (sm.sine_mlp_layer_bwd_last, (g[:, :2], wl, z, 30.0, "fp32"), "expected"),
        (sm.sine_mlp_layer_bwd_last, (g, wl[:600], z[:, :600], 30.0, "fp32"), "multiple of"),
        (sm.sine_mlp_layer_bwd_last, (g, wl, z, 30.0, "fp32", torch.zeros((299, 2))),
         "expected x"),
        (sm.sine_mlp_layer_bwd_last, (g, wl, z, 30.0, "fp32", torch.zeros((n, 9))),
         "expected x"),
        (sm.sine_mlp_layer_fwd_first, (x[None].expand(3, -1, -1), w0[None].expand(2, -1, -1),
                                       b0[None].expand(2, -1), 30.0, "fp32"), "2 members"),
        (sm.sine_mlp_layer_bwd_first, (z, w0, "fp32"), "expected a tensor on"),
        (sm.sine_mlp_layer_bwd_first, (z[:, :600], w0[:, :600], "fp32"), "multiple of"),
        (sm.sine_mlp_layer_bwd_first, (z, torch.zeros((9, h)), "fp32"), "in <= 8"),
        (sm.sine_mlp_layer_bwd_first, (z, w0[:, :512], "fp32"), "expected"),
    ]
    for fn, args, match in cases:
        with pytest.raises(ValueError, match=match):
            fn(*args)


def test_layer_bwd_rejects_what_it_does_not_take_before_building(monkeypatch):
    """sine_mlp_layer_bwd (one hidden layer) raises ValueError, before the
    library is built, on a CPU tensor, a width that is not a multiple of
    128, z of another shape, W of another width, planes of another mode's
    count and x of other rows or more than 8 inputs."""
    from implicit_image_tpu_torch.ops import cuda_build

    def refuse(*_args, **_kwargs):
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "_nvcc", refuse)
    g, w, z = torch.zeros((300, 640)), torch.zeros((640, 640)), torch.zeros((300, 640))
    with pytest.raises(ValueError, match="expected a tensor on"):
        sm.sine_mlp_layer_bwd(g, w, z, 30.0, "fp32")
    with pytest.raises(ValueError, match="multiple of 128"):
        sm.sine_mlp_layer_bwd(g[:, :600], w[:600, :600], z[:, :600], 30.0, "fp32")
    with pytest.raises(ValueError, match="multiple of 128"):
        sm.sine_mlp_layer_bwd(g, w, z[:299], 30.0, "fp32")
    with pytest.raises(ValueError, match="W"):
        sm.sine_mlp_layer_bwd(g, w[:512, :512], z, 30.0, "fp32")
    planes = sm._layer_planes(w[None], True, False)[0]  # one plane: the bf16 mode's
    with pytest.raises(ValueError, match="3 planes"):
        sm.sine_mlp_layer_bwd(g, planes, z, 30.0, "fp32")
    with pytest.raises(ValueError, match="expected x"):
        sm.sine_mlp_layer_bwd(g, w, z, 30.0, "fp32", x=torch.zeros((299, 2)))
    with pytest.raises(ValueError, match="expected x"):
        sm.sine_mlp_layer_bwd(g, w, z, 30.0, "fp32", x=torch.zeros((300, 9)))


def test_layer_knockouts_apply_to_the_current_source():
    """tools/layer_knockouts.py's replacements are each found once in
    csrc/sine_mlp.cu (variants() raises otherwise), and every variant but
    "full" changes the source, in the forward's part (the hidden layer's
    and the first layer's feed and stores), the backward's (the hidden
    layer's, and the last layer's feed and stores) and dW's."""
    from implicit_image_tpu_torch.ops import cuda_build
    from implicit_image_tpu_torch.tools import layer_knockouts

    src = (cuda_build.CSRC / "sine_mlp.cu").read_text()
    found = layer_knockouts.variants(src)
    assert {key for key in found} == {(0, "full"), (0, "no_mma"), (0, "no_split"), (0, "no_epi"),
                                      (0, "no_fring"), (0, "no_fstore"),
                                      (1, "full"), (1, "no_mma"), (1, "no_epi"), (1, "no_feed"),
                                      (1, "no_lring"), (1, "no_lstore"),
                                      (2, "full"), (2, "no_mma"), (2, "no_gsplit"),
                                      (2, "no_asplit")}
    for key, text in found.items():
        assert (text == src) == (key[1] == "full"), key


def test_layer_kind_reads_both_name_forms():
    """tools/kernel_breakdown.layer_kind (chip_smoke.py's split of
    sine_mlp_layer_bwd_kernel and its count of wgmma instantiations) reads
    the kind from ptxas's demangled names and from the profiler's, and is
    None for the other kernels."""
    from implicit_image_tpu_torch.tools.kernel_breakdown import layer_kind

    ptxas = ("void <unnamed>::sine_mlp_layer_bwd_kernel<(bool)0, (bool)1, (int){}, (bool)1>"
             "(LayerArgs, CUtensorMap_st, CUtensorMap_st)")
    trace = "void (anonymous namespace)::sine_mlp_layer_fwd_kernel<false, true, {}>(LayerArgs)"
    for kind in (0, 1, 2):
        assert layer_kind(ptxas.format(kind)) == kind
        assert layer_kind(trace.format(kind)) == kind
    dw = "void <unnamed>::sine_mlp_layer_dw_kernel<(bool)0, (bool)0>(LayerArgs)"
    assert layer_kind(dw) is None
    assert layer_kind("sum_partials_kernel<false>") is None


def test_grad_check_float64_chain_is_the_plain_chain():
    """tools/grad_check.py's float64 chain (its yardstick on the card) is
    the plain fp32 chain's math: within 1e-5 of it, forward and every
    gradient, at d4/w640 on 300 rows."""
    from implicit_image_tpu_torch.tools.grad_check import _over_max, chain_float64

    m, c = build_model("siren", depth=4, hidden_size=640)
    p = m.init(torch.Generator().manual_seed(0), c)
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((300, 2), generator=gen) * 2 - 1
    g = torch.randn((300, 3), generator=gen)
    plain = (sm.siren_chain_reference(p, x, c, "fp32"),
             *sm.siren_chain_backward_reference(p, x, g, c, "fp32"))
    (out, dx, grads), (out_64, dx_64, grads_64) = plain, chain_float64(
        p, x, g, [50.0, 30.0, 30.0, 30.0])
    rel = {"out": _over_max(out, out_64), "dx": _over_max(dx, dx_64)}
    for i, (a, b) in enumerate(zip(grads, grads_64)):
        rel.update({f"{i}.{k}": _over_max(a[k], b[k]) for k in ("w", "b")})
    assert max(rel.values()) <= 1e-5, rel


def _grad_leaves(p):
    """params_from_jax's leaves as autograd leaves."""
    tp = params_from_jax(p, "cpu")
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    return tp


def _flat(tp):
    return [t for layer in tp for t in (layer["w"], layer["b"])]


def _grads(tp):
    return [{k: layer[k].grad for k in KEYS} for layer in tp]


def _same(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in KEYS)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
@pytest.mark.parametrize("depth,hidden", [(4, 256), (3, 300), (3, 512), (4, 640), (3, 1024)])
def test_stash_under_autograd_gives_the_recompute_bits(precision, depth, hidden):
    """SineMLPFunction with a stash (the plain path's mirror of K1 filling
    the z stash for K2): the forward keeps z_0 .. z_{D-2}, the backward
    takes them and drops them, and out, dx and every gradient are the bits
    of siren_chain_reference and siren_chain_backward_reference (the
    recompute), in every mode, at d4/w256, d3/w300, d3/w512, d4/w640 and
    d3/w1024 on 144 pixels."""
    _, _, _, c, p, coords, _ = _setup(depth, hidden, seed=3)
    tp = _grad_leaves(p)
    x = ((torch.from_numpy(coords) - 0.5) * 2.0).requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(x.shape[0], 3)).astype(
        np.float32))
    out = sm.SineMLPFunction.apply(x, c, precision, True, *_flat(tp))
    node = out.grad_fn
    assert len(node.z) == depth - 1 and all(z.shape == (x.shape[0], hidden) for z in node.z)
    out.backward(g)
    assert node.z is None  # used up, dropped
    plain = [{k: v.detach() for k, v in layer.items()} for layer in tp]
    xd = x.detach()
    assert torch.equal(out.detach(), sm.siren_chain_reference(plain, xd, c, precision))
    dx, grads = sm.siren_chain_backward_reference(plain, xd, g, c, precision)
    assert torch.equal(x.grad, dx)
    assert _same(_grads(tp), grads)


@pytest.mark.parametrize("depth,hidden", [(4, 256), (3, 300), (3, 512), (4, 640), (3, 1024)])
def test_stash_path_grads_match_jax(depth, hidden):
    """The fit's path (models' apply_flat -> siren_apply_flat_fused, leaves
    requiring grad: the stash is kept) against JAX XLA fp32 on 144 pixels,
    within the limits of test_wide_fp32_forward_and_grads_match_jax (2e-5,
    1e-4 of each leaf's largest magnitude)."""
    jm, jc, m, c, p, coords, target = _setup(depth, hidden, seed=5)
    kept = []
    chain_forward = sm._chain_forward

    def spy(*args, keep=False):
        kept.append(keep)
        return chain_forward(*args, keep=keep)

    sm._chain_forward = spy
    try:
        out, grads = _torch_grads(m, c, p, coords, target, "fp32")
    finally:
        sm._chain_forward = chain_forward
    assert kept[0] is True
    np.testing.assert_allclose(out, np.asarray(jm.apply_flat(p, coords, jc)), atol=2e-5)
    jg = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc) - target) ** 2))(p)
    for a, b in zip(grads, jg):
        for k in KEYS:
            ref = np.asarray(b[k])
            assert np.abs(a[k] - ref).max() <= 1e-4 * np.abs(ref).max(), k


def test_no_stash_without_a_backward_to_follow(monkeypatch):
    """The stash is decided outside the Functions: under torch.no_grad (a
    render, an eval, a decode) no forward keeps one, though every leaf
    requires grad, single or over a member axis, and neither does a forward
    whose inputs require no grad; with grad on and a leaf requiring it, one
    is kept."""
    m, c = build_model("siren", depth=3, hidden_size=640)
    params = m.init(torch.Generator().manual_seed(6), c)
    for layer in params:
        for v in layer.values():
            v.requires_grad_(True)
    stacked = sm.stack_members([params, params])
    coords = torch.rand((50, 2), generator=torch.Generator().manual_seed(7))
    kept = []
    chain_forward = sm._chain_forward

    def spy(*args, keep=False):
        kept.append(keep)
        return chain_forward(*args, keep=keep)

    monkeypatch.setattr(sm, "_chain_forward", spy)
    with torch.no_grad():
        assert not sm._wants_stash(coords, *_flat(params))
        sm.siren_apply_flat_fused(params, coords, c)
        sm.siren_apply_flat_batched_fused(stacked, coords, c)
        m.apply_flat(params, coords, c, "fp32")
    assert kept == [False] * 4
    detached = [{k: v.detach() for k, v in layer.items()} for layer in params]
    assert not sm._wants_stash(coords, *_flat(detached))
    sm.siren_apply_flat_fused(detached, coords, c)
    assert kept[-1] is False
    assert sm._wants_stash(coords, *_flat(params))
    sm.siren_apply_flat_fused(params, coords, c)
    assert kept[-1] is True


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp32+mixed", "bf16+mixed"])
def test_stash_over_a_member_axis_is_the_single_fits(precision):
    """SineMLPBatchedFunction with a stash, 2 members at d4/w640, each its
    own x: the stash holds each member's z, and member m's out, dx and
    gradients are the bits of SineMLPFunction with a stash on member m
    alone, in every mode."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    members = [m.init(torch.Generator().manual_seed(8 + i), c) for i in range(2)]
    gen = torch.Generator().manual_seed(10)
    xs = (torch.rand((2, 90, 2), generator=gen) * 2 - 1).requires_grad_(True)
    g = torch.randn((2, 90, 3), generator=gen)
    stacked = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
               for layer in sm.stack_members(members)]
    out = sm.SineMLPBatchedFunction.apply(xs, c, precision, True, *_flat(stacked))
    node = out.grad_fn
    assert len(node.z) == 2 and all(len(zs) == 3 for zs in node.z)
    out.backward(g)
    assert node.z is None
    for i, p in enumerate(members):
        tp = [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in p]
        x = xs[i].detach().clone().requires_grad_(True)
        one = sm.SineMLPFunction.apply(x, c, precision, True, *_flat(tp))
        one.backward(g[i])
        assert torch.equal(out[i].detach(), one.detach())
        assert torch.equal(xs.grad[i], x.grad)
        assert _same([{k: v.grad[i] for k, v in layer.items()} for layer in stacked],
                     _grads(tp))


@pytest.mark.parametrize("batched", [False, True])
def test_second_backward_recomputes_the_used_stash(batched):
    """A second backward through the same graph (retain_graph=True) finds
    the stash used up and dropped, recomputes it (K2's own path) and gives
    the first backward's bits, single and over the member axis."""
    m, c = build_model("siren", depth=4, hidden_size=640)
    params = m.init(torch.Generator().manual_seed(11), c)
    if batched:
        params = sm.stack_members([params, m.init(torch.Generator().manual_seed(12), c)])
    for layer in params:
        for v in layer.values():
            v.requires_grad_(True)
    gen = torch.Generator().manual_seed(13)
    coords = torch.rand((70, 2), generator=gen)
    apply = sm.siren_apply_flat_batched_fused if batched else sm.siren_apply_flat_fused
    out = apply(params, coords, c, "fp32")
    g = torch.randn(out.shape, generator=gen)
    out.backward(g, retain_graph=True)
    first = [{k: v.grad.clone() for k, v in layer.items()} for layer in params]
    for layer in params:
        for v in layer.values():
            v.grad = None
    out.backward(g)
    assert _same(_grads(params), first)


@pytest.mark.parametrize("hidden", [128, 192])
def test_no_stash_at_fused_widths(hidden):
    """At 192 and below the fused kernels recompute inside K2: asked for a
    stash, the Function keeps none, and its gradients are the recompute's."""
    m, c = build_model("siren", depth=3, hidden_size=hidden)
    params = m.init(torch.Generator().manual_seed(14), c)
    for layer in params:
        for v in layer.values():
            v.requires_grad_(True)
    gen = torch.Generator().manual_seed(15)
    x = torch.rand((60, 2), generator=gen) * 2 - 1
    g = torch.randn((60, 3), generator=gen)
    out = sm.SineMLPFunction.apply(x, c, "fp32", True, *_flat(params))
    assert out.grad_fn.z is None
    out.backward(g)
    plain = [{k: v.detach() for k, v in layer.items()} for layer in params]
    assert _same(_grads(params), sm.siren_chain_backward_reference(plain, x, g, c, "fp32")[1])
