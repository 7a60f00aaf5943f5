"""Port parity: the db3 DWT (ops/wavelet.py) and wavelet-SIREN
(models/wavelet_siren.py).

Inputs come from seeded numpy; weights are drawn by the JAX init and
copied into the port. The DWT, its inverse, the YCbCr conversion and the
bilinear upsample agree with the JAX package within 1e-6 (borders
included); the model's forward within 1e-5 and its gradients within 1e-4
of the largest reference gradient. RigL's ERK densities and topology
updates over the 16 layers of both sub-SIRENs equal JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.models.wavelet_siren import ycbcr_to_rgb as j_ycbcr
from implicit_image_tpu.ops import wavelet as jw
from implicit_image_tpu.sparsity import core as jcore
from implicit_image_tpu.sparsity.init_scheme import erdos_renyi_probs as j_erk
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model, build_model_from_config
from implicit_image_tpu_torch.models.siren import init_siren
from implicit_image_tpu_torch.models.wavelet_siren import _upsample
from implicit_image_tpu_torch.models.wavelet_siren import ycbcr_to_rgb as t_ycbcr
from implicit_image_tpu_torch.ops import wavelet as tw
from implicit_image_tpu_torch.sparsity import core as tcore
from implicit_image_tpu_torch.sparsity.init_scheme import erdos_renyi_probs as t_erk
from implicit_image_tpu_torch.training.fit import make_grad_fn

torch.set_num_threads(1)

SIDES = [(16, 16), (32, 48), (17, 23), (9, 9)]
ARCH = dict(depth=4, hidden_size=16)


def _image(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_db3_filters_equal_jax():
    for a, b in zip(tw._filters(), jw._filters()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tw.DB3_DEC_LO, jw.DB3_DEC_LO)
    for n in (1, 9, 16, 17, 512):
        assert tw.dwt_coeff_len(n) == jw.dwt_coeff_len(n)
    assert tw.dwt_coeff_len(512) == 258


@pytest.mark.parametrize("hw", SIDES)
def test_dwt2_matches_jax(hw):
    x = _image(hw)
    ours = tw.dwt2(torch.from_numpy(x))
    theirs = jw.dwt2(jnp.asarray(x))
    side = (tw.dwt_coeff_len(hw[0]), tw.dwt_coeff_len(hw[1]))
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == side
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", SIDES)
def test_idwt2_matches_jax_and_reconstructs(hw):
    """The inverse of the same bands agrees with JAX's; on even sides it
    gives the input back."""
    x = _image(hw, seed=1)
    bands = jw.dwt2(jnp.asarray(x))
    theirs = np.asarray(jw.idwt2(*bands, hw))
    ours = tw.idwt2(*(torch.from_numpy(np.array(b)) for b in bands), hw).numpy()
    assert ours.shape == hw
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    if hw[0] % 2 == 0 and hw[1] % 2 == 0:
        rec = tw.idwt2(*tw.dwt2(torch.from_numpy(x)), hw).numpy()
        np.testing.assert_allclose(rec, x, rtol=0, atol=1e-6)


def test_band_order():
    """(LL, LH, HL, HH): an image that varies along the columns only has
    detail in LH alone, one that varies along the rows in HL alone (away
    from the zero-padded border)."""
    ramp = np.sin(np.linspace(0, 40, 40)).astype(np.float32)
    along_cols = torch.from_numpy(np.tile(ramp, (40, 1)))
    along_rows = along_cols.t().contiguous()
    inner = (slice(4, -4), slice(4, -4))
    ll, lh, hl, hh = tw.dwt2(along_cols)
    assert float(lh[inner].abs().max()) > 1e-2
    assert float(hl[inner].abs().max()) < 1e-5 and float(hh[inner].abs().max()) < 1e-5
    ll, lh, hl, hh = tw.dwt2(along_rows)
    assert float(hl[inner].abs().max()) > 1e-2
    assert float(lh[inner].abs().max()) < 1e-5 and float(hh[inner].abs().max()) < 1e-5


def test_ycbcr_to_rgb_matches_jax():
    x = _image((7, 5, 3), seed=2)
    np.testing.assert_allclose(t_ycbcr(torch.from_numpy(x)).numpy(),
                               np.asarray(j_ycbcr(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((21, 21), (32, 32)), ((7, 5), (13, 9)),
                                     ((258, 258), (512, 512)), ((9, 8), (5, 8))])
def test_upsample_matches_jax_resize(src, dst):
    """The weight-matrix resize against jax.image.resize(bilinear), border
    rows and columns included; the last case shrinks one axis (the
    antialiased kernel)."""
    x = _image(src + (2,), seed=3)
    theirs = np.asarray(jax.image.resize(jnp.asarray(x), dst + (2,), method="bilinear"))
    ours = _upsample(torch.from_numpy(x), *dst).numpy()
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_allclose(ours[edge], theirs[edge], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def _setup(hw, seed=0):
    jm, jc = jbuild("wavelet_siren", height=hw[0], width=hw[1], **ARCH)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    m, c = build_model("wavelet_siren", height=hw[0], width=hw[1], **ARCH)
    return jm, jc, p, m, c


@pytest.mark.parametrize("hw", [(32, 32), (20, 28)])
def test_forward_matches_jax(hw):
    jm, jc, p, m, c = _setup(hw)
    tp = params_from_jax(p, "cpu")
    theirs = np.asarray(jm.apply(p, jgrid(*hw), jc))
    ours = m.apply(tp, get_grid(*hw), c).numpy()
    assert ours.shape == hw + (3,)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    flat = m.apply_flat(tp, get_grid(*hw).reshape(-1, 2), c).numpy()
    np.testing.assert_array_equal(flat.reshape(ours.shape), ours)


def test_gradients_match_jax():
    hw = (32, 32)
    jm, jc, p, m, c = _setup(hw, seed=1)
    target = _image(hw + (3,), seed=4)
    jg = jax.grad(lambda q: jnp.mean(
        (jm.apply_flat(q, jgrid(*hw).reshape(-1, 2), jc) - target.reshape(-1, 3)) ** 2))(p)
    grad_fn = make_grad_fn(m, c, get_grid(*hw).reshape(-1, 2),
                           torch.from_numpy(target).reshape(-1, 3), "fp32")
    tp = params_from_jax(p, "cpu")
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    _, grads = grad_fn(tp)
    assert len(grads) == 2 * ARCH["depth"]
    for i, layer in enumerate(grads):
        for k, g in layer.items():
            ref = np.asarray(jg[i][k])
            assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), (i, k)


def test_init_is_lf_then_hf_from_one_generator():
    m, c = build_model("wavelet_siren", height=16, width=16, **ARCH)
    params = m.init(torch.Generator().manual_seed(5), c)
    gen = torch.Generator().manual_seed(5)
    want = init_siren(gen, c.lf_config) + init_siren(gen, c.hf_config)
    assert len(params) == 2 * ARCH["depth"]
    for a, b in zip(params, want):
        for k in ("w", "b"):
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert c.lf_shape == c.hf_shape == (10, 10)


def test_full_grid_only():
    """apply_flat asserts the configured full grid, as JAX's does; the fit
    refuses pixel chunks before its first step."""
    m, c = build_model("wavelet_siren", height=16, width=16, **ARCH)
    params = m.init(torch.Generator().manual_seed(0), c)
    with pytest.raises(AssertionError):
        m.apply_flat(params, get_grid(16, 16).reshape(-1, 2)[:128], c)
    with pytest.raises(AssertionError):
        m.apply(params, get_grid(8, 16), c)
    with pytest.raises(ValueError, match="pixel_chunks"):
        make_grad_fn(m, c, get_grid(16, 16).reshape(-1, 2), torch.zeros(256, 3), "fp32",
                     pixel_chunks=2)


def test_config_composes_height_and_width_from_img():
    from implicit_image_tpu_torch.compress import compose

    cfg = compose(["mlp=wavelet_siren", "img.height=48", "img.width=40"])
    m, c = build_model_from_config(cfg)
    assert (m.name, c.height, c.width, c.depth, c.hidden_size) == (
        "wavelet_siren", 48, 40, 8, 128)


@pytest.mark.parametrize("density", [0.25, 0.5])
def test_erk_over_both_sub_sirens_equals_jax(density):
    _, c = build_model("wavelet_siren", depth=8, hidden_size=128)
    shapes = [tuple(d) for d in c.lf_config.layer_dims] + [
        tuple(d) for d in c.hf_config.layer_dims]
    assert len(shapes) == 16
    assert t_erk(shapes, density) == j_erk(shapes, density)


def test_update_connections_identical_on_wavelet_siren():
    """Two RigL topology updates over the 8 layers of a d4/w16
    wavelet-SIREN from identical params, grads and one saved mask:
    identical masks, params and MaskState scalars."""
    _, _, p, _, _ = _setup((16, 16), seed=2)
    rng = np.random.default_rng(13)
    grads = [{k: (rng.integers(0, 7, v.shape) / 8 * rng.choice([-1.0, 1.0], v.shape)
                  ).astype(np.float32) * 1e-3 for k, v in layer.items()} for layer in p]
    lottery = [(rng.uniform(size=layer["w"].shape) < 0.25).astype(np.float32) for layer in p]
    jcfg = jcore.MaskingConfig(density=0.25, sparse_init="lottery-ticket")
    tcfg = tcore.MaskingConfig(density=0.25, sparse_init="lottery-ticket")
    jstate = jcore.create_mask_state(jax.random.PRNGKey(0), p, jcfg, lottery_masks=lottery)
    tp = tuple({k: torch.from_numpy(v).clone() for k, v in layer.items()} for layer in p)
    tstate = tcore.create_mask_state(torch.Generator().manual_seed(0), tp, tcfg,
                                     lottery_masks=lottery)
    assert sum(m is not None for m in tstate.masks) == len(p) == 8
    jp = jcore.apply_masks(p, jstate.masks)
    tcore.apply_masks_(tp, tstate.masks)
    for rate in (0.3, 0.1):
        jp, jstate = jcore.update_connections(
            jp, grads, [None] * len(p), jstate, jnp.float32(rate), jax.random.PRNGKey(1), jcfg)
        tp, tstate = tcore.update_connections(
            tp, tuple({k: torch.from_numpy(v) for k, v in g.items()} for g in grads),
            [None] * len(p), tstate, np.float32(rate), None, tcfg)
        for a, b in zip(jstate.masks, tstate.masks):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jp, tp):
            for k in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
        for field in ("baseline_nonzero", "total_params", "adjusted_growth", "adj_sum",
                      "adj_count"):
            assert float(getattr(tstate, field)) == float(getattr(jstate, field)), field
