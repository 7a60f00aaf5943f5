"""Port parity: SSIM, MS-SSIM and the `ms-ssim` training loss.

The same numpy images (64x64x3, from seeds) go through the JAX functions and
their counterparts in implicit_image_tpu_torch.ops.ssim; the loss gradient
of a small SIREN is held against jax.grad from copied weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.ops import ssim as jssim
from implicit_image_tpu.training.fit import make_loss_fn as j_make_loss_fn
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import ssim as tssim
from implicit_image_tpu_torch.training.fit import make_loss_fn

torch.set_num_threads(1)


def _pair(seed, noise):
    rng = np.random.default_rng(seed)
    target = synthetic_image(64, 64, seed=seed)
    pred = np.clip(target + rng.normal(0, noise, target.shape), 0, 1).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("seed,noise", [(0, 0.01), (1, 0.1), (2, 0.003)])
def test_ssim_matches(seed, noise):
    pred, target = _pair(seed, noise)
    a = float(tssim.ssim(torch.from_numpy(pred), torch.from_numpy(target)))
    b = float(jssim.ssim(jnp.asarray(pred), jnp.asarray(target)))
    assert abs(a - b) <= 1e-5, (a, b)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("seed,noise", [(3, 0.02), (4, 0.1)])
def test_ms_ssim_matches(levels, seed, noise):
    pred, target = _pair(seed, noise)
    a = float(tssim.ms_ssim(torch.from_numpy(pred), torch.from_numpy(target), levels=levels))
    b = float(jssim.ms_ssim(jnp.asarray(pred), jnp.asarray(target), levels=levels))
    assert abs(a - b) <= 1e-5, (a, b)
    assert 0.0 < a <= 1.0


def test_ms_ssim_rejects_too_many_levels():
    img = torch.zeros((40, 40, 3))
    with pytest.raises(ValueError):
        tssim.ms_ssim(img, img, levels=3)


def test_ms_ssim_loss_gradient_matches_jax():
    """(1-w)·MSE + w·(1-MS-SSIM) on a d3 w16 SIREN over 64x64 (3 scales):
    loss within 1e-5, and the gradient, all parameters as one vector,
    within 1e-4 of its largest |jax.grad| entry."""
    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5), jc))
    img = synthetic_image(64, 64, seed=9)
    coords = np.asarray(jgrid(64, 64)).reshape(-1, 2)
    target = img.reshape(-1, 3)
    jloss = j_make_loss_fn(jm, jc, jnp.asarray(coords), jnp.asarray(target), None,
                           grid_hw=(64, 64), loss_name="ms-ssim")
    jl, jg = jax.value_and_grad(jloss)(p)

    m, c = build_model("siren", depth=3, hidden_size=16)
    tp = params_from_jax(p, "cpu")
    leaves = [v.requires_grad_(True) for layer in tp for v in layer.values()]
    tloss = make_loss_fn(m, c, get_grid(64, 64).reshape(-1, 2), torch.from_numpy(target),
                         "fp32", grid_hw=(64, 64), loss_name="ms-ssim")
    tl = tloss(tp)
    grads = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    ours = np.concatenate([g.numpy().ravel() for g in grads])
    ref = np.concatenate([np.asarray(v).ravel() for layer in jg for v in layer.values()])
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
