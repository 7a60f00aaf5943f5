"""Port parity: the Fourier-feature MLP (models/fourier.py).

Weights (the frozen encoding B included) are drawn by the JAX init and
copied into the port. The forward agrees with the JAX package within 1e-6
and the gradients within 1e-4 of the largest reference gradient. B takes no
gradient and no step: it leaves a fit and a codebook finetune bit for bit
as it came in, and it is never masked.
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
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.sparsity import MaskingConfig, create_mask_state
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit, make_grad_fn
from implicit_image_tpu_torch.training.quant_phase import quant_finetune

torch.set_num_threads(1)

ARCH = dict(depth=4, hidden_size=16, map_size=16)


def _setup(seed=0, **kw):
    arch = {**ARCH, **kw}
    jm, jc = jbuild("fourier", **arch)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    m, c = build_model("fourier", **arch)
    return jm, jc, p, m, c


@pytest.mark.parametrize("hw,scale", [((16, 16), 16.0), ((12, 20), 4.0)])
def test_forward_matches_jax(hw, scale):
    jm, jc, p, m, c = _setup(map_scale=scale)
    tp = params_from_jax(p, "cpu")
    theirs = np.asarray(jm.apply(p, jgrid(*hw), jc))
    ours = m.apply(tp, get_grid(*hw), c).numpy()
    assert ours.shape == hw + (3,)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def test_gradients_match_jax_and_skip_b():
    hw = (16, 16)
    jm, jc, p, m, c = _setup(seed=1)
    target = np.random.default_rng(1).uniform(size=hw + (3,)).astype(np.float32)
    jg = jax.grad(lambda q: jnp.mean(
        (jm.apply_flat(q, jgrid(*hw).reshape(-1, 2), jc) - target.reshape(-1, 3)) ** 2))(p)
    tp = params_from_jax(p, "cpu")
    grad_fn = make_grad_fn(m, c, get_grid(*hw).reshape(-1, 2),
                           torch.from_numpy(target).reshape(-1, 3), "fp32")
    for layer in tp[1:]:
        for v in layer.values():
            v.requires_grad_(True)
    _, grads = grad_fn(tp)
    assert grads[0] == {}  # no gradient for the frozen encoding
    for i in range(1, len(tp)):
        for k in ("w", "b"):
            ref = np.asarray(jg[i][k])
            assert np.abs(grads[i][k].numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), (i, k)


def test_init_layout_and_bounds():
    m, c = build_model("fourier", depth=5, hidden_size=32, map_size=64, map_scale=10.0)
    params = m.init(torch.Generator().manual_seed(0), c)
    assert list(params[0]) == ["B"] and tuple(params[0]["B"].shape) == (2, 32)
    assert 5.0 < float(params[0]["B"].std()) < 15.0
    assert [tuple(layer["w"].shape) for layer in params[1:]] == list(c.layer_dims)
    for layer, (fan_in, _) in zip(params[1:], c.layer_dims):
        for k in ("w", "b"):
            assert float(layer[k].abs().max()) <= fan_in ** -0.5
    out = m.apply(params, get_grid(4, 4), c, "bf16")  # every precision mode runs
    assert out.shape == (4, 4, 3) and torch.isfinite(out).all()


def test_fit_and_finetune_leave_b_frozen():
    """Adam steps move every linear layer and leave B bit for bit; the
    codebook finetune takes its device from the first weight (layer 0 holds
    B alone) and keeps B too. Masks cover the linear layers only."""
    _, _, p, m, c = _setup(seed=2)
    img = synthetic_image(12, 12, seed=2)
    init = params_from_jax(p, "cpu")
    res = fit(None, m, c, get_grid(12, 12), img,
              TrainConfig(num_steps=5, log_steps=5, matmul_precision="float32"),
              OptimConfig(lr=1e-2), init_params=init)
    torch.testing.assert_close(res.params[0]["B"], init[0]["B"], rtol=0, atol=0)
    assert not res.params[0]["B"].requires_grad
    for a, b in zip(res.params[1:], init[1:]):
        assert not torch.equal(a["w"], b["w"])
    q = quant_finetune(res.params, img, m, c, get_grid(12, 12),
                       QuantConfig(bits=4, num_steps=3), OptimConfig(lr=1e-3))
    torch.testing.assert_close(q.params[0]["B"], init[0]["B"], rtol=0, atol=0)
    assert q.codebooks[0] is None and q.codebooks[2] is not None
    assert np.isfinite(q.metrics["quant_psnr"])
    state = create_mask_state(torch.Generator().manual_seed(0), init,
                              MaskingConfig(density=0.5))
    assert state.masks[0] is None and all(mk is not None for mk in state.masks[1:])
