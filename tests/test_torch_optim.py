"""Port parity: the optimizer options (optim/__init__.py): global-norm
gradient clipping (optim.grad_clip) against the JAX package's
clip_by_global_norm and opt_update, a clipped fit against JAX's, the
Shampoo/EKFAC keys that Adam ignores in both packages, and the other
optimizers running through the CLI (their parity: test_torch_shampoo.py,
test_torch_ekfac.py).

Tolerances: the clipped gradients and one Adam step within 1e-6 relative
(float32; the norm is summed in another order); a 10-step clipped fit's
params within 1e-4 of the largest weight (the fit parity bound).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import optim as joptim
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import fit as jfit
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.convert import params_from_jax, params_to_numpy
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.optim import clip_by_global_norm, opt_init, opt_update
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)


def _grads(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple({"w": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
                  "b": (rng.standard_normal(7) * scale).astype(np.float32)} for _ in range(3))


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e6])
def test_clip_matches_jax(max_norm):
    g = _grads()
    ref = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    ours, scale = clip_by_global_norm(params_from_jax(g, "cpu"), max_norm)
    norm = np.sqrt(sum(float(np.sum(layer[k].astype(np.float64) ** 2))
                       for layer in g for k in layer))
    assert float(scale) == pytest.approx(min(1.0, max_norm / norm), rel=1e-6)
    for a, b in zip(params_to_numpy(ours), ref):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-6, atol=1e-7)


def test_clip_below_the_norm_leaves_the_bits():
    g = params_from_jax(_grads(scale=1e-3), "cpu")
    ours, scale = clip_by_global_norm(g, 10.0)
    assert float(scale) == 1.0
    for a, b in zip(ours, g):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_clipped_adam_step_matches_jax():
    params, grads = _grads(seed=1), _grads(seed=2, scale=5.0)
    jcfg, tcfg = JOptim(grad_clip=1.0, lr=1e-2), OptimConfig(grad_clip=1.0, lr=1e-2)
    jp, _ = joptim.opt_update(jax.tree.map(jnp.asarray, grads),
                              joptim.opt_init(jax.tree.map(jnp.asarray, params), jcfg),
                              jax.tree.map(jnp.asarray, params), 1e-2, jcfg)
    tp = params_from_jax(params, "cpu")
    stats = {}
    tp, _ = opt_update(params_from_jax(grads, "cpu"), opt_init(tp, tcfg), tp, 1e-2, tcfg,
                       stats=stats)
    assert 0.0 < float(stats["clip_scale"]) < 1.0
    for a, b in zip(params_to_numpy(tp), jp):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-6, atol=1e-7)


def test_clipped_fit_matches_jax():
    """10 steps of a d3/w16 SIREN with a clip that binds on every step."""
    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), jc))
    img = np.random.default_rng(4).uniform(size=(12, 12, 3)).astype(np.float32)
    jres = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(12, 12), img,
                JTrain(num_steps=10, log_steps=10, matmul_precision="tensorfloat32"),
                JOptim(lr=1e-3, grad_clip=0.05), init_params=jax.tree.map(jnp.asarray, init))
    m, c = build_model("siren", depth=3, hidden_size=16)
    tres = fit(torch.Generator().manual_seed(0), m, c, get_grid(12, 12), img,
               TrainConfig(num_steps=10, log_steps=10), OptimConfig(lr=1e-3, grad_clip=0.05),
               init_params=params_from_jax(init, "cpu"), device="cpu")
    assert tres.metrics["clip_scale"].shape == (10,)
    assert (tres.metrics["clip_scale"] < 1.0).all()
    for a, b in zip(params_to_numpy(tres.params), jres.params):
        for k in a:
            ref = np.asarray(b[k])
            assert np.abs(a[k] - ref).max() <= 1e-4 * np.abs(ref).max(), k


BASE = ["img=synthetic", "img.height=12", "img.width=12", "mlp.depth=3", "mlp.hidden_size=8",
        "train.num_steps=6", "train.log_steps=3", "masking=none", "quant=none",
        "entropy_coding=none", "device=cpu"]


def test_adam_ignores_the_shampoo_keys(tmp_path, caplog):
    """optim.momentum / weight_decay / epsilon / update_freq / graft_norm are
    accepted, change nothing under Adam (the same bits), and are logged once."""
    plain = tcompress.main(compose(BASE), run_dir=str(tmp_path / "a"))
    with caplog.at_level(logging.INFO, logger="implicit_image_tpu_torch"):
        keyed = tcompress.main(compose(BASE + [
            "optim.epsilon=1e-15", "optim.momentum=0.5", "optim.weight_decay=0.1",
            "+optim.update_freq=4", "+optim.graft_norm=false"]), run_dir=str(tmp_path / "b"))
    assert keyed == plain
    a, b = np.load(tmp_path / "a" / "model.npz"), np.load(tmp_path / "b" / "model.npz")
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert sum("Adam ignores" in r.getMessage() for r in caplog.records) == 1


@pytest.mark.parametrize("override", ["optim=shampoo", "+optim.preconditioner=ekfac"])
def test_other_optimizers_run(tmp_path, override):
    """optim=shampoo and optim.preconditioner=ekfac run through compress.main
    and change the fit (other bits than Adam's)."""
    plain = tcompress.main(compose(BASE), run_dir=str(tmp_path / "adam"))
    psnr, _ = tcompress.main(compose(BASE + [override]), run_dir=str(tmp_path / "other"))
    assert np.isfinite(psnr) and psnr != plain[0]
