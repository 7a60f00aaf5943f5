"""Port parity: Adam, the LR schedules and the fit loop, dense and RigL,
from the same initial weights (copied from the JAX init) and, for RigL, the
same initial masks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.optim import adam_init as j_adam_init
from implicit_image_tpu.optim import adam_update as j_adam_update
from implicit_image_tpu.optim import adam_momentum as j_adam_momentum
from implicit_image_tpu.optim import step_lr as j_step_lr
from implicit_image_tpu.sparsity import MaskingConfig as JMasking
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import make_fit_fn
from implicit_image_tpu_torch.convert import params_from_jax, params_to_numpy
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.optim import (
    adam_init,
    adam_momentum,
    adam_update,
    cosine_lr,
    step_lr,
)
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [(0, 1999, 2000, 4001, 9999)])
def test_step_lr_matches(steps):
    ours, ref = step_lr(3e-4, 2000, 0.5), j_step_lr(3e-4, 2000, 0.5)
    for s in steps:
        assert ours(s) == float(np.float32(ref(s)))


def test_cosine_lr_shape():
    sched = cosine_lr(1e-3, 100, warmup=10)
    assert sched(0) == 0.0
    assert sched(10) == pytest.approx(1e-3)
    assert sched(100) == pytest.approx(0.0, abs=1e-12)


def test_adam_steps_match():
    rng = np.random.default_rng(0)
    params = ({"w": rng.normal(size=(4, 5)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)},)
    grads = [({"w": rng.normal(size=(4, 5)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)},) for _ in range(3)]
    jp, js = params, j_adam_init(params)
    tp = params_from_jax(params, "cpu")
    ts = adam_init(tp)
    for g in grads:
        jp, js = j_adam_update(g, js, jp, 1e-2)
        tp, ts = adam_update(params_from_jax(g, "cpu"), ts, tp, 1e-2)
    for k in ("w", "b"):
        np.testing.assert_allclose(params_to_numpy(tp)[0][k], np.asarray(jp[0][k]),
                                   rtol=1e-6, atol=1e-7)
    assert ts.count == int(js.count) == 3
    np.testing.assert_allclose(adam_momentum(ts, 0).numpy(),
                               np.asarray(j_adam_momentum(js, 0)), rtol=1e-6)


def _jax_fit(p, img, steps, log_steps):
    mdef, mcfg = jbuild("siren", depth=3, hidden_size=16)
    fit_fn = make_fit_fn(mdef, mcfg, jgrid(16, 16), JTrain(num_steps=steps, log_steps=log_steps),
                         JOptim(lr=1e-3), init_params=p)
    params, _, _, metrics = jax.jit(fit_fn)(jax.random.PRNGKey(0), jnp.asarray(img))
    return jax.tree.map(np.asarray, params), np.asarray(metrics["psnr"])


def test_fit_matches_jax():
    """Adam + StepLR over a 50-step fit from copied init (16x16, d3 w16,
    lr 1e-3): per-log-step PSNR within 0.05 dB, final params within 1e-3
    relative."""
    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jc))
    img = synthetic_image(16, 16, seed=0)
    j_params, j_psnr = _jax_fit(p, img, 50, 10)

    m, c = build_model("siren", depth=3, hidden_size=16)
    res = fit(torch.Generator().manual_seed(0), m, c, get_grid(16, 16), img,
              TrainConfig(num_steps=50, log_steps=10, matmul_precision="float32"),
              OptimConfig(lr=1e-3), init_params=params_from_jax(p, "cpu"))
    logged = ~np.isnan(j_psnr)
    np.testing.assert_array_equal(logged, ~np.isnan(res.metrics["psnr"]))
    assert logged.sum() == 5
    np.testing.assert_allclose(res.metrics["psnr"][logged], j_psnr[logged], atol=0.05)
    for a, b in zip(params_to_numpy(res.params), j_params):
        for k in ("w", "b"):
            assert np.abs(a[k] - b[k]).max() <= 1e-3 * np.abs(b[k]).max(), k


def test_fit_evals_final_step_and_chunks_agree():
    """Short runs eval the final step; pixel_chunks=4 accumulates the same
    gradient as one full-grid chunk."""
    m, c = build_model("siren", depth=3, hidden_size=8)
    init = m.init(torch.Generator().manual_seed(1), c)
    img = synthetic_image(8, 8, seed=1)
    runs = [
        fit(None, m, c, get_grid(8, 8), img,
            TrainConfig(num_steps=7, log_steps=100, pixel_chunks=k, matmul_precision="float32"),
            OptimConfig(lr=1e-3), init_params=init)
        for k in (1, 4)
    ]
    for r in runs:
        assert np.isnan(r.metrics["psnr"][:-1]).all() and np.isfinite(r.metrics["psnr"][-1])
    for a, b in zip(params_to_numpy(runs[0].params), params_to_numpy(runs[1].params)):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6)


def test_fit_rejects_sparse_masking():
    """What still raises: struct-* inits (they need 4-D kernels, an MLP has
    none), unknown modes, and a precision schedule that leaves no step at
    train.matmul_precision (hashgrid, which raised here, is ported)."""
    m, c = build_model("siren", depth=3, hidden_size=8)
    with pytest.raises(ValueError, match="matmul_precision_switch"):
        fit(torch.Generator(), m, c, get_grid(4, 4), np.zeros((4, 4, 3), np.float32),
            TrainConfig(num_steps=4, log_steps=1, matmul_precision_early="bfloat16",
                        matmul_precision_switch=1.0), OptimConfig())
    with pytest.raises(ValueError):
        fit(torch.Generator(), m, c, get_grid(4, 4), np.zeros((4, 4, 3), np.float32),
            TrainConfig(num_steps=1, log_steps=1), OptimConfig(),
            masking_cfg=MaskingConfig(sparse_init="struct-random"))
    with pytest.raises(ValueError):
        MaskingConfig(growth_mode="largest")


def test_rigl_fit_matches_jax(tmp_path):
    """RigL from injected masks and a copied init (16x16, d3 w16, 60 steps,
    an update every 10 steps up to step 40, lr 1e-3, float32): the density
    array equals JAX's, the final masks agree on >= 99.5% of entries with
    equal per-layer counts, the logged PSNR is within 0.05 dB and the final
    params within 1e-3 relative."""
    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jc))
    rng = np.random.default_rng(4)
    np.savez(tmp_path / "mask.npz", **{
        f"layers.{i}.mask": (rng.uniform(size=layer["w"].shape) < 0.5).astype(np.float32)
        for i, layer in enumerate(p)})
    kw = dict(sparse_init="lottery-ticket", mask_path=str(tmp_path / "mask.npz"),
              interval=10, end_when=40)
    img = synthetic_image(16, 16, seed=5)
    fit_fn = make_fit_fn(jm, jc, jgrid(16, 16), JTrain(num_steps=60, log_steps=10),
                         JOptim(lr=1e-3), JMasking(**kw), init_params=p)
    j_params, _, j_state, j_metrics = jax.jit(fit_fn)(jax.random.PRNGKey(0), jnp.asarray(img))

    m, c = build_model("siren", depth=3, hidden_size=16)
    res = fit(torch.Generator().manual_seed(0), m, c, get_grid(16, 16), img,
              TrainConfig(num_steps=60, log_steps=10, matmul_precision="float32"),
              OptimConfig(lr=1e-3), MaskingConfig(**kw), init_params=params_from_jax(p, "cpu"))
    np.testing.assert_array_equal(res.metrics["density"], np.asarray(j_metrics["density"]))
    # the jitted JAX cosine rounds some steps an ulp away from its eager form
    np.testing.assert_allclose(res.metrics["prune_rate"], np.asarray(j_metrics["prune_rate"]),
                               rtol=0, atol=1e-7)
    for a, b in zip(res.mask_state.masks, j_state.masks):
        a, b = a.numpy(), np.asarray(b)
        assert a.sum() == b.sum()
        assert np.mean(a == b) >= 0.995
    j_psnr = np.asarray(j_metrics["psnr"])
    logged = ~np.isnan(j_psnr)
    np.testing.assert_array_equal(logged, ~np.isnan(res.metrics["psnr"]))
    np.testing.assert_allclose(res.metrics["psnr"][logged], j_psnr[logged], atol=0.05)
    for a, b in zip(params_to_numpy(res.params), jax.tree.map(np.asarray, j_params)):
        for k in ("w", "b"):
            assert np.abs(a[k] - b[k]).max() <= 1e-3 * np.abs(b[k]).max(), k
