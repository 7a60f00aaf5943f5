"""Port parity: Shampoo (optim/shampoo.py), its momentum in the sparsity
code (optim.adam_momentum, sparsity.mask_momentum) and a Shampoo fit.

P^(-1/order) is a function of P, so it compares across packages directly
(no eigenvector sign or rotation enters it). Tolerances: 5 steps of
shampoo_update from the same numpy params and grads within 1e-4 of the
largest parameter: the first step agrees to 6e-8, then the fp32
eigendecompositions of two LAPACK calls feed back through the momentum
(the preconditioned grad enters the next Gram), ungrafted through
preconditioners whose condition number reaches ~6,000 by step 5 (the
update_freq 3 cases read 5e-6 to 9e-5); the momentum statistics within
1e-6 relative; a 10-step fit within 1e-4 of the largest weight (the fit
parity bound of tests/test_torch_optim.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import optim as joptim
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.sparsity import mask_momentum as j_mask_momentum
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import fit as jfit
from implicit_image_tpu_torch.convert import params_from_jax, params_to_numpy
from implicit_image_tpu_torch.data import get_grid, synthetic_image
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.optim import adam_momentum, opt_init, opt_update
from implicit_image_tpu_torch.optim.shampoo import ShampooState, inverse_roots
from implicit_image_tpu_torch.sparsity import mask_momentum
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return ({"B": rng.standard_normal((2, 3)).astype(np.float32)},
            {"w": (rng.standard_normal((6, 5)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal(5) * 0.1).astype(np.float32)},
            {"w": (rng.standard_normal((5, 3)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal(3) * 0.1).astype(np.float32)})


def _grads(rng, params):
    return tuple({k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
                  for k, v in layer.items() if k != "B"} for layer in params)


@pytest.mark.parametrize("update_freq", [1, 3])
@pytest.mark.parametrize("graft_norm", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_shampoo_update_matches_jax(update_freq, graft_norm, weight_decay):
    """5 steps of the update, the frozen leaf B untouched in both."""
    kw = dict(name="shampoo", lr=0.05, momentum=0.9, weight_decay=weight_decay, epsilon=0.1,
              update_freq=update_freq, graft_norm=graft_norm)
    jcfg, tcfg = JOptim(**kw), OptimConfig(**kw)
    p = _params()
    jp = jax.tree.map(jnp.asarray, p)
    jst = joptim.opt_init(jp, jcfg)
    tp = params_from_jax(p, "cpu")
    tst = opt_init(tp, tcfg)
    assert isinstance(tst, ShampooState)
    rng = np.random.default_rng(1)
    for step in range(5):
        g = _grads(rng, p)
        jg = tuple({**layer, **({"B": jnp.zeros((2, 3))} if i == 0 else {})}
                   for i, layer in enumerate(jax.tree.map(jnp.asarray, g)))
        jp, jst = joptim.opt_update(jg, jst, jp, 0.05, jcfg)
        tp, tst = opt_update(params_from_jax(g, "cpu"), tst, tp, 0.05, tcfg)
        scale = max(float(np.abs(np.asarray(layer[k])).max()) for layer in jp for k in layer)
        for a, b in zip(params_to_numpy(tp), jp):
            for k in a:
                assert np.abs(a[k] - np.asarray(b[k])).max() <= 1e-4 * scale, (step, k)
    assert tst.count == 5
    np.testing.assert_array_equal(tp[0]["B"].numpy(), p[0]["B"])


def test_inverse_roots_batched_equal_each_alone():
    """One batched eigh per shape gives each matrix's own root bit for bit."""
    rng = np.random.default_rng(2)
    mats = []
    for d in (4, 4, 3, 4):
        a = rng.standard_normal((d, d + 2)).astype(np.float32)
        mats.append(torch.from_numpy(a @ a.T + 0.1 * np.eye(d, dtype=np.float32)))
    together = inverse_roots(mats, 2)
    for m, r in zip(mats, together):
        assert torch.equal(inverse_roots([m], 2)[0], r)
        w, v = np.linalg.eigh(m.numpy().astype(np.float64))
        np.testing.assert_allclose(r.numpy(), (v * w ** -0.5) @ v.T, rtol=0, atol=1e-5)


def test_momentum_and_mask_momentum_on_shampoo_state():
    """adam_momentum reads Shampoo's momentum buffer (the JAX package's
    rule for SGD-like states); mask_momentum masks it; an unknown state
    raises TypeError in both packages."""
    cfg_kw = dict(name="shampoo", lr=0.05, epsilon=0.1)
    p = _params(3)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_jax(p, "cpu")
    jst, tst = joptim.opt_init(jp, JOptim(**cfg_kw)), opt_init(tp, OptimConfig(**cfg_kw))
    rng = np.random.default_rng(4)
    for _ in range(2):
        g = _grads(rng, p)
        jg = tuple({**layer, **({"B": jnp.zeros((2, 3))} if i == 0 else {})}
                   for i, layer in enumerate(jax.tree.map(jnp.asarray, g)))
        jp, jst = joptim.opt_update(jg, jst, jp, 0.05, JOptim(**cfg_kw))
        tp, tst = opt_update(params_from_jax(g, "cpu"), tst, tp, 0.05, OptimConfig(**cfg_kw))
    for i in (1, 2):
        np.testing.assert_allclose(adam_momentum(tst, i).numpy(),
                                   np.asarray(joptim.adam_momentum(jst, i)), rtol=1e-6,
                                   atol=1e-6)
    masks = (None, (rng.uniform(size=(6, 5)) < 0.5).astype(np.float32), None)
    jm = j_mask_momentum(jst, tuple(None if m is None else jnp.asarray(m) for m in masks))
    tm = mask_momentum(tst, tuple(None if m is None else torch.from_numpy(m) for m in masks))
    assert tm is tst
    assert not tst.momentum_buf[1]["w"][masks[1] == 0].any()
    np.testing.assert_allclose(tst.momentum_buf[1]["w"].numpy(),
                               np.asarray(jm.momentum_buf[1]["w"]), rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError):
        mask_momentum(object(), masks)
    with pytest.raises(TypeError):
        j_mask_momentum(object(), masks)


@pytest.mark.parametrize("masking,epsilon", [(None, 1e-4), ("RigL", 0.1)])
def test_shampoo_fit_matches_jax(tmp_path, masking, epsilon):
    """10 steps of a d3/w16 SIREN at conf/optim/shampoo.yaml's settings (lr
    0.1, graft_norm), dense and under RigL from one lottery mask (an update
    at step 5). Under the mask at the conf's epsilon 1e-4 the trajectory is
    chaotic in each package alone: a 1e-6 relative change of the init moves
    JAX's own params 2e-2 (the port's 5e-2) by step 5. So the sparse case
    runs at epsilon 0.1, which keeps the preconditioners well conditioned
    (as the JAX package's own Shampoo mirror test does)."""
    from implicit_image_tpu.sparsity import MaskingConfig as JMasking
    from implicit_image_tpu_torch.sparsity import MaskingConfig

    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5), jc))
    img = synthetic_image(12, 12, seed=6)
    kw = dict(name="shampoo", lr=0.1, momentum=0.9, epsilon=epsilon, update_freq=1,
              graft_norm=True)
    mkw, jmask, tmask = {}, None, None
    if masking:
        rng = np.random.default_rng(7)
        path = tmp_path / "mask.npz"
        np.savez(path, **{f"layers.{i}.mask": (rng.uniform(size=d) < 0.5).astype(np.float32)
                          for i, d in enumerate(jc.layer_dims)})
        mkw = dict(density=0.5, sparse_init="lottery-ticket", mask_path=str(path), interval=5,
                   end_when=8)
        jmask, tmask = JMasking(**mkw), MaskingConfig(**mkw)
    jres = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(12, 12), img,
                JTrain(num_steps=10, log_steps=10, matmul_precision="tensorfloat32"),
                JOptim(**kw), jmask, init_params=jax.tree.map(jnp.asarray, init))
    m, c = build_model("siren", depth=3, hidden_size=16)
    tres = fit(torch.Generator().manual_seed(0), m, c, get_grid(12, 12), img,
               TrainConfig(num_steps=10, log_steps=10), OptimConfig(**kw), tmask,
               init_params=params_from_jax(init, "cpu"), device="cpu")
    assert isinstance(tres.opt_state, ShampooState)
    for a, b in zip(params_to_numpy(tres.params), jres.params):
        for k in a:
            ref = np.asarray(b[k])
            assert np.abs(a[k] - ref).max() <= 1e-4 * np.abs(ref).max(), k
    if masking:
        for tm_, jm_ in zip(tres.mask_state.masks, jres.mask_state.masks):
            if tm_ is not None:
                np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))


def test_shampoo_refuses_checkpoints(tmp_path):
    m, c = build_model("siren", depth=3, hidden_size=8)
    with pytest.raises(ValueError, match="adam"):
        fit(torch.Generator().manual_seed(0), m, c, get_grid(8, 8), synthetic_image(8, 8),
            TrainConfig(num_steps=2), OptimConfig(name="shampoo"), device="cpu",
            checkpoint_path=tmp_path / "ck.npz")
