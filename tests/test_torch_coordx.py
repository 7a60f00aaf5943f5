"""Port parity: CoordX (models/coordx.py), its separable fit path and the
sparsity modules over its layer shapes.

Weights are drawn by the JAX init and copied into the port; the forward
(separable and flat) must agree within 2e-6, and the gradients within
1e-4 of the largest reference gradient (the SIREN parity bound). RigL over
CoordX's layers, the two (1, C) first-branch layers included, must give the
same ERK densities and the same masks and topology updates as JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.sparsity import MaskingConfig as JMasking
from implicit_image_tpu.sparsity import core as jcore
from implicit_image_tpu.sparsity.init_scheme import erdos_renyi_probs as j_erk
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import make_fit_fn
from implicit_image_tpu_torch.convert import params_from_jax, params_to_numpy
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model, build_model_from_config, registry
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.sparsity import core as tcore
from implicit_image_tpu_torch.sparsity.init_scheme import erdos_renyi_probs as t_erk
from implicit_image_tpu_torch.training.fit import (
    OptimConfig,
    TrainConfig,
    fit,
    make_grad_fn,
)

torch.set_num_threads(1)

KEYS = ("w", "b")
ARCHS = [dict(depth=5, hidden_size=16, split_depth=2),
         dict(depth=8, hidden_size=24, split_depth=5),
         dict(depth=6, hidden_size=12, split_depth=3, fusion="sum")]


def _setup(arch, hw=(12, 10), seed=0):
    jm, jc = jbuild("coordx", **arch)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    m, c = build_model("coordx", **arch)
    grid = np.array(jgrid(*hw))
    target = np.random.default_rng(seed + 1).uniform(size=(hw[0] * hw[1], 3)).astype(np.float32)
    return jm, jc, m, c, p, grid, target


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jm, jc, m, c, p, grid, _ = _setup(arch)
    tp = params_from_jax(p, "cpu")
    coords = grid.reshape(-1, 2)
    sep = m.apply(tp, torch.from_numpy(grid), c).numpy()
    flat = m.apply_flat(tp, torch.from_numpy(coords), c).numpy()
    np.testing.assert_allclose(sep, np.asarray(jm.apply(p, grid, jc)), rtol=0, atol=2e-6)
    np.testing.assert_allclose(flat, np.asarray(jm.apply_flat(p, coords, jc)), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sep.reshape(-1, 3), flat, rtol=0, atol=2e-6)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_gradients_match_jax(arch):
    """Gradients of the separable MSE within 1e-4 of the largest reference
    gradient, layer by layer."""
    jm, jc, m, c, p, grid, target = _setup(arch, seed=3)
    tp = params_from_jax(p, "cpu")
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    loss = ((m.apply(tp, torch.from_numpy(grid), c).reshape(-1, 3)
             - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    jg = jax.grad(
        lambda q: jnp.mean((jm.apply(q, grid, jc).reshape(-1, 3) - target) ** 2))(p)
    for layer, ref in zip(tp, jg):
        for k in KEYS:
            r = np.asarray(ref[k])
            assert np.abs(layer[k].grad.numpy() - r).max() <= 1e-4 * np.abs(r).max(), k


def test_init_bounds_per_layer():
    """Per-layer bounds equal JAX's; each branch's first layer has fan_in 1
    and bound 1, the others sqrt(6/fan_in)/30; draws fill their bound."""
    arch = dict(depth=8, hidden_size=96, split_depth=5)
    _, jc = jbuild("coordx", **arch)
    m, c = build_model("coordx", **arch)
    assert [tuple(d) for d in c.layer_dims] == [tuple(d) for d in jc.layer_dims]
    assert len(c.layer_dims) == 13
    params = m.init(torch.Generator().manual_seed(0), c)
    for i, layer in enumerate(params):
        bound = c.weight_bound(i)
        assert bound == jc.weight_bound(i)
        assert tuple(layer["w"].shape) == tuple(c.layer_dims[i])
        w_max = float(layer["w"].abs().max())
        assert 0.9 * bound <= w_max <= bound, (i, w_max, bound)
        assert float(layer["b"].abs().max()) <= 1.0 / np.sqrt(c.layer_dims[i][0])
    assert c.weight_bound(0) == c.weight_bound(5) == 1.0
    assert c.weight_bound(1) == pytest.approx(np.sqrt(6.0 / 96) / 30.0)


def test_registry_and_precision():
    assert registry["coordx"]().separable and not registry["siren"]().separable
    m, c = build_model_from_config({"mlp": {"name": "coordx", "depth": 5, "hidden_size": 16,
                                            "split_depth": 2}, "masking": {"name": "none"}})
    assert m.name == "coordx" and c.split_depth == 2
    tp = m.init(torch.Generator().manual_seed(0), c)
    # one bf16 pass per product since the precision slice (tests/test_torch_precision.py)
    fp32, bf16 = (m.apply(tp, get_grid(4, 4), c, prec) for prec in ("fp32", "bf16"))
    assert torch.isfinite(bf16).all() and not torch.equal(fp32, bf16)
    with pytest.raises(ValueError):
        m.apply(tp, get_grid(4, 4), c, "tf32")
    with pytest.raises(ValueError):
        build_model("coordx", depth=4, split_depth=3)


def test_separable_loss_and_row_chunks_match_flat():
    """The fit's loss through the grid forward equals the flat forward's,
    and pixel_chunks=4 over whole row blocks accumulates the same gradient."""
    arch = ARCHS[0]
    _, _, m, c, p, grid, target = _setup(arch, hw=(8, 6), seed=5)
    coords = torch.from_numpy(grid.reshape(-1, 2))
    tgt = torch.from_numpy(target)
    tp = params_from_jax(p, "cpu")
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    results = [make_grad_fn(m, c, coords, tgt, "fp32", k, grid_hw=hw)(tp)
               for k, hw in ((1, (8, 6)), (4, (8, 6)), (1, None))]
    base_loss, base_grads = results[0]
    for loss, grads in results[1:]:
        assert float(loss) == pytest.approx(float(base_loss), rel=1e-6)
        for a, b in zip(grads, base_grads):
            for k in KEYS:
                torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("density", [0.85, 0.5, 0.1])
def test_erk_over_coordx_layers_equal(density):
    _, c = build_model("coordx", depth=8, hidden_size=96, split_depth=5)
    shapes = [tuple(d) for d in c.layer_dims]
    probs = t_erk(shapes, density)
    assert probs == j_erk(shapes, density)
    assert probs[0] == probs[5] == 1.0  # the (1, 96) layers come out dense


def test_update_connections_identical_on_coordx():
    """Two RigL topology updates over CoordX s5/w24 params from identical
    params, grads and masks: identical masks, params and MaskState scalars."""
    jm, jc = jbuild("coordx", depth=8, hidden_size=24, split_depth=5)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4), jc))
    rng = np.random.default_rng(12)
    grads = [{k: (rng.integers(0, 7, v.shape) / 8 * rng.choice([-1.0, 1.0], v.shape)
                  ).astype(np.float32) * 1e-3 for k, v in layer.items()} for layer in p]
    lottery = [(rng.uniform(size=layer["w"].shape) < 0.85).astype(np.float32) for layer in p]
    jcfg = jcore.MaskingConfig(density=0.85, sparse_init="lottery-ticket")
    tcfg = tcore.MaskingConfig(density=0.85, sparse_init="lottery-ticket")
    jstate = jcore.create_mask_state(jax.random.PRNGKey(0), p, jcfg, lottery_masks=lottery)
    tp = tuple({k: torch.from_numpy(v).clone() for k, v in layer.items()} for layer in p)
    tstate = tcore.create_mask_state(torch.Generator().manual_seed(0), tp, tcfg,
                                     lottery_masks=lottery)
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
            for k in KEYS:
                np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
        for field in ("baseline_nonzero", "total_params", "adjusted_growth", "adj_sum",
                      "adj_count"):
            assert float(getattr(tstate, field)) == float(getattr(jstate, field)), field


def test_rigl_coordx_fit_matches_jax(tmp_path):
    """A RigL CoordX fit from injected masks and a copied init (16x16, d5
    s2 w16, 40 steps, an update every 10 steps up to step 30, lr 1e-3,
    float32): the density array equals JAX's, the final masks agree on
    >= 99.5% of entries with equal per-layer counts, and the logged PSNR is
    within 0.05 dB."""
    arch = ARCHS[0]
    jm, jc = jbuild("coordx", **arch)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(6), jc))
    rng = np.random.default_rng(6)
    np.savez(tmp_path / "mask.npz", **{
        f"layers.{i}.mask": (rng.uniform(size=layer["w"].shape) < 0.85).astype(np.float32)
        for i, layer in enumerate(p)})
    kw = dict(density=0.85, sparse_init="lottery-ticket", mask_path=str(tmp_path / "mask.npz"),
              interval=10, end_when=30)
    img = synthetic_image(16, 16, seed=6)
    fit_fn = make_fit_fn(jm, jc, jgrid(16, 16),
                         JTrain(num_steps=40, log_steps=10, matmul_precision="float32"),
                         JOptim(lr=1e-3), JMasking(**kw), init_params=p)
    _, _, j_state, j_metrics = jax.jit(fit_fn)(jax.random.PRNGKey(0), jnp.asarray(img))

    m, c = build_model("coordx", **arch)
    res = fit(torch.Generator().manual_seed(0), m, c, get_grid(16, 16), img,
              TrainConfig(num_steps=40, log_steps=10, matmul_precision="float32"),
              OptimConfig(lr=1e-3), MaskingConfig(**kw), init_params=params_from_jax(p, "cpu"))
    # equal counts; the jitted JAX quotient may round an ulp away from the eager one
    np.testing.assert_allclose(res.metrics["density"], np.asarray(j_metrics["density"]),
                               rtol=0, atol=6e-8)
    for a, b in zip(res.mask_state.masks, j_state.masks):
        a, b = a.numpy(), np.asarray(b)
        assert a.sum() == b.sum()
        assert np.mean(a == b) >= 0.995
    j_psnr = np.asarray(j_metrics["psnr"])
    logged = ~np.isnan(j_psnr)
    assert logged.sum() == 4
    np.testing.assert_allclose(res.metrics["psnr"][logged], j_psnr[logged], atol=0.05)
    assert all(np.isfinite(params_to_numpy(res.params)[-1]["w"]).ravel())
