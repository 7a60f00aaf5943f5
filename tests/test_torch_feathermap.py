"""Port parity: the Feathermap wrap (feathermap/__init__.py).

The layout (_plan), the scalers' init, `materialize` and
`materialize_tensor` agree with the JAX package; over SIREN the wrapped
forward agrees within 1e-5 and the gradients into V1, V2 and the scalers
within 1e-4 of the largest reference gradient (the materialized weights go
through the fused chain). Over Fourier, B rides along as the frozen extra
`frozen_0_B` and takes no gradient or step; over CoordX the wrap keeps the
separable grid path.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import feathermap as jfm
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.models import build_model_from_config as jbuild_cfg
from implicit_image_tpu_torch import feathermap as tfm
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid, synthetic_image
from implicit_image_tpu_torch.models import build_model, build_model_from_config
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit, make_grad_fn

torch.set_num_threads(1)


def _cfg(mlp: dict, density=0.2):
    return {"mlp": mlp, "masking": {"name": "Feathermap", "dense": True, "density": density}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name,arch,density", [
    ("siren", dict(depth=8, hidden_size=128), 0.2),
    ("siren", dict(depth=4, hidden_size=16), 0.5),
    ("fourier", dict(depth=4, hidden_size=16, map_size=16), 0.3),
    ("wavelet_siren", dict(depth=4, hidden_size=16, height=16, width=16), 0.2),
    ("coordx", dict(depth=5, hidden_size=16, split_depth=2), 0.4),
])
def test_plan_and_scalers_match_jax(name, arch, density):
    jm, jc = jbuild(name, **arch)
    base = _np(jm.init(jax.random.PRNGKey(0), jc))
    jf, jspec, jfrozen = jfm.feather_init(jax.random.PRNGKey(1), base, jc, density)
    m, c = build_model(name, **arch)
    tbase = params_from_jax(base, "cpu")
    fparams, spec, frozen = tfm.feather_init(torch.Generator().manual_seed(0), tbase, c,
                                             density)
    assert (spec.entries, spec.size_n, spec.size_m, spec.compress) == (
        jspec.entries, jspec.size_n, jspec.size_m, jspec.compress)
    assert spec.total == sum(v.numel() for layer in tbase for k, v in layer.items()
                             if k in ("w", "b"))
    np.testing.assert_array_equal(fparams[2]["b"].numpy(), np.asarray(jf[2]["b"]))
    assert sorted(frozen) == sorted(jfrozen)
    assert tuple(fparams[0]["w"].shape) == (spec.size_n, spec.size_m)
    assert tuple(fparams[1]["w"].shape) == (spec.size_m, spec.size_n)
    bound = math.sqrt(12.0) / 2.0 * spec.size_m ** (-0.25)
    assert float(fparams[0]["w"].abs().max()) <= bound
    if name == "siren" and arch["hidden_size"] == 128:
        assert (spec.total, spec.size_n, spec.size_m) == (99_843, 316, 32)


def _feather_setup(mlp: dict, density=0.2, seed=0):
    jm, jc = jbuild_cfg(_cfg(mlp, density))
    p = _np(jm.init(jax.random.PRNGKey(seed), jc))
    m, c = build_model_from_config(_cfg(mlp, density))
    return jm, jc, p, m, c


def test_materialize_matches_jax():
    arch = dict(depth=4, hidden_size=16)
    jm, jc = jbuild("siren", **arch)
    base = _np(jm.init(jax.random.PRNGKey(0), jc))
    jf, spec, _ = jfm.feather_init(jax.random.PRNGKey(2), base, jc, 0.5)
    jf = _np(jf)
    tf = params_from_jax(jf, "cpu")
    theirs = _np(jfm.materialize(jf, spec))
    ours = tfm.materialize(tf, spec)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k], rtol=0, atol=1e-6)
    for idx, (layer, key, _, _) in enumerate(spec.entries):
        one = tfm.materialize_tensor(tf, spec, idx).numpy()
        np.testing.assert_allclose(one, np.asarray(jfm.materialize_tensor(jf, spec, idx)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(one, ours[layer][key].numpy(), rtol=0, atol=1e-6)


def test_siren_forward_and_gradients_match_jax():
    """Feathermap over SIREN d4/w16 at 16x16: forward within 1e-5, the
    gradients into V1, V2 and the scalers within 1e-4 relative."""
    hw = (16, 16)
    jm, jc, p, m, c = _feather_setup({"name": "siren", "depth": 4, "hidden_size": 16},
                                     density=0.5, seed=3)
    assert m.name == "feather_siren" and not m.separable
    tp = params_from_jax(p, "cpu")
    np.testing.assert_allclose(m.apply(tp, get_grid(*hw), c).numpy(),
                               np.asarray(jm.apply(p, jgrid(*hw), jc)), rtol=0, atol=1e-5)
    target = synthetic_image(*hw, seed=3)
    jg = jax.grad(lambda q: jnp.mean(
        (jm.apply_flat(q, jgrid(*hw).reshape(-1, 2), jc) - target.reshape(-1, 3)) ** 2))(p)
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    _, grads = make_grad_fn(m, c, get_grid(*hw).reshape(-1, 2),
                            torch.from_numpy(target).reshape(-1, 3), "fp32")(tp)
    for i, k in ((0, "w"), (1, "w"), (2, "b")):
        ref = np.asarray(jg[i][k])
        assert np.abs(grads[i][k].numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), (i, k)


def test_fourier_wrap_keeps_b_frozen():
    """B travels in layer 2 as frozen_0_B: the forward agrees with JAX's,
    the grads hold no entry for it and a fit leaves it bit for bit."""
    hw = (12, 12)
    jm, jc, p, m, c = _feather_setup(
        {"name": "fourier", "depth": 4, "hidden_size": 16, "map_size": 16}, seed=4)
    assert sorted(p[2]) == ["b", "frozen_0_B"]
    tp = params_from_jax(p, "cpu")
    np.testing.assert_allclose(m.apply(tp, get_grid(*hw), c).numpy(),
                               np.asarray(jm.apply(p, jgrid(*hw), jc)), rtol=0, atol=1e-6)
    img = synthetic_image(*hw, seed=4)
    res = fit(None, m, c, get_grid(*hw), img,
              TrainConfig(num_steps=4, log_steps=4, matmul_precision="float32"),
              OptimConfig(lr=1e-2), init_params=tp)
    torch.testing.assert_close(res.params[2]["frozen_0_B"], tp[2]["frozen_0_B"], rtol=0,
                               atol=0)
    assert not res.params[2]["frozen_0_B"].requires_grad
    assert not torch.equal(res.params[2]["b"], tp[2]["b"])
    _, grads = make_grad_fn(m, c, get_grid(*hw).reshape(-1, 2),
                            torch.from_numpy(img).reshape(-1, 3), "fp32")(
        tuple({k: v.requires_grad_(k != "frozen_0_B") for k, v in layer.items()}
              for layer in res.params))
    assert sorted(grads[2]) == ["b"]


def test_coordx_wrap_keeps_separable():
    hw = (8, 10)
    jm, jc, p, m, c = _feather_setup(
        {"name": "coordx", "depth": 5, "hidden_size": 16, "split_depth": 2}, seed=5)
    assert m.separable and m.name == "feather_coordx"
    tp = params_from_jax(p, "cpu")
    grid = get_grid(*hw)
    np.testing.assert_allclose(m.apply(tp, grid, c).numpy(),
                               np.asarray(jm.apply(p, jgrid(*hw), jc)), rtol=0, atol=2e-6)
    np.testing.assert_allclose(m.apply_flat(tp, grid.reshape(-1, 2), c).numpy().reshape(
        hw + (3,)), m.apply(tp, grid, c).numpy(), rtol=0, atol=2e-6)


def test_init_draws_base_then_v1_v2():
    m, c = build_model_from_config(_cfg({"name": "fourier", "depth": 4, "hidden_size": 16,
                                         "map_size": 16}))
    params = m.init(torch.Generator().manual_seed(7), c)
    base_m, base_c = build_model("fourier", depth=4, hidden_size=16, map_size=16)
    gen = torch.Generator().manual_seed(7)
    base = base_m.init(gen, base_c)
    want, _, _ = tfm.feather_init(gen, base, base_c, 0.2)
    torch.testing.assert_close(params[0]["w"], want[0]["w"], rtol=0, atol=0)
    torch.testing.assert_close(params[2]["frozen_0_B"], base[0]["B"], rtol=0, atol=0)
    assert [list(layer) for layer in params] == [["w"], ["w"], ["b", "frozen_0_B"]]
