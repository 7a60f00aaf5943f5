"""Port parity: the precision options of the fit.

  * the precision schedule (train.matmul_precision_early / _switch): the
    port's plan equals the JAX package's plan_precision_schedule exactly
    (the switch step and the early mode), a switch that leaves no precise
    tail raises, and a fit runs every forward of a step before the switch
    (training step and in-loop eval) in the early mode and every later one
    in the main mode — read from the model calls here; on the card from
    LAUNCHES_BY_MODE (tests/test_torch_kernels.py, which holds this
    slice's card tests: that file imports no JAX);
  * train.mixed_precision ("+mixed"): SIREN's exact-sine chain equals the
    JAX package's compute_dtype=bfloat16 chain on the CPU up to the order of
    fp32 sums, forward within 1e-6 and gradients within 1e-5 of the largest
    (every bf16 rounding lands on the same value: the casts sit where JAX's
    do); the fused plain
    chain (the kernels' mirror, polynomial sine with the fast_cos
    derivative) equals its forward and holds its gradients to 2e-2 of the
    largest (a bf16 rounding of ga flips where the two derivatives differ
    in the last float bits); CoordX's forward is JAX's within 1e-6, its
    gradients within 3e-2 of the largest (JAX differentiates the fan-in-1
    layer and the fusion in bf16 arithmetic, the port rounds at the casts);
  * "bf16" products (one bf16 pass) for CoordX and the exact-sine SIREN: JAX
    on the CPU ignores the matmul precision, so they are held against a
    numpy emulation of one bf16 pass within 1e-5 and bounded against JAX's
    fp32 output within 5e-3;
  * mlp.fast_sine=false: the torch.sin chain against JAX's jnp.sin model,
    forward 2e-6 and gradients 1e-4 of the largest (the fp32 parity bounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import plan_precision_schedule as jplan
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import ModelDef, build_model
from implicit_image_tpu_torch.ops import sine_mlp as sm
from implicit_image_tpu_torch.training.fit import (
    OptimConfig,
    TrainConfig,
    fit,
    plan_precision_schedule,
    segment_boundaries,
)

torch.set_num_threads(1)

SCHEDULES = [(400, 0.75, "bfloat16"), (200, 0.75, None), (1200, 0.75, "bfloat16"),
             (7, 0.5, "bfloat16"), (10, 0.0, "bfloat16"), (20, 0.33, "bfloat16"),
             (3, 0.1, "bfloat16")]


@pytest.mark.parametrize("n,switch,early", SCHEDULES)
def test_plan_matches_jax(n, switch, early):
    kw = dict(num_steps=n, matmul_precision="tensorfloat32", matmul_precision_early=early,
              matmul_precision_switch=switch)
    j_early, j_switch, j_main, j_lens = jplan(JTrain(**kw), n, 2000)
    ours = plan_precision_schedule(TrainConfig(**kw), n)
    assert ours == ((sm.precision_from_config(j_early) if j_early else None), j_switch)
    # the boundaries: segments of the JAX chain, none straddling the switch
    bounds = segment_boundaries(n, 2000, j_switch)
    lens = np.diff([0] + bounds)
    assert set(lens[np.array(bounds) <= j_switch].tolist()) == (j_lens or set())


@pytest.mark.parametrize("n,switch", [(10, 1.0), (100, 1.5), (3, 0.9)])
def test_switch_without_a_precise_tail_raises(n, switch):
    tc = TrainConfig(num_steps=n, matmul_precision_early="bfloat16",
                     matmul_precision_switch=switch)
    with pytest.raises(ValueError, match="matmul_precision_switch"):
        plan_precision_schedule(tc, n)


def test_switch_one_raises_through_the_cli(tmp_path):
    cfg = compose(["img=synthetic", "img.height=8", "img.width=8", "mlp.depth=3",
                   "mlp.hidden_size=8", "train.num_steps=4", "masking=none", "quant=none",
                   "entropy_coding=none", "device=cpu", "train.matmul_precision_early=bfloat16",
                   "train.matmul_precision_switch=1.0"])
    with pytest.raises(ValueError, match="matmul_precision_switch"):
        tcompress.main(cfg, run_dir=str(tmp_path))


def _spy(mdef: ModelDef, calls: list) -> ModelDef:
    def apply_flat(params, coords, cfg, precision="fp32"):
        calls.append(precision)
        return mdef.apply_flat(params, coords, cfg, precision)

    return ModelDef(mdef.name, mdef.config_cls, mdef.init, mdef.apply, apply_flat)


@pytest.mark.parametrize("mixed", [False, True])
def test_fit_runs_each_step_in_its_planned_mode(mixed):
    """20 steps, evals every 5, switch 0.75 -> 15: every forward of steps
    0-14 (training and eval) in bf16, of steps 15-19 in fp32."""
    m, c = build_model("siren", depth=3, hidden_size=8)
    calls = []
    tc = TrainConfig(num_steps=20, log_steps=5, matmul_precision_early="bfloat16",
                     mixed_precision=mixed)
    img = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    res = fit(torch.Generator().manual_seed(0), _spy(m, calls), c, get_grid(8, 8), img, tc,
              OptimConfig(), device="cpu")
    suffix = sm.MIXED if mixed else ""
    expect = []
    for step in range(20):
        mode = ("bf16" if step < 15 else "fp32") + suffix
        expect += [mode] * (2 if (step + 1) % 5 == 0 else 1)
    assert calls == expect
    assert np.isfinite(res.metrics["psnr"][[4, 9, 14, 19]]).all()


def _setup(name, hw=(12, 10), seed=0, **arch):
    jm, jc = jbuild(name, **arch)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    m, c = build_model(name, **arch)
    grid = np.array(jgrid(*hw))
    target = np.random.default_rng(seed + 1).uniform(size=(hw[0] * hw[1], 3)).astype(np.float32)
    return jm, jc, m, c, p, grid, target


def _jax_run(jm, jc, p, grid, target, dtype=None):
    def loss(pp):
        if jm.separable:
            out = jm.apply(pp, jnp.asarray(grid), jc, dtype).reshape(-1, target.shape[1])
        else:
            out = jm.apply_flat(pp, jnp.asarray(grid.reshape(-1, 2)), jc, dtype)
        return jnp.mean((out - target) ** 2), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(p)
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _torch_run(m, c, p, grid, target, precision):
    tp = params_from_jax(p, "cpu")
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    if m.separable:
        out = m.apply(tp, torch.from_numpy(grid), c, precision).reshape(-1, target.shape[1])
    else:
        out = m.apply_flat(tp, torch.from_numpy(grid.reshape(-1, 2)), c, precision)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    return out.detach().numpy(), [{k: v.grad.numpy() for k, v in layer.items()} for layer in tp]


def _grad_err(ours, ref):
    return max(np.abs(a[k] - np.asarray(b[k])).max() / np.abs(np.asarray(b[k])).max()
               for a, b in zip(ours, ref) for k in a)


@pytest.mark.parametrize("arch", [dict(depth=4, hidden_size=32), dict(depth=6, hidden_size=48)])
def test_mixed_exact_sine_siren_matches_jax(arch):
    jm, jc, m, c, p, grid, target = _setup("siren", fast_sine=False, **arch)
    jout, jgrads = _jax_run(jm, jc, p, grid, target, jnp.bfloat16)
    out, grads = _torch_run(m, c, p, grid, target, "fp32" + sm.MIXED)
    assert np.abs(out - jout).max() <= 1e-6
    assert _grad_err(grads, jgrads) <= 1e-5


@pytest.mark.parametrize("arch", [dict(depth=4, hidden_size=32), dict(depth=6, hidden_size=48)])
def test_mixed_fused_siren_matches_jax(arch):
    jm, jc, m, c, p, grid, target = _setup("siren", **arch)
    jout, jgrads = _jax_run(jm, jc, p, grid, target, jnp.bfloat16)
    out, grads = _torch_run(m, c, p, grid, target, "fp32" + sm.MIXED)
    assert np.abs(out - jout).max() <= 1e-6
    assert _grad_err(grads, jgrads) <= 2e-2
    # mixed is not the bf16 mode: the bf16 mode leaves b unrounded and
    # rounds gz, not ga
    bout, bgrads = _torch_run(m, c, p, grid, target, "bf16")
    assert _grad_err(bgrads, grads) > 0.0


@pytest.mark.parametrize("arch", [dict(depth=5, hidden_size=16, split_depth=2),
                                  dict(depth=6, hidden_size=16, split_depth=3, fusion="sum")])
@pytest.mark.parametrize("fast_sine", [True, False])
def test_mixed_coordx_matches_jax(arch, fast_sine):
    jm, jc, m, c, p, grid, target = _setup("coordx", fast_sine=fast_sine, **arch)
    jout, jgrads = _jax_run(jm, jc, p, grid, target, jnp.bfloat16)
    out, grads = _torch_run(m, c, p, grid, target, "fp32" + sm.MIXED)
    assert np.abs(out - jout).max() <= 1e-6
    assert _grad_err(grads, jgrads) <= 3e-2


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 to bf16 (nearest even) and back, by the bits."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _np_coordx_bf16(p, grid, cfg):
    """CoordX's grid forward with every product one bf16 pass, in numpy."""
    from implicit_image_tpu_torch.ops.fast_math import fast_sin

    def sin(x):
        return fast_sin(torch.from_numpy(np.asarray(x, np.float32))).numpy()

    def dot(a, w):
        return (_bf16(a).astype(np.float64) @ _bf16(w).astype(np.float64)).astype(np.float32)

    s = cfg.split_depth
    h, w = grid.shape[:2]

    def branch(layers, x):
        for i, layer in enumerate(layers):
            om = cfg.first_omega_0 if i == 0 else cfg.hidden_omega_0
            z = x * layer["w"][0] + layer["b"] if layer["w"].shape[0] == 1 else \
                dot(x, layer["w"]) + layer["b"]
            x = sin(om * z)
        return x

    fy = branch(p[s:2 * s], (grid[:, 0, 0:1] - 0.5) * 2.0)
    fx = branch(p[:s], (grid[0, :, 1:2] - 0.5) * 2.0)
    z = ((fy[:, None, :] * fx[None, :, :]) * np.float32(np.sqrt(2.0))).reshape(h * w, -1)
    for i, layer in enumerate(p[2 * s:]):
        z = dot(z, layer["w"]) + layer["b"]
        if i < len(p) - 2 * s - 1:
            z = sin(cfg.hidden_omega_0 * z)
    return z / 2.0 + 0.5


def test_coordx_bf16_products_are_one_bf16_pass():
    jm, jc, m, c, p, grid, target = _setup("coordx", depth=5, hidden_size=16, split_depth=2)
    out, grads = _torch_run(m, c, p, grid, target, "bf16")
    ref = _np_coordx_bf16(p, grid, c)
    assert np.abs(out - ref).max() <= 1e-5
    jout, jgrads = _jax_run(jm, jc, p, grid, target)  # JAX on the CPU: fp32
    assert 0.0 < np.abs(out - jout).max() <= 5e-3
    assert _grad_err(grads, jgrads) <= 5e-2


def test_bf16_matmul_backward_is_one_pass():
    from implicit_image_tpu_torch.ops.precision import matmul

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)).requires_grad_(True)
    g = rng.standard_normal((7, 3)).astype(np.float32)
    matmul(a, b, True).backward(torch.from_numpy(g))
    ga = (_bf16(g).astype(np.float64) @ _bf16(b.detach().numpy()).astype(np.float64).T)
    gb = (_bf16(a.detach().numpy()).astype(np.float64).T @ _bf16(g).astype(np.float64))
    np.testing.assert_allclose(a.grad.numpy(), ga, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), gb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", [dict(depth=4, hidden_size=32),
                                  dict(depth=5, hidden_size=24, outermost_linear=False)])
def test_exact_sine_siren_matches_jax(arch):
    jm, jc, m, c, p, grid, target = _setup("siren", fast_sine=False, **arch)
    jout, jgrads = _jax_run(jm, jc, p, grid, target)
    out, grads = _torch_run(m, c, p, grid, target, "fp32")
    assert np.abs(out - jout).max() <= 2e-6
    assert _grad_err(grads, jgrads) <= 1e-4


def test_exact_sine_fit_launches_nothing(tmp_path):
    """A fast_sine=false run takes the torch.sin chain: the kernels' counts
    stay where they were (on the CPU they would anyway; the card phase 12f
    reads 0), and it fits."""
    before = {k: dict(v) for k, v in sm.LAUNCHES_BY_MODE.items()}
    psnr, _ = tcompress.main(compose([
        "img=synthetic", "img.height=12", "img.width=12", "mlp.depth=3", "mlp.hidden_size=16",
        "mlp.fast_sine=false", "train.num_steps=30", "train.log_steps=30", "masking=none",
        "quant=none", "entropy_coding=none", "device=cpu"]), run_dir=str(tmp_path))
    assert np.isfinite(psnr) and psnr > 10.0
    assert sm.LAUNCHES_BY_MODE == before


# Fourier and Feathermap in every precision mode. JAX on the CPU ignores the
# matmul precision, so "bf16" is held against a numpy emulation of one bf16
# pass (within 1e-5, CoordX's bound); under "+mixed" JAX's casts are real on
# the CPU: the forward within 1e-6 and the gradients within 3e-2 of the
# largest, CoordX's mixed bounds.

def _np_fourier_bf16(p, grid):
    def dot(a, w):
        return (_bf16(a).astype(np.float64) @ _bf16(w).astype(np.float64)).astype(np.float32)

    xp = dot(np.float32(2.0 * np.pi) * grid.reshape(-1, 2), p[0]["B"])
    x = np.concatenate([np.sin(xp), np.cos(xp)], axis=-1)
    for i, layer in enumerate(p[1:]):
        x = dot(x, layer["w"]) + layer["b"]
        if i < len(p) - 2:
            x = np.maximum(x, 0.0)
    return 1.0 / (1.0 + np.exp(-x.astype(np.float64)))


FOURIER = dict(depth=4, hidden_size=16, map_size=16, map_scale=4.0)


def test_fourier_bf16_products_are_one_bf16_pass():
    jm, jc, m, c, p, grid, target = _setup("fourier", **FOURIER)
    out, grads = _torch_run(m, c, p, grid, target, "bf16")
    assert np.abs(out - _np_fourier_bf16(p, grid)).max() <= 1e-5
    fp32, _ = _torch_run(m, c, p, grid, target, "fp32")
    assert np.abs(out - fp32).max() > 0.0  # the bf16 pass is not the fp32 product
    assert all(np.isfinite(layer[k]).all() for layer in grads for k in layer)


def test_mixed_fourier_matches_jax():
    jm, jc, m, c, p, grid, target = _setup("fourier", **FOURIER)
    jout, jgrads = _jax_run(jm, jc, p, grid, target, jnp.bfloat16)
    out, grads = _torch_run(m, c, p, grid, target, "fp32" + sm.MIXED)
    assert np.abs(out - jout).max() <= 1e-6
    assert _grad_err(grads, [layer for layer in jgrads]) <= 3e-2


def _feather_pair(seed=0):
    from implicit_image_tpu.feathermap import build_feather_model as jfeather
    from implicit_image_tpu_torch.feathermap import build_feather_model

    jm, jc, m, c, _, grid, target = _setup("siren", depth=4, hidden_size=16, seed=seed)
    jfm, fm = jfeather(jm, jc, 0.5), build_feather_model(m, c, 0.5)
    p = jax.tree.map(np.asarray, jfm.init(jax.random.PRNGKey(seed), jc))
    return jfm, jc, fm, c, p, grid, target


def test_feathermap_bf16_product_is_one_bf16_pass():
    """V1 @ V2 in one bf16 pass under "bf16" (the base SIREN then runs its
    bf16 chain), a true fp32 product otherwise."""
    from implicit_image_tpu_torch.feathermap import _plan, materialize

    jfm, jc, fm, c, p, grid, target = _feather_pair()
    tp = params_from_jax(p, "cpu")
    spec = _plan(build_model("siren", depth=4, hidden_size=16)[0].init(
        torch.Generator().manual_seed(0), c), 0.5)
    ref = (_bf16(p[0]["w"]).astype(np.float64) @ _bf16(p[1]["w"]).astype(np.float64)
           ).astype(np.float32).reshape(-1)
    base = materialize(tp, spec, bf16=True)
    for idx, (layer, key, shape, offset) in enumerate(spec.entries):
        expect = p[2]["b"][idx] * ref[offset:offset + int(np.prod(shape))].reshape(shape)
        np.testing.assert_allclose(base[layer][key].numpy(), expect, rtol=1e-6, atol=1e-7)
    coords = torch.from_numpy(grid.reshape(-1, 2))
    assert (fm.apply_flat(tp, coords, c, "bf16") - fm.apply_flat(tp, coords, c, "fp32")
            ).abs().max() > 0.0


def test_mixed_feathermap_matches_jax():
    """Under "+mixed" V1 @ V2 stays fp32 and the base SIREN casts what it
    reads, as the JAX package's compute_dtype=bfloat16; the fused chain's
    mixed bounds (test_mixed_fused_siren_matches_jax)."""
    jfm, jc, fm, c, p, grid, target = _feather_pair(1)
    jout, jgrads = _jax_run(jfm, jc, p, grid, target, jnp.bfloat16)
    out, grads = _torch_run(fm, c, p, grid, target, "fp32" + sm.MIXED)
    assert np.abs(out - jout).max() <= 1e-6
    assert _grad_err(grads, jgrads) <= 2e-2


@pytest.mark.parametrize("family", ["fourier", "feathermap"])
def test_schedule_runs_fourier_and_feathermap_in_their_planned_modes(family):
    """The precision schedule (20 steps, switch 0.75) over Fourier and
    Feathermap: every forward of steps 0-14 in bf16, of 15-19 in fp32."""
    from implicit_image_tpu_torch.feathermap import build_feather_model

    if family == "fourier":
        m, c = build_model("fourier", **FOURIER)
    else:
        base, c = build_model("siren", depth=3, hidden_size=8)
        m = build_feather_model(base, c, 0.5)
    calls = []
    tc = TrainConfig(num_steps=20, log_steps=5, matmul_precision_early="bfloat16")
    img = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    res = fit(torch.Generator().manual_seed(0), _spy(m, calls), c, get_grid(8, 8), img, tc,
              OptimConfig(), device="cpu")
    expect = []
    for step in range(20):
        expect += ["bf16" if step < 15 else "fp32"] * (2 if (step + 1) % 5 == 0 else 1)
    assert calls == expect
    assert np.isfinite(res.metrics["psnr"][[4, 9, 14, 19]]).all()
