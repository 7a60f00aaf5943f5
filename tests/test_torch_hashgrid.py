"""Port parity: the hashgrid family (models/hashgrid.py).

Weights come from the JAX init (the table widened to U(±1) so that the
features matter) and are copied into the port. Tolerances: the level
schedule, the hashed levels' static index tables and the init's shapes
equal; the forward of both paths within 2e-6 (fp32; XLA and torch sum in
other orders); the gradients of the table (hashed and direct levels) and
the MLP within 1e-5 of the largest; under "+mixed" the forward within 1e-6
and the gradients within 1e-2 of the largest (bf16 roundings of
cotangents that JAX sums in another order); a 30-step fit's PSNR within
0.05 dB. Run directories decode across packages to the same weights.
The flat path is forward-only: its backward raises, and neither the fit
nor the codebook finetune reaches it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import compress as jcompress
from implicit_image_tpu import decompress as jdecompress
from implicit_image_tpu.coding import decompress_state_dict as jdecompress_state
from implicit_image_tpu.config import compose as jcompose
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.models.hashgrid import _hashed_level_tables as j_tables
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import fit as jfit
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch import decompress as tdecompress
from implicit_image_tpu_torch.coding import decompress_state_dict
from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model, registry
from implicit_image_tpu_torch.models.hashgrid import hashed_level_tables
from implicit_image_tpu_torch.ops import sine_mlp as sm
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit
from implicit_image_tpu_torch.training.quant_phase import quant_finetune

torch.set_num_threads(1)

# small pyramids with direct and hashed levels (cap 64 rows: r <= 7 direct)
ARCHS = [dict(n_levels=4, log2_table_size=6, base_resolution=4, finest_resolution=16,
              hidden_size=8),
         dict(n_levels=5, features=4, log2_table_size=7, base_resolution=3,
              finest_resolution=40, depth=4, hidden_size=12)]
CONFIGS = [{}, dict(n_levels=16, finest_resolution=2048), dict(n_levels=1),
           dict(base_resolution=16, finest_resolution=64, n_levels=3)] + ARCHS


@pytest.mark.parametrize("arch", CONFIGS)
def test_level_schedule_matches_jax(arch):
    _, jc = jbuild("hashgrid", **arch)
    _, c = build_model("hashgrid", **arch)
    for name in ("level_resolutions", "level_table_sizes", "level_offsets", "table_rows",
                 "mlp_dims"):
        ours, theirs = getattr(c, name), getattr(jc, name)
        assert (list(ours) if name != "table_rows" else ours) == \
            (list(theirs) if name != "table_rows" else theirs), name


@pytest.mark.parametrize("r,cap", [(8, 64), (30, 128), (181, 4096), (512, 4096)])
def test_hashed_level_tables_match_jax(r, cap):
    idx, inv = hashed_level_tables(r, cap)
    jidx, jinv = j_tables(r, cap)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(inv, jinv)


def test_registry_and_init_layout():
    m, c = build_model("hashgrid", **ARCHS[1])
    assert registry["hashgrid"]().separable
    jm, jc = jbuild("hashgrid", **ARCHS[1])
    jp = jm.init(jax.random.PRNGKey(0), jc)
    tp = m.init(torch.Generator().manual_seed(0), c)
    assert [sorted(layer) for layer in tp] == [sorted(layer) for layer in jp]
    for a, b in zip(tp, jp):
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape)
    assert float(tp[0]["w"].abs().max()) <= 1e-4
    for layer, (fan_in, _) in zip(tp[1:], c.mlp_dims):
        assert float(layer["w"].abs().max()) <= np.sqrt(6.0 / fan_in)
        assert float(layer["b"].abs().max()) <= 1.0 / np.sqrt(fan_in)


def _setup(arch, hw=(12, 10), seed=0):
    jm, jc = jbuild("hashgrid", **arch)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    table = np.random.default_rng(seed + 3).uniform(-1, 1, p[0]["w"].shape).astype(np.float32)
    p = ({"w": table},) + tuple(p[1:])
    m, c = build_model("hashgrid", **arch)
    grid = np.array(jgrid(*hw))
    target = np.random.default_rng(seed + 1).uniform(size=(hw[0] * hw[1], 3)).astype(np.float32)
    return jm, jc, m, c, p, grid, target


def _grads(m, c, p, grid, target, precision="fp32"):
    tp = params_from_jax(p, "cpu")
    for layer in tp:
        for v in layer.values():
            v.requires_grad_(True)
    out = m.apply(tp, torch.from_numpy(grid), c, precision).reshape(-1, 3)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    return out.detach().numpy(), [{k: v.grad.numpy() for k, v in layer.items()} for layer in tp]


def _jgrads(jm, jc, p, grid, target, dtype=None):
    def loss(pp):
        out = jm.apply(pp, jnp.asarray(grid), jc, dtype).reshape(-1, 3)
        return jnp.mean((out - target) ** 2), out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(p)
    return np.asarray(out), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("hw", [(12, 10), (17, 17)])
def test_forward_both_paths_match_jax(arch, hw):
    jm, jc, m, c, p, grid, _ = _setup(arch, hw)
    tp = params_from_jax(p, "cpu")
    ref = np.asarray(jm.apply(p, jnp.asarray(grid), jc))
    ref_flat = np.asarray(jm.apply_flat(p, jnp.asarray(grid.reshape(-1, 2)), jc))
    with torch.no_grad():
        ours = m.apply(tp, torch.from_numpy(grid), c).numpy()
        ours_flat = m.apply_flat(tp, torch.from_numpy(grid.reshape(-1, 2)), c).numpy()
    assert np.abs(ours - ref).max() <= 2e-6
    assert np.abs(ours_flat - ref_flat).max() <= 2e-6
    assert np.abs(ours.reshape(-1, 3) - ours_flat).max() <= 2e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_table_and_mlp_gradients_match_jax(arch):
    jm, jc, m, c, p, grid, target = _setup(arch, (17, 15))
    jout, jg = _jgrads(jm, jc, p, grid, target)
    out, g = _grads(m, c, p, grid, target)
    assert np.abs(out - jout).max() <= 2e-6
    cap = 1 << c.log2_table_size
    direct = [(r + 1) ** 2 <= cap for r in c.level_resolutions]
    assert any(direct) and not all(direct)  # both kinds of level are held
    for a, b in zip(g, jg):
        for k in a:
            assert np.abs(a[k] - b[k]).max() <= 1e-5 * np.abs(b[k]).max(), k
    # the same bits on a second backward
    _, g2 = _grads(m, c, p, grid, target)
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(g, g2) for k in a)


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_precision_matches_jax(arch):
    jm, jc, m, c, p, grid, target = _setup(arch, (17, 15))
    jout, jg = _jgrads(jm, jc, p, grid, target, jnp.bfloat16)
    out, g = _grads(m, c, p, grid, target, "fp32" + sm.MIXED)
    assert np.abs(out - jout).max() <= 1e-6
    for a, b in zip(g, jg):
        for k in a:
            assert np.abs(a[k] - b[k]).max() <= 1e-2 * np.abs(b[k]).max(), k


def test_flat_path_is_forward_only():
    _, _, m, c, p, grid, target = _setup(ARCHS[0])
    tp = params_from_jax(p, "cpu")
    tp[0]["w"].requires_grad_(True)
    out = m.apply_flat(tp, torch.from_numpy(grid.reshape(-1, 2)), c)
    with pytest.raises(RuntimeError, match="forward-only"):
        out.sum().backward()


def test_fit_and_finetune_never_differentiate_the_flat_path():
    """A sparse fit with row-block pixel chunks and a k-means finetune with a
    row stride run through the grid path: the flat path's backward, which
    raises, is never reached."""
    from implicit_image_tpu_torch.sparsity import MaskingConfig

    m, c = build_model("hashgrid", **ARCHS[0])
    img = np.random.default_rng(0).uniform(size=(16, 16, 3)).astype(np.float32)
    res = fit(torch.Generator().manual_seed(0), m, c, get_grid(16, 16), img,
              TrainConfig(num_steps=6, log_steps=3, pixel_chunks=4), OptimConfig(lr=1e-2),
              MaskingConfig(density=0.5, interval=2, end_when=4), device="cpu")
    q = quant_finetune(res.params, img, m, c, get_grid(16, 16),
                       QuantConfig(name="KMeans", bits=4, num_steps=3, row_stride=2,
                                   skip_layers=()),
                       OptimConfig(lr=1e-2), masks=res.mask_state.masks)
    assert np.isfinite(q.metrics["quant_psnr"]) and q.codebooks[0] is not None


def test_short_fit_matches_jax():
    arch = ARCHS[0]
    jm, jc, m, c, p, _, _ = _setup(arch)
    img = np.random.default_rng(5).uniform(size=(16, 16, 3)).astype(np.float32)
    tc = dict(num_steps=30, log_steps=30)
    jres = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(16, 16), img,
                JTrain(matmul_precision="tensorfloat32", **tc), JOptim(lr=1e-2),
                init_params=jax.tree.map(jnp.asarray, p))
    tres = fit(torch.Generator().manual_seed(0), m, c, get_grid(16, 16), img, TrainConfig(**tc),
               OptimConfig(lr=1e-2), init_params=params_from_jax(p, "cpu"), device="cpu")
    jpsnr = float(np.asarray(jres.metrics["psnr"])[-1])
    assert abs(float(tres.metrics["psnr"][-1]) - jpsnr) <= 0.05


CLI = ["img=synthetic", "img.height=16", "img.width=16", "mlp=hashgrid", "mlp.n_levels=4",
       "mlp.log2_table_size=6", "mlp.base_resolution=4", "mlp.finest_resolution=16",
       "mlp.hidden_size=8", "quant.skip_layers=[]", "optim.lr=1e-2", "optim.epsilon=1e-15",
       "train.num_steps=20", "train.log_steps=10", "quant.num_steps=5", "entropy_coding=plain"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hash")
    tres = tcompress.main(compose(CLI + ["device=cpu"]), run_dir=str(root / "t"))
    jres = jcompress.main(jcompose(CLI), run_dir=str(root / "j"))
    return root, tres, jres


def test_run_dirs_decode_across_packages_to_the_same_weights(runs):
    root, (tpsnr, tbytes), (jpsnr, jbytes) = runs
    assert np.isfinite(tpsnr) and np.isfinite(jpsnr)
    for run in ("t", "j"):
        ours = decompress_state_dict(root / run / "model_quantized", "plain")
        theirs = jdecompress_state(root / run / "model_quantized", "plain")
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]))
        img, _ = tdecompress.decode_run(root / run, device="cpu")
        jimg, _ = jdecompress.decode_run(root / run)
        assert np.abs(img - np.asarray(jimg)).max() <= 1e-5
