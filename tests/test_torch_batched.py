"""Port parity: K2 over a member axis (its plain version, against the
vmapped Pallas kernel in interpret mode), the batched fit against the JAX
package's and against the port's single fits, and batched_compress.

On the CPU the member-axis Function runs the plain versions; the kernels
themselves are held to their single launches in test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.ops.sine_mlp import siren_apply_flat_pallas
from implicit_image_tpu.parallel.batched import batched_fit as j_batched_fit
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu_torch.convert import params_from_jax, params_to_numpy
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import sine_mlp as sm
from implicit_image_tpu_torch.parallel import batched_compress, batched_fit, member_generators
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)

KEYS = ("w", "b")


def _imgs(b, n=16):
    return np.stack([synthetic_image(n, n, seed=s) for s in range(b)])


def _members(depth, hidden, m, seed=0):
    mdef, mcfg = build_model("siren", depth=depth, hidden_size=hidden)
    gen = torch.Generator().manual_seed(seed)
    return mcfg, [mdef.init(gen, mcfg) for _ in range(m)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("shared_x", [True, False])
def test_batched_plain_backward_is_each_members_bit_for_bit(precision, shared_x):
    """The plain version of K2 over a member axis: member m's dx, dW and db
    are siren_chain_backward_reference's on member m alone, bit for bit."""
    mcfg, members = _members(4, 24, 3)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (300, 2)).astype(np.float32))
    xs = torch.from_numpy(rng.uniform(-1, 1, (3, 300, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 300, 3)).astype(np.float32))
    xin = x if shared_x else xs
    dx, grads = sm.siren_chain_backward_reference_batched(members, xin, g, mcfg, precision)
    assert dx.shape == (3, 300, 2)
    for i, p in enumerate(members):
        dx_1, grads_1 = sm.siren_chain_backward_reference(p, x if shared_x else xs[i], g[i],
                                                          mcfg, precision)
        assert torch.equal(dx[i], dx_1)
        for a, b in zip(grads, grads_1):
            for k in KEYS:
                assert torch.equal(a[k][i], b[k]), (i, k)


def test_batched_function_is_single_functions_bit_for_bit():
    """SineMLPBatchedFunction on the CPU: each member's output and gradients
    are SineMLPFunction's on that member alone, bit for bit."""
    mcfg, members = _members(3, 16, 2, seed=4)
    coords = get_grid(8, 8).reshape(-1, 2)
    target = torch.rand((2, 64, 3), generator=torch.Generator().manual_seed(5))
    stacked = tuple({k: torch.stack([p[i][k] for p in members]).requires_grad_(True)
                     for k in KEYS} for i in range(3))
    out = sm.siren_apply_flat_batched_fused(stacked, coords, mcfg, "fp32")
    sum(((o - t) ** 2).mean() for o, t in zip(out.unbind(0), target)).backward()
    for i, p in enumerate(members):
        single = tuple({k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in p)
        o = sm.siren_apply_flat_fused(single, coords, mcfg, "fp32")
        ((o - target[i]) ** 2).mean().backward()
        assert torch.equal(out[i].detach(), o.detach())
        for a, b in zip(stacked, single):
            for k in KEYS:
                assert torch.equal(a[k].grad[i], b[k].grad), (i, k)


def test_batched_plain_backward_matches_vmapped_pallas_interpret():
    """Two members at d3, H = 128, N = 256, weights copied from the JAX init:
    the port's batched chain in the bf16 mode (the plain versions on the
    CPU) against JAX's siren_apply_flat_pallas gradients under jax.vmap in
    interpret mode, within test_torch_sine_mlp.py's limits for the single
    chain: forward 8e-3, gradients max(2.5x the XLA-bf16 path's error
    against fp32, 0.02) of the largest fp32 gradient."""
    jm, jc = jbuild("siren", depth=3, hidden_size=128)
    ps = [jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(s), jc)) for s in (0, 1)]
    stacked_j = jax.tree.map(lambda *v: np.stack(v), *ps)
    coords = np.array(jgrid(16, 16)).reshape(-1, 2)
    targets = np.random.default_rng(2).uniform(size=(2, 256, 3)).astype(np.float32)

    def loss_p(p, t):
        return jnp.mean((siren_apply_flat_pallas(p, coords, jc) - t) ** 2)

    with pltpu.force_tpu_interpret_mode():
        pallas_out = np.asarray(jax.vmap(lambda p: siren_apply_flat_pallas(p, coords, jc))(
            stacked_j))
        gp = jax.vmap(jax.grad(loss_p))(stacked_j, targets)

    m, c = build_model("siren", depth=3, hidden_size=128)
    stacked = tuple({k: torch.from_numpy(np.asarray(layer[k])).requires_grad_(True)
                     for k in KEYS} for layer in stacked_j)
    out = sm.siren_apply_flat_batched_fused(stacked, torch.from_numpy(coords), c, "bf16")
    sum(((o - torch.from_numpy(t)) ** 2).mean()
        for o, t in zip(out.unbind(0), targets)).backward()
    np.testing.assert_allclose(out.detach().numpy(), pallas_out, atol=8e-3)
    for i, p in enumerate(ps):
        t = targets[i]
        gx = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc, jnp.bfloat16) - t) ** 2))(p)
        gf = jax.grad(lambda q: jnp.mean((jm.apply_flat(q, coords, jc, None) - t) ** 2))(p)
        for layer, b, x, f in zip(stacked, gp, gx, gf):
            for k in KEYS:
                scale = float(np.abs(np.asarray(f[k])).max()) + 1e-12
                err_port = float(np.abs(layer[k].grad[i].numpy() - np.asarray(b[k][i])).max())
                err_xla = float(np.abs(np.asarray(x[k]) - np.asarray(f[k])).max())
                assert err_port / scale < max(2.5 * err_xla / scale, 0.02), (i, k)


def test_batched_fit_dense_matches_jax_batched_fit():
    """Two images from one copied init (16x16, d3 w16, 50 steps, lr 1e-3,
    float32): each member's logged PSNRs within 0.05 dB of JAX's batched_fit
    and its final params within 1e-3 relative, as test_fit_matches_jax."""
    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jc))
    imgs = _imgs(2)
    jres = j_batched_fit(jax.random.PRNGKey(0), jm, jc, jgrid(16, 16), imgs,
                         JTrain(num_steps=50, log_steps=10, matmul_precision="float32"),
                         JOptim(lr=1e-3), init_params=p)
    m, c = build_model("siren", depth=3, hidden_size=16)
    res = batched_fit(torch.Generator().manual_seed(0), m, c, get_grid(16, 16), imgs,
                      TrainConfig(num_steps=50, log_steps=10, matmul_precision="float32"),
                      OptimConfig(lr=1e-3), init_params=params_from_jax(p, "cpu"), device="cpu")
    j_psnr = np.asarray(jres.metrics["psnr"])
    assert res.metrics["psnr"].shape == j_psnr.shape == (2, 50)
    logged = ~np.isnan(j_psnr)
    np.testing.assert_array_equal(logged, ~np.isnan(res.metrics["psnr"]))
    assert logged.sum() == 10
    np.testing.assert_allclose(res.metrics["psnr"][logged], j_psnr[logged], atol=0.05)
    for i in range(2):
        for a, b in zip(params_to_numpy(res.params), jres.params):
            for k in KEYS:
                ref = np.asarray(b[k][i])
                assert np.abs(a[k][i] - ref).max() <= 1e-3 * np.abs(ref).max(), (i, k)


@pytest.mark.parametrize("masking,train", [
    (None, {}),
    ("RigL", {}),
    ("SNFS", {}),
    (None, {"matmul_precision_early": "bfloat16", "matmul_precision_switch": 0.5}),
    ("RigL", {"pixel_chunks": 2}),
    (None, {"loss": "ms-ssim"}),
    ("RigL", {"grad_clip": 0.05}),
    (None, {"mixed_precision": True}),
])
def test_batched_fit_members_are_single_fits_bit_for_bit(masking, train):
    """Member i of a batched fit has the bits of a single fit with
    member_generators(g, B)[i] on its image: params, masks and every metric
    (dense, RigL, SNFS with its momentum growth, the precision schedule,
    pixel_chunks=2, the MS-SSIM loss, optim.grad_clip (a global norm per
    member; the clip scale among the metrics) and mixed precision, the
    plain "+mixed" chain on the CPU)."""
    mk = {None: None,
          "RigL": MaskingConfig(density=0.5, end_when=20, interval=5),
          "SNFS": MaskingConfig(name="SNFS", density=0.3, growth_mode="momentum",
                                redistribution_mode="momentum", end_when=20, interval=5,
                                dense_gradients=False)}[masking]
    m, c = build_model("siren", depth=3, hidden_size=16)
    grid, imgs = get_grid(16, 16), _imgs(3)
    train = dict(train)
    oc = OptimConfig(lr=1e-3, grad_clip=train.pop("grad_clip", 0.0))
    tc = TrainConfig(num_steps=30, log_steps=10, **train)
    res = batched_fit(torch.Generator().manual_seed(3), m, c, grid, imgs, tc, oc, mk,
                      device="cpu")
    gens = member_generators(torch.Generator().manual_seed(3), 3)
    for i in range(3):
        single = fit(gens[i], m, c, grid, imgs[i], tc, oc, mk)
        for a, b in zip(res.params, single.params):
            for k in KEYS:
                assert torch.equal(a[k][i], b[k]), (i, k)
        for k, v in single.metrics.items():
            assert np.array_equal(res.metrics[k][i], v, equal_nan=True), (i, k)
        if mk is not None:
            for a, b in zip(res.mask_state.masks, single.mask_state.masks):
                assert torch.equal(a[i], b)


def test_member_generators_are_split_keys():
    """Distinct members, the same for the same seed, and the first k of b
    are member_generators(g, k)."""
    draws = [[float(torch.rand((), generator=g)) for g in member_generators(
        torch.Generator().manual_seed(7), b)] for b in (3, 3, 2)]
    assert draws[0] == draws[1] and draws[2] == draws[0][:2]
    assert len(set(draws[0])) == 3


def test_batched_compress_member_is_its_single_member_run(tmp_path):
    """Member 0 of B = 2 writes the bytes of a B = 1 run with that member's
    generator (member_generators' prefix), and decodes to its quant PSNR."""
    m, c = build_model("siren", depth=3, hidden_size=16)
    imgs = _imgs(2)
    kw = dict(masking_cfg=MaskingConfig(density=0.5, end_when=10, interval=5),
              quant_cfg=QuantConfig(bits=4, num_steps=4), stream_name="zstd", device="cpu")
    tc, oc = TrainConfig(num_steps=20, log_steps=10), OptimConfig(lr=1e-3)
    two = batched_compress(torch.Generator().manual_seed(5), m, c, get_grid(16, 16), imgs, tc,
                           oc, stream_root=str(tmp_path / "two"), member_subdir="model_quantized",
                           **kw)
    one = batched_compress(torch.Generator().manual_seed(5), m, c, get_grid(16, 16), imgs[:1],
                           tc, oc, stream_root=str(tmp_path / "one"), member_names=["a"], **kw)
    data = [(tmp_path / "two" / "img0" / "model_quantized" / "compressed_weights.data"),
            (tmp_path / "one" / "a" / "compressed_weights.data")]
    assert data[0].read_bytes() == data[1].read_bytes()
    assert two[0].compressed_bytes == one[0].compressed_bytes > 0
    for r in two:
        assert abs(r.decoded_psnr - r.quant_psnr) < 0.5


def test_batched_compress_raises(tmp_path):
    """delta_info without init_params raises as in JAX; so do member names
    that do not match the batch."""
    m, c = build_model("siren", depth=3, hidden_size=8)
    args = (torch.Generator(), m, c, get_grid(8, 8), _imgs(2, 8), TrainConfig(num_steps=2),
            OptimConfig())
    with pytest.raises(ValueError, match="delta_info requires init_params"):
        batched_compress(*args, quant_cfg=QuantConfig(), delta_info={"artifact": "x",
                                                                     "sha256": "0"},
                         stream_root=str(tmp_path))
    with pytest.raises(ValueError, match="member_names"):
        batched_compress(*args, member_names=["a"], stream_root=str(tmp_path))


def _jax_train(train):
    """The JAX TrainConfig's kwargs of the port's: mixed_precision is its
    compute_dtype=bfloat16."""
    out = {k: v for k, v in train.items() if k != "mixed_precision"}
    if train.get("mixed_precision"):
        out["compute_dtype"] = "bfloat16"
    return out


def _matches_jax_batched_fit(model, train, optim, steps=30, psnr_tol=0.05, rel_tol=1e-3,
                             feather=None):
    """Two images from one init copied from the JAX package (16x16, lr
    1e-3, float32 products): the port's batched_fit against JAX's vmapped
    batched_fit, each member's logged PSNRs within psnr_tol dB and its final
    params within rel_tol of the leaf's largest magnitude; `feather`, a
    compression, wraps the model in Feathermap in both packages. Returns the
    port's FitResult."""
    from implicit_image_tpu.feathermap import build_feather_model as jfeather
    from implicit_image_tpu_torch.feathermap import build_feather_model

    jm, jc = jbuild(model[0], **model[1])
    m, c = build_model(model[0], **model[1])
    if feather is not None:
        jm, m = jfeather(jm, jc, compress=feather), build_feather_model(m, c, compress=feather)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jc))
    imgs = _imgs(2)
    jres = j_batched_fit(jax.random.PRNGKey(0), jm, jc, jgrid(16, 16), imgs,
                         JTrain(num_steps=steps, log_steps=10, matmul_precision="float32",
                                **_jax_train(train)),
                         JOptim(lr=1e-3, **optim), init_params=p)
    res = batched_fit(torch.Generator().manual_seed(0), m, c, get_grid(16, 16), imgs,
                      TrainConfig(num_steps=steps, log_steps=10, matmul_precision="float32",
                                  **train),
                      OptimConfig(lr=1e-3, **optim), init_params=params_from_jax(p, "cpu"),
                      device="cpu")
    j_psnr = np.asarray(jres.metrics["psnr"])
    logged = ~np.isnan(j_psnr)
    np.testing.assert_array_equal(logged, ~np.isnan(res.metrics["psnr"]))
    np.testing.assert_allclose(res.metrics["psnr"][logged], j_psnr[logged], atol=psnr_tol)
    for i in range(2):
        for a, b in zip(params_to_numpy(res.params), jres.params):
            for k in a:
                ref = np.asarray(b[k][i])
                assert np.abs(a[k][i] - ref).max() <= rel_tol * np.abs(ref).max(), (i, k)
    return res


@pytest.mark.parametrize("model,train,match", [
    (("coordx", dict(depth=5, hidden_size=16, split_depth=2)), {}, "M14a"),
    (("siren", dict(depth=3, hidden_size=8, fast_sine=False)), {}, "M14a"),
    (("siren", dict(depth=3, hidden_size=8)), {"pixel_chunks": 2}, "pixel_chunks"),
    (("siren", dict(depth=3, hidden_size=8)), {"loss": "ms-ssim"}, "ms-ssim"),
    (("siren", dict(depth=3, hidden_size=8)), {"mixed_precision": True}, "mixed"),
])
def test_batched_fit_raises(model, train, match):
    """What raised over the member axis before this slice (CoordX, the
    exact sine: the next part of M14a; pixel_chunks > 1, the MS-SSIM loss
    and mixed precision) now runs there and matches the JAX package's
    vmapped batched_fit (30 steps) at the dense bar of
    test_batched_fit_dense_matches_jax_batched_fit."""
    _matches_jax_batched_fit(model, train, {})


@pytest.mark.parametrize("optim", [dict(name="shampoo", epsilon=0.1),
                                   dict(preconditioner="ekfac")])
def test_batched_fit_raises_for_other_optimizers(optim):
    """Shampoo (one factor stack per member, never the stacked (M, in, out)
    leaves matricized as 3-D tensors) and EKFAC (each member's capture,
    bases and moments its own) over a member axis, which raised before this
    slice, match the JAX package's vmapped batched_fit over 30 steps (EKFAC
    recomputes its bases at steps 0, 10 and 20), at the dense bar. Shampoo
    runs at epsilon 0.1, as test_shampoo_fit_matches_jax's sparse case: at
    the conf's 1e-4 its inverse roots amplify the last bits of each
    package's own Gram products (1.8e-2 relative apart after 30 steps here)."""
    _matches_jax_batched_fit(("siren", dict(depth=3, hidden_size=8)), {}, optim)


def test_batched_kernels_raise_before_building():
    """K2 over a member axis raises ValueError, before the library is asked
    for, on members of different shapes (in every mode, "+mixed" too) and
    on cotangents of the wrong shape; the member-axis Function runs
    "+mixed" on the CPU, each member the bits of its single Function."""
    mcfg, members = _members(3, 16, 2)
    _, other = _members(3, 24, 1)
    x, g = torch.zeros((10, 2)), torch.zeros((2, 10, 3))
    before = dict(sm.LAUNCHES)
    with pytest.raises(ValueError, match="one shape"):
        sm.sine_mlp_bwd_batched(members + other, x, torch.zeros((3, 10, 3)), mcfg,
                                "fp32" + sm.MIXED)
    with pytest.raises(ValueError, match="one shape"):
        sm.sine_mlp_bwd_batched(members + other, x, torch.zeros((3, 10, 3)), mcfg, "fp32")
    with pytest.raises(ValueError, match="g must be"):
        sm.sine_mlp_bwd_batched(members, x, torch.zeros((3, 10, 3)), mcfg, "fp32")
    stacked = tuple({k: torch.stack([p[i][k] for p in members]) for k in KEYS} for i in range(3))
    xs = get_grid(4, 4).reshape(-1, 2)
    out = sm.siren_apply_flat_batched_fused(stacked, xs, mcfg, "bf16" + sm.MIXED)
    for i, p in enumerate(members):
        assert torch.equal(out[i], sm.siren_apply_flat_fused(p, xs, mcfg, "bf16" + sm.MIXED))
    assert sm.LAUNCHES == before
