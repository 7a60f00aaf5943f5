"""Port parity over the member axis beyond the fused SIREN: every model
family and fit option of the batched fit, the codebook finetune over the
member axis, decode_runs' member-axis renders and meta-training's
member-axis adaptation, against the JAX package's vmapped functions and
against the port's own single runs.

Bars: against JAX, the dense bar of test_torch_batched.py (logged PSNRs
within 0.05 dB, final params within 1e-3 of each leaf's largest
magnitude); against the port's single fits, bit for bit where the member
runs the single fit's own ops, else 1e-5 of each leaf's largest magnitude
(a vmapped product may add in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.feathermap import build_feather_model as jfeather
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.parallel.batched import batched_fit as j_batched_fit
from implicit_image_tpu.quant import QuantConfig as JQuant
from implicit_image_tpu.training import metainit as jmeta
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.quant_phase import make_quant_fit_fn
from implicit_image_tpu_torch.convert import params_from_jax, params_to_numpy
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.feathermap import build_feather_model
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops.sine_mlp import stack_members
from implicit_image_tpu_torch.parallel import batched_fit, member_generators
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.training import metainit as tmeta
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit
from implicit_image_tpu_torch.training.quant_phase import quant_finetune, quant_finetune_members

torch.set_num_threads(1)

HASHGRID = dict(n_levels=4, features=2, log2_table_size=6, base_resolution=4,
                finest_resolution=16, depth=3, hidden_size=16)
FAMILIES = {
    "fourier": ("fourier", dict(depth=4, hidden_size=16, map_size=16, map_scale=4.0), None),
    "hashgrid": ("hashgrid", HASHGRID, None),
    "wavelet_siren": ("wavelet_siren", dict(depth=3, hidden_size=16, height=16, width=16), None),
    "feathermap": ("siren", dict(depth=3, hidden_size=16), 0.5),
}


def _imgs(b, n=16):
    return np.stack([synthetic_image(n, n, seed=s) for s in range(b)])


def _models(name):
    family, kw, feather = FAMILIES[name]
    jm, jc = jbuild(family, **kw)
    m, c = build_model(family, **kw)
    if feather is not None:
        jm, m = jfeather(jm, jc, compress=feather), build_feather_model(m, c, compress=feather)
    return jm, jc, m, c


def _assert_close(a, ref, tol, what):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(a) - ref).max() <= tol * np.abs(ref).max(), what


@pytest.mark.parametrize("name,optim", [
    ("fourier", {}), ("hashgrid", {}), ("wavelet_siren", {}), ("feathermap", {}),
    ("hashgrid", {"grad_clip": 0.05}),
])
def test_batched_fit_family_matches_jax(name, optim):
    """Fourier (its frozen B per member), hashgrid (member-axis tables, the
    gather and its transpose-gather under vmap), wavelet-SIREN (both chains
    over the member axis, the DWT over stacked lattices), Feathermap over
    SIREN, and optim.grad_clip (a global norm per member, clipping here):
    the port's batched_fit against JAX's vmapped batched_fit, 30 steps from
    one copied init, at the dense bar (test_torch_batched's helper)."""
    from test_torch_batched import _matches_jax_batched_fit

    family, kw, feather = FAMILIES[name]
    res = _matches_jax_batched_fit((family, kw), {}, optim, feather=feather)
    if optim.get("grad_clip"):
        assert (res.metrics["clip_scale"] < 1.0).any()


@pytest.mark.parametrize("model,optim,masking", [
    (("coordx", dict(depth=5, hidden_size=16, split_depth=2)), {}, True),
    (("siren", dict(depth=3, hidden_size=16, fast_sine=False)), {}, False),
    (("fourier", dict(depth=4, hidden_size=16, map_size=16, map_scale=4.0)), {}, False),
    (("hashgrid", HASHGRID), {}, False),
    (("wavelet_siren", dict(depth=3, hidden_size=16, height=16, width=16)), {}, True),
    (("siren", dict(depth=3, hidden_size=16)), dict(name="shampoo", epsilon=0.1), True),
    (("siren", dict(depth=3, hidden_size=16)), dict(preconditioner="ekfac",
                                                    precond_interval=4), True),
])
def test_batched_fit_members_are_single_fits(model, optim, masking):
    """Member i of a batched fit against the port's single fit with
    member_generators(g, B)[i] (its own init and masks): the families that
    run vmapped products, Shampoo and EKFAC, dense and under RigL. Params
    and every metric within 1e-5 of the largest magnitude (a batched
    product may add in another order); masks equal."""
    from implicit_image_tpu_torch.sparsity import MaskingConfig

    m, c = build_model(model[0], **model[1])
    mk = MaskingConfig(density=0.5, end_when=10, interval=5) if masking else None
    grid, imgs = get_grid(16, 16), _imgs(2)
    tc, oc = TrainConfig(num_steps=20, log_steps=10), OptimConfig(lr=1e-3, **optim)
    res = batched_fit(torch.Generator().manual_seed(3), m, c, grid, imgs, tc, oc, mk,
                      device="cpu")
    gens = member_generators(torch.Generator().manual_seed(3), 2)
    for i in range(2):
        single = fit(gens[i], m, c, grid, imgs[i], tc, oc, mk)
        for a, b in zip(res.params, single.params):
            for k in b:
                _assert_close(a[k][i].numpy(), b[k].numpy(), 1e-5, (i, k))
        for k, v in single.metrics.items():
            np.testing.assert_allclose(res.metrics[k][i], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{i} {k}")
        if mk is not None:
            for a, b in zip(res.mask_state.masks, single.mask_state.masks):
                if b is not None:
                    assert torch.equal(a[i], b)


def _stacked_fit(depth=3, width=16, side=16):
    """Two members' params after a short JAX batched fit (one copied init,
    two images): the finetune's input for both packages."""
    jm, jc = jbuild("siren", depth=depth, hidden_size=width)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), jc))
    imgs = _imgs(2, side)
    jres = j_batched_fit(jax.random.PRNGKey(0), jm, jc, jgrid(side, side), imgs,
                         JTrain(num_steps=20, log_steps=20, matmul_precision="float32"),
                         JOptim(lr=1e-3), init_params=p)
    return jm, jc, jax.tree.map(np.asarray, jres.params), imgs


@pytest.mark.parametrize("name", ["KMeans", "QAT"])
def test_quant_finetune_members_matches_jax_vmapped(name):
    """The codebook finetune over the member axis (k-means and 10 steps;
    QAT per channel and 5 steps) against the JAX package's jitted jax.vmap of
    make_quant_fit_fn, as its batched pipeline and ladder call it: labels
    (codes) equal but for <= 0.5% one step apart (an fp32 k-means tie or a
    rounding boundary, as the single finetune's test allows), the
    finetuned weights within one step where they differ and 1e-4 of the
    largest magnitude elsewhere, the quant PSNR within 0.01 dB."""
    jm, jc, stacked, imgs = _stacked_fit()
    # QAT at test_qat_finetune_matches_jax's 8 bits and 5 steps: at 4 bits, or
    # past 5 steps here, a last-bit difference in the STE steps moves latents
    # across rounding boundaries, in the single finetune too (3.5% of codes
    # after 10 steps on these params, one package's single run against the
    # other's; JAX's vmapped codes equal its single ones)
    bits, steps = (4, 10) if name == "KMeans" else (8, 5)
    jq = JQuant(name=name, bits=bits, num_steps=steps, log_steps=steps)
    qfn = jax.jit(jax.vmap(lambda p, img: make_quant_fit_fn(
        jm, jc, jgrid(16, 16), jq, JOptim(lr=1e-3), None, matmul_precision="float32")(p, img)))
    jparams, jbooks, jmetrics = qfn(jax.tree.map(jnp.asarray, stacked), jnp.asarray(imgs))
    m, c = build_model("siren", depth=3, hidden_size=16)
    outs = quant_finetune_members(params_from_jax(stacked, "cpu"), imgs, m, c, get_grid(16, 16),
                                  QuantConfig(name=name, bits=bits, num_steps=steps),
                                  OptimConfig(lr=1e-3), precision="fp32")
    for i, out in enumerate(outs):
        assert abs(out.metrics["quant_psnr"] - float(jmetrics["quant_psnr"][i])) < 0.01
        books = 0
        for li, (tb, jb) in enumerate(zip(out.codebooks, jbooks)):
            assert (tb is None) == (jb is None)
            if tb is None:
                continue
            books += 1
            code = "labels" if name == "KMeans" else "codes"
            ct = getattr(tb, code).numpy().astype(np.int64)
            cj = np.asarray(getattr(jb, code)[i], np.int64)
            diff = ct != cj
            assert diff.mean() <= 0.005, (i, li)
            tw, jw = out.params[li]["w"].numpy(), np.asarray(jparams[li]["w"][i])
            if diff.any():
                step = (tb.scales.numpy()[None, :] if name == "QAT"
                        else np.abs(np.diff(np.sort(tb.centroids.numpy()))).max())
                assert (np.abs(tw - jw)[diff] <= 1.01 * np.broadcast_to(step, tw.shape)[diff]).all()
            assert np.abs(tw - jw)[~diff].max() <= 1e-4 * np.abs(jw).max(), (i, li)
        assert books == 1


@pytest.mark.parametrize("case", ["kmeans", "kmeans-masked-delta-ecvq", "qat-per-tensor",
                                  "coordx-kmeans"])
def test_quant_finetune_members_are_single_finetunes(case):
    """Each member of the member-axis finetune against its own
    quant_finetune: codebooks, labels, finetuned params and metrics bit for
    bit (SIREN; CoordX's vmapped products too at this size), with masks,
    delta offsets and ECVQ, and QAT per tensor."""
    gen = torch.Generator().manual_seed(4)
    if case.startswith("coordx"):
        m, c = build_model("coordx", depth=5, hidden_size=16, split_depth=2)
    else:
        m, c = build_model("siren", depth=4, hidden_size=16)
    members = [m.init(gen, c) for _ in range(2)]
    imgs = _imgs(2)
    qc = (QuantConfig(name="QAT", bits=4, num_steps=6, qscheme="per_tensor")
          if case.startswith("qat") else
          QuantConfig(bits=3, num_steps=6, ecvq_lambda=0.05 if "ecvq" in case else 0.0))
    masks, offsets = None, None
    if "masked" in case:
        masks = [None if i in (0, len(members[0]) - 1) else
                 (torch.rand(layer["w"].shape, generator=gen) < 0.6).float()
                 for i, layer in enumerate(members[0])]
        masks = [None if mk is None else torch.stack([mk, mk.flip(0)]) for mk in masks]
        for i, mk in enumerate(masks):
            if mk is not None:
                for j in range(2):
                    members[j][i]["w"] = members[j][i]["w"] * mk[j]
    if "delta" in case:
        offsets = m.init(gen, c)
    outs = quant_finetune_members(stack_members(members), imgs, m, c, get_grid(16, 16), qc,
                                  OptimConfig(lr=1e-3), masks=masks, offset_params=offsets)
    for j, out in enumerate(outs):
        single = quant_finetune(members[j], imgs[j], m, c, get_grid(16, 16), qc,
                                OptimConfig(lr=1e-3),
                                masks=None if masks is None else
                                [None if mk is None else mk[j] for mk in masks],
                                offset_params=offsets)
        for a, b in zip(out.params, single.params):
            for k in b:
                assert torch.equal(a[k], b[k]), (j, k)
        for a, b in zip(out.codebooks, single.codebooks):
            assert (a is None) == (b is None)
            if a is not None:
                for x, y in zip(a, b):
                    assert torch.equal(x, y)
        np.testing.assert_array_equal(out.metrics["loss"], single.metrics["loss"])
        assert out.metrics["quant_psnr"] == single.metrics["quant_psnr"]


@pytest.mark.parametrize("name", ["hashgrid", "fourier"])
def test_meta_step_over_the_member_axis_matches_jax(name):
    """Meta-training's inner loop adapts every family over the member axis:
    JAX's meta_train (pool 4, batch 2, inner 3, outer 2, 16²) against the
    port's meta_step loop from JAX's init and index draws, at
    test_meta_step_loop_matches_jax_meta_train's bar (losses 1e-5
    relative, meta-params 1e-4 of the largest magnitude)."""
    import dataclasses

    family, kw, _ = FAMILIES[name]
    mc = jmeta.MetaConfig(pool_size=4, meta_batch=2, inner_steps=3, outer_steps=2, chunk=1)
    pool = jmeta.meta_pool(16, 16, mc.pool_size)
    jd, jc = jbuild(family, **kw)
    jparams, jlosses, _ = jmeta.meta_train(jd, jc, jgrid(16, 16), pool, mc)
    key = jax.random.PRNGKey(mc.seed)
    key, init_key = jax.random.split(key)
    meta = params_from_jax(jax.tree.map(np.asarray, jd.init(init_key, jc)), "cpu")
    td, tc = build_model(family, **kw)
    meta_step = tmeta.make_meta_step(td, tc, get_grid(16, 16), tmeta.MetaConfig(
        **dataclasses.asdict(mc)), "fp32", "cpu")
    flat = pool.reshape(mc.pool_size, 16 * 16, 3)
    losses = []
    for j in range(mc.outer_steps):
        key, skey = jax.random.split(key)
        idx = np.asarray(jax.random.choice(skey, mc.pool_size, shape=(mc.meta_batch,),
                                           replace=False))
        meta, loss = meta_step(meta, flat[idx], j)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
    for a, b in zip(meta, jparams):
        for k in a:
            _assert_close(a[k].numpy(), np.asarray(b[k]), 1e-4, k)


@pytest.mark.parametrize("name", ["coordx", "hashgrid", "wavelet_siren", "feathermap"])
def test_apply_batched_renders_each_member(name):
    """decode_runs' member-axis render (ModelDef.apply_batched) of three
    members of a non-SIREN family against each member's own render: within
    1e-6 of the largest value."""
    if name == "coordx":
        m, c = build_model("coordx", depth=5, hidden_size=16, split_depth=2)
    else:
        _, _, m, c = _models(name)
    gen = torch.Generator().manual_seed(2)
    members = [m.init(gen, c) for _ in range(3)]
    grid = get_grid(16, 16)
    out = m.apply_batched(members, grid, c, "fp32")
    assert out.shape == (3, 16, 16, 3)
    for i, p in enumerate(members):
        with torch.no_grad():
            _assert_close(out[i].numpy(), m.apply(p, grid, c, "fp32").numpy(), 1e-6, i)


def test_member_axis_shampoo_update_from_a_converted_jax_state():
    """Shampoo over a member axis from one state: three members' params and
    a state after 2 steps of the JAX package's vmapped update, carried over
    (convert.opt_state_from_jax: one factor stack per member), then 3 more
    steps in each package (the port's update with members=True), each with
    a refresh of the inverse roots: every member's params within 1e-4 of
    the largest magnitude (test_shampoo_update_matches_jax's bar)."""
    from implicit_image_tpu import optim as joptim
    from implicit_image_tpu_torch.convert import opt_state_from_jax
    from implicit_image_tpu_torch.optim import opt_update

    kw = dict(name="shampoo", lr=0.05, momentum=0.9, epsilon=0.1, update_freq=1,
              graft_norm=True)
    jcfg, tcfg = JOptim(**kw), OptimConfig(**kw)
    rng = np.random.default_rng(0)
    stacked = ({"w": (rng.standard_normal((3, 6, 5)) * 0.5).astype(np.float32),
                "b": (rng.standard_normal((3, 5)) * 0.1).astype(np.float32)},
               {"w": (rng.standard_normal((3, 5, 3)) * 0.5).astype(np.float32),
                "b": (rng.standard_normal((3, 3)) * 0.1).astype(np.float32)})
    grads = [jax.tree.map(lambda v: (rng.standard_normal(v.shape) * 0.3).astype(np.float32),
                          stacked) for _ in range(5)]
    init = jax.jit(jax.vmap(lambda p: joptim.opt_init(p, jcfg)))
    update = jax.jit(jax.vmap(lambda g, st, p: joptim.opt_update(g, st, p, 0.05, jcfg)))
    jp = jax.tree.map(jnp.asarray, stacked)
    jst = init(jp)
    for g in grads[:2]:
        jp, jst = update(jax.tree.map(jnp.asarray, g), jst, jp)
    tp, tst = params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), opt_state_from_jax(jst)
    assert tst.count == 2 and tst.preconds[0]["w"][0].shape == (3, 6, 6)
    for g in grads[2:]:
        jp, jst = update(jax.tree.map(jnp.asarray, g), jst, jp)
        tp, tst = opt_update(params_from_jax(g, "cpu"), tst, tp, 0.05, tcfg, members=True)
    for a, b in zip(params_to_numpy(tp), jp):
        for k in a:
            for i in range(3):
                _assert_close(a[k][i], np.asarray(b[k])[i], 1e-4, (k, i))


def test_member_axis_ekfac_preconditions_each_member_from_jax_bases():
    """EKFAC over a member axis from one state: two members' EKFAC states
    after the JAX package's vmapped recompute, carried over
    (convert.opt_state_from_jax), then one step without a recompute in
    each package (the port's EkfacFit with members: each member's capture
    on its own params and image, its own moments and bases): every
    member's preconditioned gradient within 1e-4 of the largest magnitude,
    as test_update_and_precondition_match_jax_given_jax_bases."""
    from implicit_image_tpu.optim import ekfac as jek
    from implicit_image_tpu_torch.convert import opt_state_from_jax
    from implicit_image_tpu_torch.optim.ekfac import EkfacState
    from implicit_image_tpu_torch.training.fit import EkfacFit

    jm, jc = jbuild("siren", depth=3, hidden_size=8)
    ps = [jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(s), jc)) for s in (0, 1)]
    stacked = jax.tree.map(lambda *v: np.stack(v), *ps)
    coords = np.array(jgrid(16, 16)).reshape(-1, 2)
    targets = _imgs(2).reshape(2, -1, 3)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda v: (rng.standard_normal(v.shape) * 0.1).astype(np.float32),
                         stacked)

    def recomputed(p, t):
        st = jek.ekfac_init(p, jek.model_skip_indices("siren", p))
        return jek.ekfac_update_stats(st, *jek.capture_layer_stats(jm, jc, p, coords, t),
                                      recompute_eigs=True)

    def step(st, p, t, g):
        st = jek.ekfac_update_stats(st, *jek.capture_layer_stats(jm, jc, p, coords, t),
                                    recompute_eigs=False)
        return jek.ekfac_precondition(st, g, eps=0.1, skip=jek.model_skip_indices("siren", p))

    jp = jax.tree.map(jnp.asarray, stacked)
    jst = jax.jit(jax.vmap(recomputed))(jp, jnp.asarray(targets))
    jpre = jax.jit(jax.vmap(step))(jst, jp, jnp.asarray(targets),
                                   jax.tree.map(jnp.asarray, grads))
    st = opt_state_from_jax(jst)
    m, c = build_model("siren", depth=3, hidden_size=8)
    ekfac = EkfacFit(m, c, torch.from_numpy(coords), [torch.from_numpy(t) for t in targets],
                     OptimConfig(preconditioner="ekfac", precond_interval=10), 1,
                     [EkfacState(*(tuple(x[i] for x in part) for part in st)) for i in range(2)],
                     members=True)
    tpre = ekfac.precondition(1, params_from_jax(stacked, "cpu"), params_from_jax(grads, "cpu"))
    for a, b in zip(tpre, jpre):
        for k in a:
            for i in range(2):
                _assert_close(a[k][i].numpy(), np.asarray(b[k])[i], 1e-4, (k, i))
