"""Port parity: the EKFAC preconditioner (optim/ekfac.py) and its place in
the fit (training/fit.py) and the checkpoints.

Eigenvectors are defined up to sign, and up to a rotation inside a
repeated eigenvalue, so the two packages may legitimately store different
bases for one A or G (the identity at init, a rank-deficient A). Hence:
  * the capture (per-layer inputs and per-sample pre-activation grads) is
    held against JAX directly, each within 1e-4 of the layer's largest:
    fp32 chains whose sines take arguments up to omega 30 (SIREN) or
    2 pi x B (Fourier, |B| ~ 16), so a last-bit difference of an argument
    reads ~3e-5 in its sine;
  * the moment update and the preconditioning are held against JAX with
    JAX'S OWN BASES passed into the port (recompute_eigs=False on JAX's
    state after its recompute): m2 within 1e-4 relative, the preconditioned
    grads within 1e-4 of the largest;
  * a recompute is held to what a basis must do: the port's bases are
    orthonormal, diagonalize A and G, and match JAX's columns up to sign
    where the spectrum is distinct;
  * whole fits run on SIREN inputs whose A and G spectra are distinct
    (full-rank A from 144 samples of <= 17 features), where the
    preconditioned grads do not depend on the sign of a basis vector: 10
    steps within 1e-3 of the largest weight (the preconditioner's eps 0.1
    divides by small second moments, which amplifies the fp32 capture's
    differences tenfold over the fit parity bound 1e-4);
  * chunked against unchunked capture within 1e-4 (the Grams summed in
    another order), the JAX test's comparison through the preconditioned
    grads;
  * a JAX checkpoint of an EKFAC fit resumes in the port (and the port's
    in JAX) with every factor carried exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.optim import ekfac as jek
from implicit_image_tpu.training.checkpoint import load_checkpoint as jload
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import fit as jfit
from implicit_image_tpu_torch.convert import checkpoint_from_jax, params_from_jax
from implicit_image_tpu_torch.data import get_grid, synthetic_image
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.optim import ekfac as tek
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.checkpoint import load_checkpoint
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)

FAMILIES = {
    "siren": dict(depth=3, hidden_size=8),
    "fourier": dict(depth=4, hidden_size=8, map_size=8),
    "coordx": dict(depth=5, hidden_size=8, split_depth=2),
    "wavelet_siren": dict(depth=3, hidden_size=8, height=16, width=16),
    "hashgrid": dict(n_levels=4, log2_table_size=6, base_resolution=4, finest_resolution=16,
                     hidden_size=8),
}
SIDE = 16


def _family(name, seed=0):
    jm, jc = jbuild(name, **FAMILIES[name])
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    m, c = build_model(name, **FAMILIES[name])
    coords = np.asarray(jgrid(SIDE, SIDE)).reshape(-1, 2)
    target = np.random.default_rng(seed + 1).uniform(size=(SIDE * SIDE, 3)).astype(np.float32)
    return jm, jc, p, m, c, coords, target


def _capture_both(name, seed=0):
    jm, jc, p, m, c, coords, target = _family(name, seed)
    jacts, jgrads = jek.capture_layer_stats(jm, jc, jax.tree.map(jnp.asarray, p),
                                            jnp.asarray(coords), jnp.asarray(target))
    tacts, tgrads = tek.capture_layer_stats(m, c, params_from_jax(p, "cpu"),
                                            torch.from_numpy(coords), torch.from_numpy(target))
    return (jm, jc, p, m, c, coords, target), (jacts, jgrads), (tacts, tgrads)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_capture_matches_jax(name):
    (jm, jc, p, *_), (jacts, jgrads), (tacts, tgrads) = _capture_both(name)
    skip = tek.model_skip_indices(name, p)
    assert skip == jek.model_skip_indices(name, p)
    assert len(tacts) == len(jacts) == len(tgrads) == sum(
        1 for i, layer in enumerate(p) if "w" in layer and i not in skip)
    for j, (ta, ja, tg, jg) in enumerate(zip(tacts, jacts, tgrads, jgrads)):
        assert ta.shape == ja.shape and tg.shape == jg.shape, j
        for ours, ref in ((ta.numpy(), np.asarray(ja)), (tg.numpy(), np.asarray(jg))):
            assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max(), (name, j)


def _jax_recomputed(name, seed=0):
    """JAX's state after one recomputing update from a desynchronized m2,
    and the inputs of that update."""
    both = _capture_both(name, seed)
    p = both[0][2]
    skip = jek.model_skip_indices(name, p)
    st0 = jek.ekfac_init(jax.tree.map(jnp.asarray, p), skip)
    st0 = st0._replace(m2=tuple(m * 1.7 for m in st0.m2))
    jst = jek.ekfac_update_stats(st0, *both[1], recompute_eigs=True)
    return both, st0, jst


def _tstate(jstate):
    return tek.EkfacState(*(tuple(torch.from_numpy(np.array(x)) for x in part)
                            for part in jstate))


@pytest.mark.parametrize("name", ["siren", "coordx", "hashgrid"])
def test_update_and_precondition_match_jax_given_jax_bases(name):
    """JAX's bases (from its recompute) passed into the port: the port's
    moment update without a recompute, and its preconditioning of one
    gradient, against JAX's on the same state."""
    (fam, jcap, tcap), _, jst = _jax_recomputed(name)
    jm, jc, p, m, c, coords, target = fam
    jnext = jek.ekfac_update_stats(jst, *jcap, recompute_eigs=False)
    tnext = tek.ekfac_update_stats(_tstate(jst), *tcap, recompute_eigs=False)
    for tb, jb in zip(tnext.ua + tnext.ug, jnext.ua + jnext.ug):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))  # the bases carried
    for tm, jm2 in zip(tnext.m2, jnext.m2):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm2), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(np.asarray(jm2)).max()))
    rng = np.random.default_rng(3)
    g = tuple({k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32) for k, v in layer.items()}
              for layer in p)
    skip = jek.model_skip_indices(name, p)
    jpre = jek.ekfac_precondition(jnext, jax.tree.map(jnp.asarray, g), eps=0.1, skip=skip)
    tpre = tek.ekfac_precondition(_tstate(jnext), params_from_jax(g, "cpu"), eps=0.1, skip=skip)
    for i, (ta, ja) in enumerate(zip(tpre, jpre)):
        for k in ta:
            ref = np.asarray(ja[k])
            if i in skip or k not in ("w", "b"):
                np.testing.assert_array_equal(ta[k].numpy(), g[i][k])  # passed through
            assert np.abs(ta[k].numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), (i, k)


@pytest.mark.parametrize("name", ["siren", "fourier"])
def test_recompute_gives_bases_of_a_and_g(name):
    """The port's recomputed bases are orthonormal, diagonalize A and G,
    and equal JAX's up to the sign of each column (distinct spectra)."""
    (fam, jcap, tcap), st0, jst = _jax_recomputed(name)
    tst = tek.ekfac_update_stats(_tstate(st0), *tcap, recompute_eigs=True)
    for j, (a, g) in enumerate(zip(*tcap)):
        a1 = torch.cat([a, torch.ones(a.shape[0], 1)], 1).double()
        gs = (g * a.shape[0]).double()
        for u, mat, ju in ((tst.ua[j], a1.t() @ a1 / a.shape[0], jst.ua[j]),
                           (tst.ug[j], gs.t() @ gs / a.shape[0], jst.ug[j])):
            u = u.double()
            np.testing.assert_allclose((u.t() @ u).numpy(), np.eye(u.shape[0]), atol=1e-5)
            d = (u.t() @ mat @ u).numpy()
            off = d - np.diag(np.diag(d))
            assert np.abs(off).max() <= 1e-4 * np.abs(d).max(), j
            ev = np.linalg.eigvalsh(mat.numpy())
            distinct = np.min(np.diff(ev)) > 1e-3 * ev[-1]
            if distinct:
                dots = np.abs(np.sum(u.numpy() * np.asarray(ju, np.float64), axis=0))
                np.testing.assert_allclose(dots, 1.0, atol=1e-3)


@pytest.mark.parametrize("recompute", [True, False])
def test_chunked_capture_matches_unchunked(recompute):
    """The JAX test's check: the chunked update (4 chunks) against the
    unchunked one on the same batch, through the preconditioned grads
    (basis-order invariant), in both refresh modes; and the port's chunked
    m2 against JAX's chunked m2 given JAX's bases."""
    jm, jc, p, m, c, coords, target = _family("siren", 2)
    tp = params_from_jax(p, "cpu")
    tc, tt = torch.from_numpy(coords), torch.from_numpy(target)
    acts, grads = tek.capture_layer_stats(m, c, tp, tc, tt)
    st0 = tek.ekfac_init(tp)
    st0 = st0._replace(m2=tuple(x * 1.7 for x in st0.m2))
    ref = tek.ekfac_update_stats(st0, acts, grads, recompute_eigs=recompute)
    chk = tek.ekfac_update_stats_chunked(st0, m, c, tp, tc, tt, chunks=4,
                                         recompute_eigs=recompute)
    rng = np.random.default_rng(4)
    g = params_from_jax(tuple({k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                               for k, v in layer.items()} for layer in p), "cpu")
    for la, lb in zip(tek.ekfac_precondition(ref, g), tek.ekfac_precondition(chk, g)):
        for k in la:
            assert (la[k] - lb[k]).abs().max() <= 1e-4 * la[k].abs().max(), k
    jst0 = jek.ekfac_init(jax.tree.map(jnp.asarray, p))
    jchk = jek.ekfac_update_stats_chunked(jst0, jm, jc, jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(coords), jnp.asarray(target), chunks=4,
                                          recompute_eigs=True)
    tchk = tek.ekfac_update_stats_chunked(_tstate(jchk), m, c, tp, tc, tt, chunks=4,
                                          recompute_eigs=False)
    jnext = jek.ekfac_update_stats_chunked(jchk, jm, jc, jax.tree.map(jnp.asarray, p),
                                           jnp.asarray(coords), jnp.asarray(target), chunks=4,
                                           recompute_eigs=False)
    for tm, jm2 in zip(tchk.m2, jnext.m2):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm2), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(np.asarray(jm2)).max()))


def _fit_pair(steps, chunks=1, masking=None, **train):
    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(8), jc))
    img = synthetic_image(12, 12, seed=9)
    okw = dict(lr=1e-3, preconditioner="ekfac", precond_interval=4, precond_eps=0.1)
    jres = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(12, 12), img,
                JTrain(num_steps=steps, log_steps=steps, matmul_precision="tensorfloat32",
                       pixel_chunks=chunks, **train),
                JOptim(**okw), init_params=jax.tree.map(jnp.asarray, init))
    m, c = build_model("siren", depth=3, hidden_size=16)
    return jres, (m, c, init, img, okw)


@pytest.mark.parametrize("chunks", [1, 2])
def test_ekfac_fit_matches_jax(chunks):
    """10 steps (bases recomputed at steps 0, 4 and 8), whole and in 2
    pixel chunks."""
    jres, (m, c, init, img, okw) = _fit_pair(10, chunks)
    tres = fit(torch.Generator().manual_seed(0), m, c, get_grid(12, 12), img,
               TrainConfig(num_steps=10, log_steps=10, pixel_chunks=chunks), OptimConfig(**okw),
               init_params=params_from_jax(init, "cpu"), device="cpu")
    for a, b in zip(tres.params, jres.params):
        for k in a:
            ref = np.asarray(b[k])
            assert np.abs(a[k].numpy() - ref).max() <= 1e-3 * np.abs(ref).max(), k


def test_ekfac_resume_across_packages(tmp_path):
    """JAX checkpoints an EKFAC fit at step 5: the port reads its factors
    exactly and resumes it to 10 within the fit bound of JAX's own run; the
    port's checkpoint at 5 carries the same keys, which JAX reads back
    exactly and resumes."""
    import shutil

    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    init = jax.tree.map(jnp.asarray, jm.init(jax.random.PRNGKey(8), jc))
    img = synthetic_image(12, 12, seed=9)
    okw = dict(lr=1e-3, preconditioner="ekfac", precond_interval=4, precond_eps=0.1)
    ck = tmp_path / "jax.npz"

    def watch(params, opt_state, step):
        if step == 5:
            shutil.copy(ck, tmp_path / "j5.npz")

    jres = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(12, 12), img,
                JTrain(num_steps=10, log_steps=5, segment_steps=5,
                       matmul_precision="tensorfloat32"),
                JOptim(**okw), checkpoint_path=ck, watch=watch, init_params=init)
    state = checkpoint_from_jax(tmp_path / "j5.npz")
    ref = jload(tmp_path / "j5.npz")
    for name in ("ua", "ug", "m2"):
        for a, b in zip(getattr(state["ekfac_state"], name), getattr(ref["ekfac_state"], name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    m, c = build_model("siren", depth=3, hidden_size=16)
    tres = fit(torch.Generator().manual_seed(0), m, c, get_grid(12, 12), img,
               TrainConfig(num_steps=10, log_steps=5, segment_steps=5), OptimConfig(**okw),
               resume_from=tmp_path / "j5.npz", device="cpu",
               checkpoint_path=tmp_path / "port.npz")
    for a, b in zip(tres.params, jres.params):
        for k in a:
            r = np.asarray(b[k])
            assert np.abs(a[k].numpy() - r).max() <= 1e-3 * np.abs(r).max(), k
    ours, theirs = load_checkpoint(tmp_path / "port.npz"), jload(tmp_path / "port.npz")
    assert ours["step"] == theirs["step"] == 10
    for name in ("ua", "ug", "m2"):
        for a, b in zip(getattr(ours["ekfac_state"], name), getattr(theirs["ekfac_state"], name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ekfac_resume_is_bit_exact(tmp_path):
    """A port EKFAC fit stopped at 6 and resumed to 12 ends on the
    uninterrupted fit's bits (the resume lands between two recomputes)."""
    m, c = build_model("siren", depth=3, hidden_size=8)
    img = synthetic_image(8, 8, seed=1)
    okw = OptimConfig(lr=1e-3, preconditioner="ekfac", precond_interval=4)
    run = dict(device="cpu")
    full = fit(torch.Generator().manual_seed(0), m, c, get_grid(8, 8), img,
               TrainConfig(num_steps=12, log_steps=6), okw, **run)
    fit(torch.Generator().manual_seed(0), m, c, get_grid(8, 8), img,
        TrainConfig(num_steps=6, log_steps=6, segment_steps=6), okw,
        checkpoint_path=tmp_path / "ck.npz", **run)
    rest = fit(torch.Generator().manual_seed(0), m, c, get_grid(8, 8), img,
               TrainConfig(num_steps=12, log_steps=6), okw, resume_from=tmp_path / "ck.npz", **run)
    for a, b in zip(full.params, rest.params):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_ekfac_guards(tmp_path):
    """wavelet_siren with pixel_chunks > 1 and Feathermap raise ValueError,
    as in the JAX package; so does resuming an EKFAC fit from a checkpoint
    that holds no EKFAC state."""
    okw = OptimConfig(preconditioner="ekfac")
    m, c = build_model("wavelet_siren", depth=3, hidden_size=8, height=8, width=8)
    with pytest.raises(ValueError, match="full-grid"):
        fit(torch.Generator().manual_seed(0), m, c, get_grid(8, 8), synthetic_image(8, 8),
            TrainConfig(num_steps=1, pixel_chunks=2), okw, device="cpu")
    from implicit_image_tpu_torch.feathermap import build_feather_model

    m, c = build_model("siren", depth=3, hidden_size=8)
    fm = build_feather_model(m, c, 0.5)
    with pytest.raises(ValueError, match="Feathermap"):
        fit(torch.Generator().manual_seed(0), fm, c, get_grid(8, 8), synthetic_image(8, 8),
            TrainConfig(num_steps=1), okw, device="cpu")
    fit(torch.Generator().manual_seed(0), m, c, get_grid(8, 8), synthetic_image(8, 8),
        TrainConfig(num_steps=2, segment_steps=2), OptimConfig(), device="cpu",
        checkpoint_path=tmp_path / "adam.npz")
    with pytest.raises(ValueError, match="EKFAC state"):
        fit(torch.Generator().manual_seed(0), m, c, get_grid(8, 8), synthetic_image(8, 8),
            TrainConfig(num_steps=4), okw, device="cpu", resume_from=tmp_path / "adam.npz")
    with pytest.raises(ValueError, match="preconditioner"):
        fit(torch.Generator().manual_seed(0), m, c, get_grid(8, 8), synthetic_image(8, 8),
            TrainConfig(num_steps=1), OptimConfig(preconditioner="kfac"), device="cpu")


def test_ekfac_sparse_fit_reads_preconditioned_grads():
    """Under RigL the topology update reads the preconditioned gradients (the
    JAX package's order): a short RigL + EKFAC fit runs, keeps its pruned
    weights at 0 and conserves each layer's count."""
    m, c = build_model("siren", depth=3, hidden_size=16)
    mk = MaskingConfig(density=0.5, interval=3, end_when=8)
    res = fit(torch.Generator().manual_seed(0), m, c, get_grid(12, 12), synthetic_image(12, 12),
              TrainConfig(num_steps=9, log_steps=9),
              OptimConfig(lr=1e-3, preconditioner="ekfac", precond_interval=4), mk,
              device="cpu")
    for layer, mask in zip(res.params, res.mask_state.masks):
        if mask is not None:
            assert not layer["w"][mask == 0].any()
    assert np.isfinite(res.metrics["psnr"][-1])
