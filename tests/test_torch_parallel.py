"""Port parity: the pixel-sharded fit, render and pipeline of
implicit_image_tpu_torch.parallel on CPU process groups (gloo, a file://
rendezvous under the test's tmp dir, a 120 s limit per spawn), against the
JAX package's sharded programs on its virtual CPU mesh and against the
port's own single fit with pixel chunks.

Each spawn runs every check of one mesh at once (module fixtures) and
returns what the tests compare. Spawned ranks import this module: it
imports JAX inside the tests only, so the ranks import no JAX.

Tolerances against JAX (float32 products on both sides, one init copied
from the JAX package): logged PSNRs within 0.05 dB and final params within
1e-3 of each leaf's largest magnitude, as tests/test_torch_batched.py; a
render within 1e-5. Against the port's single fit: bit for bit.
"""
import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid, synthetic_image
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.parallel.multihost import run_group
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)

SIREN = ("siren", dict(depth=3, hidden_size=8))
COORDX = ("coordx", dict(depth=6, hidden_size=16, split_depth=2))
HASHGRID = ("hashgrid", dict(n_levels=4, log2_table_size=6, base_resolution=4,
                             finest_resolution=24, depth=2, hidden_size=8))
RENDER = {"siren": ("siren", dict(depth=3, hidden_size=16)),
          "coordx": ("coordx", dict(depth=4, hidden_size=16, split_depth=2))}
# (model, side, steps, lr, train options) of the JAX-parity fits
PARITY = {"siren": (SIREN, 32, 60, 1e-3, {}), "coordx": (COORDX, 16, 20, 1e-3, {}),
          "hashgrid": (HASHGRID, 16, 20, 1e-2, {}),
          "ms-ssim": (("siren", dict(depth=3, hidden_size=16)), 32, 30, 1e-3,
                      {"loss": "ms-ssim"})}
RIGL = MaskingConfig(density=0.5, end_when=20, interval=5)
SNFS = MaskingConfig(name="SNFS", growth_mode="momentum", redistribution_mode="momentum",
                     density=0.5, end_when=20, interval=5)


def _tc(steps, log, **kw):
    return TrainConfig(num_steps=steps, log_steps=log, matmul_precision="float32", **kw)


def _state(res):
    """What the exact checks compare of a FitResult."""
    out = {"params": res.params, "loss": res.metrics["loss"], "psnr": res.metrics["psnr"]}
    if res.mask_state is not None:
        out["masks"] = res.mask_state.masks
    if hasattr(res.opt_state, "mu"):
        out["mu"], out["nu"] = res.opt_state.mu, res.opt_state.nu
    return out


def _sharded_vs_chunked(mesh, rank, mk, k=1, **train):
    """The sharded fit on `mesh` with train.pixel_chunks = k, and on rank 0
    the single fit with pixel_chunks = k · pixel (16², d3 w16, 30 steps)."""
    from implicit_image_tpu_torch.parallel import sharded_fit

    mdef, mcfg = build_model("siren", depth=3, hidden_size=16)
    img = synthetic_image(16, 16, seed=2)
    tc = _tc(30, 10, pixel_chunks=k, **train)
    res = sharded_fit(torch.Generator().manual_seed(3), mesh, mdef, mcfg, get_grid(16, 16), img,
                      tc, OptimConfig(lr=1e-3), mk)
    out = {"sharded": _state(res)}
    if rank == 0:
        single = fit(torch.Generator().manual_seed(3), mdef, mcfg, get_grid(16, 16), img,
                     dataclasses.replace(tc, pixel_chunks=k * mesh.shape["pixel"]),
                     OptimConfig(lr=1e-3), mk)
        out["single"] = _state(single)
    return out


def _parity_fit(mesh, name, init, **kw):
    """The sharded dense fit of PARITY[name] from the JAX package's init."""
    from implicit_image_tpu_torch.parallel import sharded_fit

    (model, arch), side, steps, lr, train = PARITY[name]
    mdef, mcfg = build_model(model, **arch)
    args = (mdef, mcfg, get_grid(side, side), synthetic_image(side, side, seed=0),
            _tc(steps, steps // 2, **train, **kw), OptimConfig(lr=lr))
    init = params_from_jax(init, "cpu")
    res = sharded_fit(torch.Generator().manual_seed(0), mesh, *args, init_params=init)
    out = _state(res)
    if name == "ms-ssim" and mesh.pixel.rank == 0:
        out["single"] = _state(fit(torch.Generator().manual_seed(0), *args, init_params=init))
    return out


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def _pixel4(rank, inits, renders, tmp):
    """Every check of the 4-rank pixel mesh."""
    from implicit_image_tpu_torch.parallel import (
        make_mesh,
        make_sharded_fit_fn,
        sharded_compress,
        sharded_render,
    )
    from implicit_image_tpu_torch.parallel import pipeline as pl
    from implicit_image_tpu_torch.training.quant_phase import quant_finetune

    out = {"meshes": {}}
    for shape in ((2, 2), (4, 1)):
        m = make_mesh(*shape, device="cpu")
        out["meshes"][shape] = (m.shape, m.image.ranks, m.pixel.ranks, m.image.rank,
                                m.pixel.rank)
    out["mesh_errors"] = [_raises(lambda s=s: make_mesh(*s, device="cpu"))
                          for s in ((3, 2), (1, 2), (2, 1))]
    mesh = make_mesh(1, 4, device="cpu")

    # the JAX package's cases, from its inits
    for name in PARITY:
        out[name] = _parity_fit(mesh, name, inits[name])
    out["siren_seg"] = _parity_fit(mesh, "siren", inits["siren"], segment_steps=25)

    # exact: RigL, EKFAC and the stop check against the single fit's chunks
    out["rigl"] = _sharded_vs_chunked(mesh, rank, RIGL)
    mdef, mcfg = build_model("siren", depth=3, hidden_size=8)
    img = synthetic_image(16, 16, seed=4)
    ek = OptimConfig(lr=1e-3, preconditioner="ekfac", precond_interval=5)
    tc = _tc(12, 6)
    out["ekfac"] = {"sharded": _state(fit(torch.Generator().manual_seed(1), mdef, mcfg,
                                          get_grid(16, 16), img, tc, ek,
                                          pixel_group=mesh.pixel))}
    stop = dict(stop_psnr=12.0)
    tcs = _tc(40, 40, segment_steps=5)
    r = fit(torch.Generator().manual_seed(1), mdef, mcfg, get_grid(16, 16), img, tcs,
            OptimConfig(lr=1e-3), pixel_group=mesh.pixel, **stop)
    out["stop"] = {"sharded": (_state(r), r.stopped_at, r.stop_psnr_db)}
    if rank == 0:
        out["ekfac"]["single"] = _state(fit(torch.Generator().manual_seed(1), mdef, mcfg,
                                            get_grid(16, 16), img,
                                            dataclasses.replace(tc, pixel_chunks=4), ek))
        s = fit(torch.Generator().manual_seed(1), mdef, mcfg, get_grid(16, 16), img,
                dataclasses.replace(tcs, pixel_chunks=4), OptimConfig(lr=1e-3), **stop)
        out["stop"]["single"] = (_state(s), s.stopped_at, s.stop_psnr_db)

    # refusals, before any work
    tc5 = _tc(5, 5)
    errs = {}
    errs["indivisible"] = _raises(lambda: make_sharded_fit_fn(
        mesh, mdef, mcfg, get_grid(30, 30), tc5, OptimConfig()))
    wdef, wcfg = build_model("wavelet_siren", height=16, width=16, depth=4, hidden_size=16)
    errs["wavelet"] = _raises(lambda: make_sharded_fit_fn(
        mesh, wdef, wcfg, get_grid(16, 16), tc5, OptimConfig()))
    out["errors"] = errs

    # renders: the whole lattice, a window, and a window whose rows do not split
    out["renders"] = {}
    for name, p in renders.items():
        model, arch = RENDER[name]
        m, c = build_model(model, **arch)
        params = params_from_jax(p, "cpu")
        full = sharded_render(mesh, m, c, params, 32, 16)
        win = sharded_render(mesh, m, c, params, 32, 16, roi=(8, 24, 2, 14))
        single = m.apply(params, get_grid(32, 16), c, "fp32")
        out["renders"][name] = (full, win, single, _raises(
            lambda: sharded_render(mesh, m, c, params, 32, 16, roi=(0, 10, 0, 16))))

    # the pipeline: sharded, and on rank 0 the single pipeline with 4 chunks
    mdef16, mcfg16 = build_model("siren", depth=3, hidden_size=16)
    img3 = synthetic_image(16, 16, seed=3)
    mk = MaskingConfig(density=0.5, end_when=30, interval=10)
    tcp, qc = _tc(40, 20), QuantConfig(bits=4, num_steps=10)
    res = sharded_compress(torch.Generator().manual_seed(0), mesh, mdef16, mcfg16,
                           get_grid(16, 16), img3, tcp, OptimConfig(lr=1e-3), mk, qc,
                           stream_name="zstd", stream_dir=str(Path(tmp) / "sh"))
    out["pipeline"] = {"sharded": res}
    if rank == 0:
        f = fit(torch.Generator().manual_seed(0), mdef16, mcfg16, get_grid(16, 16), img3,
                dataclasses.replace(tcp, pixel_chunks=4), OptimConfig(lr=1e-3), mk)
        q = quant_finetune(f.params, img3, mdef16, mcfg16, get_grid(16, 16), qc,
                           OptimConfig(lr=1e-3), pixel_chunks=4, masks=f.mask_state.masks)
        nbytes, dec = pl._encode_decode(q.params, q.codebooks, mdef16, mcfg16, 16, 16,
                                        np.asarray(img3, np.float64), Path(tmp) / "single",
                                        "zstd", "auto", device="cpu")
        out["pipeline"]["single"] = (q.params, q.metrics["quant_psnr"], nbytes, dec)

    # the stream backend's kwargs reach the encoder and the decoder
    seen = {}
    real = pl.compress_state_dict

    def spy(state, d, name, **kw):
        seen.update(kw)
        return real(state, d, name, **kw)

    pl.compress_state_dict = spy
    m8, c8 = build_model("siren", depth=2, hidden_size=8)
    kres = sharded_compress(torch.Generator().manual_seed(0), mesh, m8, c8, get_grid(8, 8),
                            synthetic_image(8, 8, seed=0), _tc(4, 2), OptimConfig(lr=1e-3),
                            stream_name="zstd", stream_dir=str(Path(tmp) / "kw"),
                            coding_kwargs={"level": 3})
    pl.compress_state_dict = real
    out["kwargs"] = (dict(seen), kres.compressed_bytes)
    return out


def _pixel2(rank, tmp):
    """The 2-rank pixel mesh: RigL and SNFS against the single fit's chunks,
    two chunks a rank, and the codebook finetune over the pixel group."""
    from implicit_image_tpu_torch.parallel import make_mesh
    from implicit_image_tpu_torch.training.quant_phase import quant_finetune

    mesh = make_mesh(1, 2, device="cpu")
    out = {"rigl": _sharded_vs_chunked(mesh, rank, RIGL),
           "snfs": _sharded_vs_chunked(mesh, rank, SNFS),
           "rigl_k2": _sharded_vs_chunked(mesh, rank, RIGL, k=2)}
    mdef, mcfg = build_model("siren", depth=3, hidden_size=16)
    img = synthetic_image(16, 16, seed=5)
    base = fit(torch.Generator().manual_seed(6), mdef, mcfg, get_grid(16, 16), img, _tc(20, 10),
               OptimConfig(lr=1e-3), RIGL)
    qc = QuantConfig(bits=4, num_steps=8, ecvq_lambda=1.0)
    q = quant_finetune(base.params, img, mdef, mcfg, get_grid(16, 16), qc, OptimConfig(lr=1e-3),
                       masks=base.mask_state.masks, pixel_group=mesh.pixel)
    out["quant"] = {"sharded": (q.params, q.codebooks, q.metrics)}
    if rank == 0:
        s = quant_finetune(base.params, img, mdef, mcfg, get_grid(16, 16), qc,
                           OptimConfig(lr=1e-3), pixel_chunks=2, masks=base.mask_state.masks)
        out["quant"]["single"] = (s.params, s.codebooks, s.metrics)
    from implicit_image_tpu_torch.parallel.sharded import cli

    cli(CLI + [f"output_dir={tmp}/cli"])
    return out


CLI = ["device=cpu", "img=synthetic", "img.height=16", "img.width=16", "mlp.depth=3",
       "mlp.hidden_size=8", "train.num_steps=10", "train.log_steps=5", "quant.num_steps=4",
       "entropy_coding=zstd"]


def _jax_inits():
    import jax

    from implicit_image_tpu.models import build_model as jbuild

    inits = {}
    for name, ((model, arch), _, _, _, _) in PARITY.items():
        jm, jc = jbuild(model, **arch)
        inits[name] = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jc))
    renders = {}
    for name, (model, arch) in RENDER.items():
        jm, jc = jbuild(model, **arch)
        renders[name] = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5), jc))
    return inits, renders


@pytest.fixture(scope="module")
def jax_inits():
    return _jax_inits()


@pytest.fixture(scope="module")
def pixel4(jax_inits, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pixel4")
    res = run_group(_pixel4, 4, (*jax_inits, str(tmp)), device="cpu", workdir=str(tmp))
    return res, tmp


@pytest.fixture(scope="module")
def pixel2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pixel2")
    return run_group(_pixel2, 2, (str(tmp),), device="cpu", workdir=str(tmp)), tmp


def _equal(a, b, what=""):
    """Trees of tensors (and numpy arrays) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, np.ndarray) and what.endswith(".psnr"):
        # the eval sums its squared errors over the ranks: within 1e-4 dB
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=what)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        assert a == b or (a != a and b != b), (what, a, b)


def _exact(results, key):
    """Every rank's sharded result is rank 0's single fit's, bit for bit."""
    single = results[0][key]["single"]
    for rank, r in enumerate(results):
        _equal(r[key]["sharded"], single, f"rank {rank} {key}")


def _jax_sharded(name, init, n_pixel):
    """The JAX package's sharded fit (make_sharded_fit_fn's jit: key
    replicated, image rows over "pixel") of PARITY[name] from `init`, and its
    single fit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from implicit_image_tpu.data import get_grid as jgrid
    from implicit_image_tpu.models import build_model as jbuild
    from implicit_image_tpu.parallel import make_mesh as jmesh
    from implicit_image_tpu.training.fit import OptimConfig as JOptim
    from implicit_image_tpu.training.fit import TrainConfig as JTrain
    from implicit_image_tpu.training.fit import make_fit_fn

    (model, arch), side, steps, lr, train = PARITY[name]
    jm, jc = jbuild(model, **arch)
    mesh = jmesh(image=1, pixel=n_pixel)
    fn = jax.jit(make_fit_fn(jm, jc, jgrid(side, side),
                             JTrain(num_steps=steps, log_steps=steps // 2,
                                    matmul_precision="float32", **train),
                             JOptim(lr=lr), init_params=init),
                 in_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P("pixel"))))
    params, _, _, metrics = fn(jax.random.PRNGKey(0), synthetic_image(side, side, seed=0))
    return jax.tree.map(np.asarray, params), np.asarray(metrics["psnr"])


def _close_to_jax(ours, jparams, jpsnr, psnr_tol=0.05, rel_tol=1e-3):
    logged = ~np.isnan(jpsnr)
    np.testing.assert_array_equal(logged, ~np.isnan(ours["psnr"]))
    np.testing.assert_allclose(ours["psnr"][logged], jpsnr[logged], atol=psnr_tol)
    for a, b in zip(ours["params"], jparams):
        for k in a:
            ref = np.asarray(b[k])
            assert np.abs(a[k].numpy() - ref).max() <= rel_tol * np.abs(ref).max(), k


def test_make_mesh_shapes(pixel4):
    """The JAX package's mesh shapes on 4 ranks, row-major (rank = i · pixel
    + p); a mesh needing more ranks raises ValueError as in JAX, and so does
    one needing fewer (the port's mesh covers its whole process group)."""
    from implicit_image_tpu.parallel import make_mesh as jmesh

    results, _ = pixel4
    assert jmesh(image=2, pixel=2).shape == results[0]["meshes"][(2, 2)][0]
    for rank, r in enumerate(results):
        shape, image, pixel, i, p = r["meshes"][(2, 2)]
        assert shape == {"image": 2, "pixel": 2}
        assert (i, p) == divmod(rank, 2)
        assert pixel == [2 * i, 2 * i + 1] and image == [p, 2 + p]
        shape, image, pixel, i, p = r["meshes"][(4, 1)]
        assert shape == {"image": 4, "pixel": 1} and image == [0, 1, 2, 3] and pixel == [rank]
        assert "needs 6 ranks, have 4" in r["mesh_errors"][0]
        assert all("covers 2 of 4 ranks" in e for e in r["mesh_errors"][1:])


def test_make_mesh_needs_a_process_group():
    from implicit_image_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(1, 1, device="cpu")


@pytest.mark.parametrize("name", ["siren", "coordx", "hashgrid", "ms-ssim"])
def test_sharded_fit_matches_jax(pixel4, jax_inits, name):
    """The JAX package's test_sharded_fit_matches_unsharded,
    test_coordx_batched_and_sharded and test_hashgrid_batched_and_sharded
    (the sharded half), and train.loss=ms-ssim, which JAX's GSPMD also runs
    with the rows sharded: the port's fit over 4 pixel ranks against JAX's
    sharded fit over 4 devices and JAX's single fit, from one init; every
    rank holds the same result."""
    from implicit_image_tpu.data import get_grid as jgrid
    from implicit_image_tpu.models import build_model as jbuild
    from implicit_image_tpu.training.fit import OptimConfig as JOptim
    from implicit_image_tpu.training.fit import TrainConfig as JTrain
    from implicit_image_tpu.training.fit import fit as jfit
    import jax

    results, _ = pixel4
    for r in results[1:]:
        _equal(r[name], {k: v for k, v in results[0][name].items() if k != "single"}, name)
    init = jax_inits[0][name]
    jparams, jpsnr = _jax_sharded(name, init, 4)
    _close_to_jax(results[0][name], jparams, jpsnr)
    (model, arch), side, steps, lr, train = PARITY[name]
    jm, jc = jbuild(model, **arch)
    single = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(side, side),
                  synthetic_image(side, side, seed=0),
                  JTrain(num_steps=steps, log_steps=steps // 2, matmul_precision="float32",
                         **train),
                  JOptim(lr=lr), init_params=init)
    _close_to_jax(results[0][name], jax.tree.map(np.asarray, single.params),
                  np.asarray(single.metrics["psnr"]))


def test_sharded_ms_ssim_is_the_single_fit(pixel4):
    """Under ms-ssim each rank takes the whole image's loss on the gathered
    predictions and the gradients are added over the ranks: the port's
    single fit up to that sum's order (PSNR within 1e-4 dB, params within
    1e-5 of each leaf's largest magnitude)."""
    ours = pixel4[0][0]["ms-ssim"]
    single = ours["single"]
    logged = ~np.isnan(single["psnr"])
    np.testing.assert_allclose(ours["psnr"][logged], single["psnr"][logged], atol=1e-4)
    for a, b in zip(ours["params"], single["params"]):
        for k in a:
            assert float((a[k] - b[k]).abs().max()) <= 1e-5 * float(b[k].abs().max()), k


def test_sharded_segmented_matches_monolithic(pixel4):
    """segment_steps is a cadence in the port: a sharded fit of 60 steps in
    segments of 25 is the monolithic one bit for bit."""
    results, _ = pixel4
    for r in results:
        _equal(r["siren_seg"], results[0]["siren"])


@pytest.mark.parametrize("key", ["rigl", "ekfac", "stop"])
def test_sharded_fit_over_4_ranks_is_the_chunked_single_fit(pixel4, key):
    """The fit over 4 pixel ranks is the single fit with pixel_chunks=4 bit
    for bit on every rank: params, masks and Adam's moments under RigL;
    EKFAC's preconditioned steps (its factors summed over the ranks); the
    early stop at the same boundary with the same PSNR."""
    results, _ = pixel4
    _exact(results, key)
    if key == "stop":
        assert results[0]["stop"]["single"][1] is not None


def test_sharded_fit_rejects_indivisible_and_full_grid(pixel4):
    """ValueError before any work: rows not divisible by the pixel axis (the
    JAX package asserts), and the full-grid wavelet-SIREN, which needs the
    whole lattice on every rank (JAX's GSPMD runs it)."""
    results, _ = pixel4
    for r in results:
        e = r["errors"]
        assert "H=30 not divisible by pixel axis 4" in e["indivisible"]
        assert "wavelet_siren" in e["wavelet"] and "pixel axis of 4 needs 1" in e["wavelet"]


@pytest.mark.parametrize("name", sorted(RENDER))
def test_sharded_render_matches_single_device(pixel4, jax_inits, name):
    """tests/test_resolution_free.py's case: the render over 4 pixel ranks
    is the port's single render bit for bit (a window its slice) on every
    rank, within 1e-5 of the JAX package's; a window whose rows do not
    split raises ValueError."""
    import jax

    from implicit_image_tpu.data import get_grid as jgrid
    from implicit_image_tpu.models import build_model as jbuild

    results, _ = pixel4
    full, win, single, err = results[0]["renders"][name]
    assert torch.equal(full, single)
    assert torch.equal(win, single[8:24, 2:14])
    assert "window rows 10 not divisible by pixel axis 4" in err
    for r in results[1:]:
        _equal(r["renders"][name][:2], (full, win))
    jm, jc = jbuild(RENDER[name][0], **RENDER[name][1])
    jout = np.asarray(jax.jit(lambda p: jm.apply(p, jgrid(32, 16), jc))(
        jax.tree.map(np.asarray, jax_inits[1][name])))
    np.testing.assert_allclose(full.numpy(), jout, rtol=0, atol=1e-5)


def test_full_pipeline_pixel_sharded(pixel4):
    """fit -> k-means finetune -> container -> decode with the rows over 4
    ranks (the JAX package's case): the container decodes within 0.5 dB of
    the finetune's PSNR; every rank returns the same result; and the
    container is the single pipeline's with 4 pixel chunks, byte for byte."""
    results, tmp = pixel4
    res = results[0]["pipeline"]["sharded"]
    assert res.compressed_bytes > 0 and np.isfinite(res.quant_psnr)
    assert abs(res.decoded_psnr - res.quant_psnr) < 0.5
    for r in results[1:]:
        s = r["pipeline"]["sharded"]
        assert (s.compressed_bytes, s.decoded_psnr, s.quant_psnr, s.psnr) == (
            res.compressed_bytes, res.decoded_psnr, res.quant_psnr, res.psnr)
        _equal(s.params, res.params)
    params, qpsnr, nbytes, dec = results[0]["pipeline"]["single"]
    _equal(res.params, params)
    assert (res.quant_psnr, res.compressed_bytes, res.decoded_psnr) == (qpsnr, nbytes, dec)

    def digest(d):
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(Path(d).iterdir())}

    assert digest(tmp / "sh") == digest(tmp / "single")


def test_pipeline_forwards_coding_kwargs(pixel4):
    """The stream backend's kwargs (zstd's level) reach the encoder from
    sharded_compress, as compress.py passes them."""
    results, _ = pixel4
    seen, nbytes = results[0]["kwargs"]
    assert seen.get("level") == 3 and nbytes > 0
    assert all(r["kwargs"][1] == nbytes for r in results)


@pytest.mark.parametrize("key", ["rigl", "snfs", "rigl_k2"])
def test_sharded_fit_over_2_ranks_is_the_chunked_single_fit(pixel2, key):
    """Over 2 pixel ranks: RigL and SNFS (momentum growth) with one chunk a
    rank are the single fit with pixel_chunks=2, and RigL with two chunks a
    rank the single fit with pixel_chunks=4, bit for bit on every rank."""
    _exact(pixel2[0], key)


def test_sharded_quant_finetune_is_the_chunked_finetune(pixel2):
    """The codebook finetune (k-means with ECVQ) over 2 pixel ranks is the
    single finetune with pixel_chunks=2: params, centroids, labels and
    metrics, on every rank."""
    _exact(pixel2[0], "quant")


def test_sharded_cli_writes_a_run_dir_the_decoder_reads(pixel2):
    """`python -m implicit_image_tpu_torch.parallel.sharded` (here inside a
    2-rank group): rank 0 writes the run dir, whose container decompress
    decodes to the PSNR its summary.json reports."""
    import json

    from implicit_image_tpu_torch import compress, decompress

    run = pixel2[1] / "cli" / "synthetic" / "sharded_siren_synthetic"
    summary = json.loads((run / "summary.json").read_text())
    assert summary["pixel_ranks"] == 2 and summary["backend"] == "gloo"
    img, _ = decompress.decode_run(run, device="cpu")
    target = compress._load_image(compress.compose(CLI).img)
    mse = np.mean((np.asarray(img, np.float64) - target) ** 2)
    assert abs(10 * np.log10(1 / mse) - summary["Decoded PSNR"]) < 1e-6
