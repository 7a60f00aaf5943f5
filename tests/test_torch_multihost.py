"""Port parity: the member axis over a mesh's image ranks (batched_fit,
batched_compress, the density ladder) and the multi-process fleet of
implicit_image_tpu_torch.parallel, on CPU process groups (gloo, a file://
rendezvous in a temporary dir, a time limit on every spawn that kills the
workers).

Against the port without a mesh: bit for bit (the mesh fit of B members on
an image x pixel mesh is the batched fit at pixel_chunks x pixel). Against
the JAX package's batched fit on its virtual mesh, from one copied init:
logged PSNRs within 0.05 dB and final params within 1e-3 of each leaf's
largest magnitude, as tests/test_torch_batched.py. Spawned ranks import
this module: it imports JAX inside the tests only.
"""
import dataclasses
import hashlib
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid, synthetic_image
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.parallel.multihost import launch_dryrun, run_group
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig

torch.set_num_threads(1)

# (model, members, steps, lr) of the JAX-parity batched fits, 16², one init
PARITY = {
    "siren": (("siren", dict(depth=3, hidden_size=8)), 4, 40, 1e-3),
    "coordx": (("coordx", dict(depth=6, hidden_size=16, split_depth=2)), 2, 20, 1e-3),
    "hashgrid": (("hashgrid", dict(n_levels=4, log2_table_size=6, base_resolution=4,
                                   finest_resolution=24, depth=2, hidden_size=8)), 2, 20, 1e-2),
}
RIGL = MaskingConfig(density=0.5, end_when=20, interval=5)
PIPE_MASK = MaskingConfig(density=0.5, end_when=30, interval=10)


def _imgs(b, n=16):
    return np.stack([synthetic_image(n, n, seed=s) for s in range(b)])


def _tc(steps, log, **kw):
    return TrainConfig(num_steps=steps, log_steps=log, matmul_precision="float32", **kw)


def _state(res):
    out = {"params": res.params, "loss": res.metrics["loss"], "psnr": res.metrics["psnr"],
           "mu": res.opt_state.mu, "nu": res.opt_state.nu}
    if res.mask_state is not None:
        out["masks"] = res.mask_state.masks
        out["density"] = res.metrics["density"]
    return out


def _mesh_vs_plain(mesh, rank, mk, k=1, b=4, **train):
    """batched_fit of b images on `mesh` at train.pixel_chunks = k and, on
    rank 0, without a mesh at k · pixel (d3 w16, 30 steps)."""
    from implicit_image_tpu_torch.parallel import batched_fit

    mdef, mcfg = build_model("siren", depth=3, hidden_size=16)
    tc = _tc(30, 10, pixel_chunks=k, **train)
    res = batched_fit(torch.Generator().manual_seed(4), mdef, mcfg, get_grid(16, 16), _imgs(b),
                      tc, OptimConfig(lr=1e-3), mk, mesh=mesh)
    out = {"mesh": _state(res)}
    if rank == 0:
        plain = batched_fit(torch.Generator().manual_seed(4), mdef, mcfg, get_grid(16, 16),
                            _imgs(b), dataclasses.replace(
                                tc, pixel_chunks=1 if tc.loss == "ms-ssim"
                                else k * mesh.shape["pixel"]),
                            OptimConfig(lr=1e-3), mk, device="cpu")
        out["plain"] = _state(plain)
    return out


def _parity(mesh, name, init, **train):
    from implicit_image_tpu_torch.parallel import batched_fit

    (model, arch), b, steps, lr = PARITY[name]
    mdef, mcfg = build_model(model, **arch)
    res = batched_fit(torch.Generator().manual_seed(0), mdef, mcfg, get_grid(16, 16), _imgs(b),
                      _tc(steps, 10, **train), OptimConfig(lr=lr),
                      init_params=params_from_jax(init, "cpu"), mesh=mesh)
    return _state(res)


def _image2(rank, inits, tmp):
    """Every check of the 2 x 1 mesh."""
    from implicit_image_tpu_torch.parallel import batched_compress, make_mesh
    from implicit_image_tpu_torch.parallel.ladder import ladder_compress, ladder_fit

    mesh = make_mesh(2, 1, device="cpu")
    out = {"rigl": _mesh_vs_plain(mesh, rank, RIGL)}
    for name in PARITY:
        out[name] = _parity(mesh, name, inits[name])
    mdef, mcfg = build_model("siren", depth=3, hidden_size=16)
    tc, qc = _tc(40, 20), QuantConfig(bits=4, num_steps=10)
    out["compress"] = {"mesh": batched_compress(
        torch.Generator().manual_seed(0), mdef, mcfg, get_grid(16, 16), _imgs(2), tc,
        OptimConfig(lr=1e-3), PIPE_MASK, qc, stream_name="zstd",
        stream_root=str(Path(tmp) / "batch_mesh"), mesh=mesh)}
    m32, c32 = build_model("siren", depth=3, hidden_size=32)
    img = synthetic_image(16, 16, seed=1)
    out["ladder"] = {"mesh": ladder_compress(
        torch.Generator().manual_seed(0), m32, c32, get_grid(16, 16), img, tc,
        OptimConfig(lr=1e-3), PIPE_MASK, [0.2, 0.8], quant_cfg=qc, stream_name="zstd",
        stream_root=str(Path(tmp) / "ladder_mesh"), mesh=mesh)}
    try:
        ladder_fit(torch.Generator().manual_seed(0), m32, c32, get_grid(16, 16), img, tc,
                   OptimConfig(lr=1e-3), PIPE_MASK, [0.2, 0.5, 0.8], mesh=mesh)
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    if rank == 0:
        out["compress"]["plain"] = batched_compress(
            torch.Generator().manual_seed(0), mdef, mcfg, get_grid(16, 16), _imgs(2), tc,
            OptimConfig(lr=1e-3), PIPE_MASK, qc, stream_name="zstd",
            stream_root=str(Path(tmp) / "batch_plain"), device="cpu")
        out["ladder"]["plain"] = ladder_compress(
            torch.Generator().manual_seed(0), m32, c32, get_grid(16, 16), img, tc,
            OptimConfig(lr=1e-3), PIPE_MASK, [0.2, 0.8], quant_cfg=qc, stream_name="zstd",
            stream_root=str(Path(tmp) / "ladder_plain"), device="cpu")
    return out


def _image2_pixel2(rank, init):
    """Every check of the 2 x 2 mesh."""
    from implicit_image_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 2, device="cpu")
    return {"k1": _mesh_vs_plain(mesh, rank, RIGL),
            "k2": _mesh_vs_plain(mesh, rank, RIGL, k=2),
            "ms-ssim": _mesh_vs_plain(mesh, rank, None, loss="ms-ssim"),
            "jax_2d": _parity(mesh, "siren", init)}


@pytest.fixture(scope="module")
def jax_inits():
    import jax

    from implicit_image_tpu.models import build_model as jbuild

    out = {}
    for name, ((model, arch), _, _, _) in PARITY.items():
        jm, jc = jbuild(model, **arch)
        out[name] = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jc))
    return out


@pytest.fixture(scope="module")
def image2(jax_inits, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("image2")
    return run_group(_image2, 2, (jax_inits, str(tmp)), device="cpu", workdir=str(tmp)), tmp


@pytest.fixture(scope="module")
def image2_pixel2(jax_inits, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("image2_pixel2")
    return run_group(_image2_pixel2, 4, (jax_inits["siren"],), device="cpu", workdir=str(tmp))


def _equal(a, b, what=""):
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
    plain = results[0][key]["plain"]
    for rank, r in enumerate(results):
        _equal(r[key]["mesh"], plain, f"rank {rank} {key}")


def _jax_batched(name, init, mesh_shape, spec):
    """The JAX package's vmapped fit of PARITY[name] from `init` on a
    (image, pixel) mesh, its batch and images laid out as `spec`."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from implicit_image_tpu.data import get_grid as jgrid
    from implicit_image_tpu.models import build_model as jbuild
    from implicit_image_tpu.parallel import make_mesh as jmesh
    from implicit_image_tpu.training.fit import OptimConfig as JOptim
    from implicit_image_tpu.training.fit import TrainConfig as JTrain
    from implicit_image_tpu.training.fit import make_fit_fn

    (model, arch), b, steps, lr = PARITY[name]
    jm, jc = jbuild(model, **arch)
    mesh = jmesh(*mesh_shape)
    fn = jax.jit(jax.vmap(make_fit_fn(jm, jc, jgrid(16, 16),
                                      JTrain(num_steps=steps, log_steps=10,
                                             matmul_precision="float32"),
                                      JOptim(lr=lr), init_params=init)),
                 in_shardings=(NamedSharding(mesh, P("image")), NamedSharding(mesh, P(*spec))))
    params, _, _, metrics = fn(jax.random.split(jax.random.PRNGKey(0), b), _imgs(b))
    return jax.tree.map(np.asarray, params), np.asarray(metrics["psnr"]), np.asarray(
        metrics["loss"])


def _close_to_jax(ours, jparams, jpsnr):
    logged = ~np.isnan(jpsnr)
    np.testing.assert_array_equal(logged, ~np.isnan(ours["psnr"]))
    np.testing.assert_allclose(ours["psnr"][logged], jpsnr[logged], atol=0.05)
    for a, b in zip(ours["params"], jparams):
        for k in a:
            for i in range(len(b[k])):
                ref = b[k][i]
                assert np.abs(a[k][i].numpy() - ref).max() <= 1e-3 * np.abs(ref).max(), (k, i)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_batched_fit_on_image_mesh(image2, jax_inits, name):
    """The JAX package's test_batched_fit_on_image_mesh and the batched
    halves of test_coordx_batched_and_sharded and
    test_hashgrid_batched_and_sharded: the port's batched_fit over 2 image
    ranks against JAX's over a 2-device image mesh, from one init; every
    rank returns every member."""
    results, _ = image2
    for r in results[1:]:
        _equal(r[name], results[0][name], name)
    b = PARITY[name][1]
    assert results[0][name]["loss"].shape[0] == b
    jparams, jpsnr, jloss = _jax_batched(name, jax_inits[name], (2, 1), ("image",))
    _close_to_jax(results[0][name], jparams, jpsnr)
    assert np.all(results[0][name]["loss"][:, -1] < results[0][name]["loss"][:, 0])


def test_mesh_batched_fit_is_the_plain_batched_fit(image2):
    """RigL over 4 images on a 2 x 1 mesh: params, masks, Adam's moments,
    losses and densities are the batched fit's without a mesh, bit for bit,
    on every rank."""
    _exact(image2[0], "rigl")


@pytest.mark.parametrize("key", ["k1", "k2"])
def test_2x2_mesh_batched_fit_is_the_chunked_batched_fit(image2_pixel2, key):
    """On a 2 x 2 mesh (members over image, rows over pixel) the RigL
    batched fit at pixel_chunks = k is the batched fit without a mesh at
    pixel_chunks = 2k, bit for bit, on every rank."""
    _exact(image2_pixel2, key)


def test_2x2_mesh_batched_ms_ssim_is_the_plain_batched_fit(image2_pixel2):
    """ms-ssim over the member axis with each member's rows over 2 pixel
    ranks (the whole image's loss on the gathered predictions): the batched
    fit without a mesh up to the order of the gradients' sum (PSNR within
    1e-4 dB, params within 1e-5 of each leaf's largest magnitude)."""
    plain = image2_pixel2[0]["ms-ssim"]["plain"]
    for r in image2_pixel2:
        ours = r["ms-ssim"]["mesh"]
        logged = ~np.isnan(plain["psnr"])
        np.testing.assert_allclose(ours["psnr"][logged], plain["psnr"][logged], atol=1e-4)
        for a, b in zip(ours["params"], plain["params"]):
            for k in a:
                assert float((a[k] - b[k]).abs().max()) <= 1e-5 * float(b[k].abs().max()), k


def test_2d_mesh_batched_and_sharded(image2_pixel2, jax_inits):
    """The JAX package's test_2d_mesh_batched_and_sharded: 4 images over
    the image ranks, each image's rows over the pixel ranks, against JAX's
    vmapped fit with the batch over "image" and the rows over "pixel", from
    one init; the loss falls for every image."""
    ours = image2_pixel2[0]["jax_2d"]
    for r in image2_pixel2[1:]:
        _equal(r["jax_2d"], ours)
    jparams, jpsnr, jloss = _jax_batched("siren", jax_inits["siren"], (2, 2),
                                         ("image", "pixel"))
    _close_to_jax(ours, jparams, jpsnr)
    assert ours["loss"].shape == jloss.shape == (4, 40)
    assert np.all(ours["loss"][:, -1] < ours["loss"][:, 0])


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("key,sub", [("compress", "batch"), ("ladder", "ladder")])
def test_mesh_pipeline_is_the_plain_pipeline(image2, key, sub):
    """The JAX package's test_full_pipeline_image_batched and the mesh half
    of test_ladder_compress_end_to_end: each member's container decodes
    within 0.5 dB of its finetune's PSNR (the ladder's denser member is the
    larger), every rank returns every member, each image rank wrote its own
    members' containers, and they are the containers of the run without a
    mesh, byte for byte."""
    results, tmp = image2
    mesh, plain = results[0][key]["mesh"], results[0][key]["plain"]
    assert len(mesh) == 2
    for r in mesh:
        assert r.compressed_bytes > 0 and abs(r.decoded_psnr - r.quant_psnr) < 0.5
    if key == "ladder":
        assert mesh[1].compressed_bytes > mesh[0].compressed_bytes
    for r in results[1:]:
        _equal([x._replace(stream_dir="") for x in r[key]["mesh"]],
               [x._replace(stream_dir="") for x in mesh])
    for a, b in zip(mesh, plain):
        _equal(a._replace(stream_dir="", fit_wall_s=0.0), b._replace(stream_dir="",
                                                                     fit_wall_s=0.0))
    assert _digest(tmp / f"{sub}_mesh") == _digest(tmp / f"{sub}_plain")


def test_mesh_members_must_split_over_the_image_axis(image2):
    for r in image2[0]:
        assert r["indivisible"] == "3 members do not split over image axis 2"


def test_multihost_dryrun_four_processes_multi_fit():
    """The JAX package's dryrun case: 4 worker processes (gloo, file://
    rendezvous) pass a global collective and fit a fleet of 9 images split
    3/2/2/2; every process reports the same fleet PSNRs, and each is its
    image's single fit with the fleet's generator for it."""
    from implicit_image_tpu_torch.parallel import member_generators
    from implicit_image_tpu_torch.training.fit import fit

    reports = launch_dryrun(num_processes=4, fleet_size=9, steps=20, timeout=120.0,
                            device="cpu")
    assert [r["images"] for r in reports] == [[0, 3], [3, 5], [5, 7], [7, 9]]
    for pid, r in enumerate(reports):
        assert (r["process_id"], r["process_count"], r["backend"]) == (pid, 4, "gloo")
        assert r["collective_ok"] and len(r["fleet_psnrs"]) == 9
        assert r["fleet_psnrs"] == reports[0]["fleet_psnrs"]
    mdef, mcfg = build_model("siren", depth=3, hidden_size=8)
    gens = member_generators(torch.Generator().manual_seed(0), 9)
    for i in (0, 4, 8):
        res = fit(gens[i], mdef, mcfg, get_grid(16, 16), synthetic_image(16, 16, seed=i),
                  TrainConfig(num_steps=20, log_steps=20), OptimConfig(lr=1e-3), device="cpu")
        assert reports[0]["fleet_psnrs"][i] == float(np.float32(res.metrics["psnr"][-1]))


def test_multihost_dead_worker_fails_fast():
    """A worker that dies right after joining the group leaves its peers
    blocked in the collective: the supervisor sees the exit, kills them and
    raises naming it, long before its 120 s limit."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"worker\(s\) \[1\] exited \[17\]"):
        launch_dryrun(num_processes=3, fleet_size=3, steps=20, timeout=120.0, die_process=1,
                      device="cpu")
    assert time.monotonic() - t0 < 60.0


def _fails(rank):
    if rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    import torch.distributed as dist

    dist.barrier()


def test_run_group_raises_a_workers_error(tmp_path):
    """A rank that raises tears the group down: RuntimeError carrying its
    traceback, the other rank killed in its collective."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_group(_fails, 2, device="cpu", workdir=str(tmp_path), timeout=60.0)
    assert time.monotonic() - t0 < 50.0


def test_entry_points_refuse_a_missing_card():
    """device="cuda" without a CUDA device raises before joining any group:
    nothing falls back to the CPU."""
    import torch.distributed as dist

    from implicit_image_tpu_torch.parallel.multihost import init_multihost

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_multihost("file:///nonexistent", 1, 0, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_dryrun(num_processes=1, device="cuda")
    assert not dist.is_initialized()
