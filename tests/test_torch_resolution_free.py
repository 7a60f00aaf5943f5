"""Port parity: resolution-free and batched decode (data.get_grid_window,
coding.render_region, decompress.decode_run's geometry, decompress.decode_runs
and the member-axis K1's wrappers).

Tolerances: the window grid equals the slice of the full grid exactly, in
both packages; render_region within 1e-5 (absolute) of the JAX package's on
the same params (scale 1.5, a window, row bands); the port's window and
bands equal the slice of its own full render exactly; decode_runs within
1e-5 of the JAX package's over three run dirs in two groups, and each of
its images exactly its single decode_run. On the CPU the batched wrapper
runs its plain version (siren_chain_reference per member), which equals the
per-member chain exactly; the kernel's own bits are held on the card
(tests/test_torch_kernels.py, chip_smoke.py phase 3).
"""
import jax
import numpy as np
import pytest
import torch

from implicit_image_tpu import coding as jcoding
from implicit_image_tpu import decompress as jdecompress
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import get_grid_window as jwindow
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu_torch import coding as tcoding
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch import decompress as tdecompress
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid, get_grid_window
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import sine_mlp as sm

torch.set_num_threads(1)

WINDOWS = [(0, 37, 0, 23), (5, 12, 0, 23), (0, 1, 7, 8), (36, 37, 22, 23), (10, 30, 3, 20)]


@pytest.mark.parametrize("roi", WINDOWS)
def test_grid_window_is_the_slice_and_jax_floats(roi):
    win = get_grid_window(37, 23, *roi)
    r0, r1, c0, c1 = roi
    assert torch.equal(win, get_grid(37, 23)[r0:r1, c0:c1])
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwindow(37, 23, *roi)))


def test_grid_window_rejects_out_of_bounds():
    for bad in [(-1, 5, 0, 5), (0, 11, 0, 5), (3, 3, 0, 5), (0, 5, 2, 1)]:
        with pytest.raises(ValueError):
            get_grid_window(10, 5, *bad)


FAMILIES = [
    ("siren", dict(depth=3, hidden_size=16)),
    ("fourier", dict(depth=3, hidden_size=16)),
    ("coordx", dict(depth=4, hidden_size=16, split_depth=2)),
    ("hashgrid", dict(n_levels=4, log2_table_size=6, features=2, base_resolution=4,
                      finest_resolution=24, hidden_size=8, depth=2)),
]


def _models(name, kw, seed=3):
    jmdef, jmcfg = jbuild(name, **kw)
    jparams = jmdef.init(jax.random.PRNGKey(seed), jmcfg)
    mdef, mcfg = build_model(name, **kw)
    params = params_from_jax([{k: np.asarray(v) for k, v in layer.items()}
                              for layer in jparams], "cpu")
    return (jmdef, jmcfg, jparams), (mdef, mcfg, params)


@pytest.mark.parametrize("name,kw", FAMILIES)
def test_roi_render_is_the_full_render_slice(name, kw):
    _, (mdef, mcfg, params) = _models(name, kw)
    full = tcoding.render_region(mdef, mcfg, params, 24, 18)
    roi = (4, 15, 2, 11)
    win = tcoding.render_region(mdef, mcfg, params, 24, 18, roi=roi)
    np.testing.assert_array_equal(win, full[4:15, 2:11])


@pytest.mark.parametrize("name,kw", [FAMILIES[0], FAMILIES[2]])
def test_bands_are_the_full_render(name, kw):
    _, (mdef, mcfg, params) = _models(name, kw, seed=1)
    untiled = tcoding.render_region(mdef, mcfg, params, 25, 16)
    tiled = tcoding.render_region(mdef, mcfg, params, 25, 16, tile_rows=7)
    assert tiled.shape == (25, 16, 3)
    np.testing.assert_array_equal(tiled, untiled)
    roi = (3, 22, 5, 13)
    t = tcoding.render_region(mdef, mcfg, params, 25, 16, roi=roi, tile_rows=4)
    np.testing.assert_array_equal(t, untiled[3:22, 5:13])


@pytest.mark.parametrize("name,kw", FAMILIES)
@pytest.mark.parametrize("geometry", [
    dict(height=36, width=27),                     # scale 1.5 of 24 x 18
    dict(height=24, width=18, roi=(4, 15, 2, 11)),
    dict(height=36, width=27, roi=(3, 30, 1, 20), tile_rows=5),
])
def test_render_region_matches_jax(name, kw, geometry):
    (jmdef, jmcfg, jparams), (mdef, mcfg, params) = _models(name, kw)
    theirs = jcoding.render_region(jmdef, jmcfg, jparams, **geometry)
    ours = tcoding.render_region(mdef, mcfg, params, **geometry)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-5)


def test_superres_render_is_the_denser_lattice():
    _, (mdef, mcfg, params) = _models("siren", dict(depth=3, hidden_size=16), seed=0)
    up = tcoding.render_region(mdef, mcfg, params, 32, 32)
    direct = mdef.apply(params, get_grid(32, 32), mcfg, "fp32").detach().numpy()
    np.testing.assert_array_equal(up, direct)


def test_wavelet_renders_its_fitted_lattice_only():
    kw = dict(height=16, width=16, depth=3, hidden_size=16)
    _, (mdef, mcfg, params) = _models("wavelet_siren", kw)
    assert tcoding.render_region(mdef, mcfg, params, 16, 16).shape == (16, 16, 3)
    with pytest.raises(AssertionError):
        tcoding.render_region(mdef, mcfg, params, 16, 16, roi=(0, 8, 0, 16))


# ---- the member-axis K1's wrappers on the CPU ----


def _members(m=3, depth=4, width=16, seed=0):
    mdef, mcfg = build_model("siren", depth=depth, hidden_size=width)
    gen = torch.Generator().manual_seed(seed)
    return mdef, mcfg, [mdef.init(gen, mcfg, "cpu") for _ in range(m)]


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_batched_plain_version_is_each_member(prec):
    mdef, mcfg, members = _members()
    x = torch.rand((50, 2), generator=torch.Generator().manual_seed(1)) * 2 - 1
    xs = torch.rand((3, 50, 2), generator=torch.Generator().manual_seed(2)) * 2 - 1
    shared = sm.siren_chain_reference_batched(members, x, mcfg, prec)
    per = sm.siren_chain_reference_batched(members, xs, mcfg, prec)
    assert shared.shape == per.shape == (3, 50, 3)
    for i, p in enumerate(members):
        assert torch.equal(shared[i], sm.siren_chain_reference(p, x, mcfg, prec))
        assert torch.equal(per[i], sm.siren_chain_reference(p, xs[i], mcfg, prec))
    grid = get_grid(7, 9)
    batched = mdef.apply_batched(members, grid, mcfg, prec)
    for i, p in enumerate(members):
        assert torch.equal(batched[i], mdef.apply(p, grid, mcfg, prec))


def test_batched_wrapper_refuses_what_it_cannot_launch():
    _, mcfg, members = _members()
    _, _, wider = _members(m=1, width=24)
    x = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="one shape"):
        sm.sine_mlp_fwd_batched(members + wider, x, mcfg, "fp32")
    with pytest.raises(ValueError, match="one shape"):
        sm.sine_mlp_fwd_batched(members + wider, x, mcfg, "fp32+mixed")
    # "+mixed" renders over the member axis too: each member its own chain
    coords = torch.rand((4, 2), generator=torch.Generator().manual_seed(3))
    mixed = sm.siren_apply_flat_batched_fused(sm.stack_members(members), coords, mcfg,
                                              "bf16+mixed")
    for i, p in enumerate(members):
        assert torch.equal(mixed[i], sm.siren_apply_flat_fused(p, coords, mcfg, "bf16+mixed"))
    with pytest.raises(ValueError, match="members"):
        sm.sine_mlp_fwd_batched(members, torch.zeros((2, 4, 2), device="meta"), mcfg, "fp32")


@pytest.mark.parametrize("batched", [False, True])
def test_row_guard_names_tile_rows(batched):
    """Above MAX_ROWS rows a launch raises before anything is built, naming
    --tile-rows (a meta tensor: no memory)."""
    _, mcfg, members = _members(m=2)
    assert sm.MAX_ROWS == 2**31 - 128
    x = torch.empty((sm.MAX_ROWS + 1, 2), device="meta")
    with pytest.raises(ValueError, match="--tile-rows"):
        if batched:
            sm.sine_mlp_fwd_batched(members, x, mcfg, "fp32")
        else:
            sm.sine_mlp_fwd(members[0], x, mcfg, "fp32")


# ---- through the run dirs and the CLIs ----


def _run(root, name, extra=()):
    rd = root / name
    tcompress.main(tcompress.compose(
        ["img=synthetic", "img.height=16", "img.width=16", "mlp.depth=3", "mlp.hidden_size=16",
         "masking=none", "train.num_steps=20", "train.log_steps=20", "quant.num_steps=2",
         "entropy_coding=zstd", "device=cpu", *extra]), run_dir=str(rd))
    return rd


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("rf")
    return [_run(root, "s0"), _run(root, "s1", ["seed=1"]),
            _run(root, "cx", ["mlp=coordx", "mlp.split_depth=2", "mlp.depth=4"])]


def test_decode_run_geometry_end_to_end(runs):
    rd = runs[0]
    full, _ = tdecompress.decode_run(rd, device="cpu")
    assert full.shape == (16, 16, 3)
    up, stats = tdecompress.decode_run(rd, device="cpu", scale=2)
    assert up.shape == (32, 32, 3) and stats["lattice"] == (32, 32)
    assert stats["mpix_per_s"] > 0
    sz, _ = tdecompress.decode_run(rd, device="cpu", size=(24, 12))
    assert sz.shape == (24, 12, 3)
    win, stats = tdecompress.decode_run(rd, device="cpu", roi=(2, 10, 4, 12))
    np.testing.assert_array_equal(win, full[2:10, 4:12])
    assert stats["window"] == (2, 10, 4, 12)
    tiled, _ = tdecompress.decode_run(rd, device="cpu", scale=2, tile_rows=5)
    np.testing.assert_array_equal(tiled, up)
    theirs, _ = jdecompress.decode_run(rd, out_path=rd / "j.png", scale=2, roi=(3, 29, 1, 30),
                                       tile_rows=6)
    ours, _ = tdecompress.decode_run(rd, device="cpu", scale=2, roi=(3, 29, 1, 30), tile_rows=6)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-5)


def test_cli_geometry_flags(runs, tmp_path):
    rd = runs[0]
    out = tmp_path / "roi.png"
    tdecompress.cli([str(rd), "--roi", "2:10,4:12", "--scale", "2", "--out", str(out),
                     "--device", "cpu"])
    from PIL import Image

    assert np.asarray(Image.open(out)).shape[:2] == (8, 8)
    with pytest.raises(SystemExit):
        tdecompress.cli([str(rd), str(rd), "--scale", "2"])


def test_decode_runs_matches_jax_and_single_decodes(runs):
    ours = tdecompress.decode_runs(runs, device="cpu")
    theirs = jdecompress.decode_runs(runs)
    assert len(ours) == len(theirs) == 3
    for rd, a, b in zip(runs, ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
        single, _ = tdecompress.decode_run(rd, out_path=rd / "single.png", device="cpu")
        np.testing.assert_array_equal(a, single)
    assert not np.array_equal(ours[0], ours[1])  # two fits, two images


def test_decode_runs_cli(runs):
    for rd in runs:
        (rd / "decoded.png").unlink(missing_ok=True)
    tdecompress.cli([str(rd) for rd in runs] + ["--device", "cpu"])
    assert all((rd / "decoded.png").is_file() for rd in runs)
