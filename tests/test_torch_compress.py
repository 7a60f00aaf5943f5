"""Port parity: the slice end to end. Both packages' compress.main run from
one numpy meta-init on the same synthetic image, dense and under RigL from
one saved mask; their containers are the same size, their decoded PSNRs
(and MS-SSIMs) agree, and each decoder reads the other's run dir."""
import json

import jax
import numpy as np
import pytest
import torch

from implicit_image_tpu import compress as jcompress
from implicit_image_tpu import decompress as jdecompress
from implicit_image_tpu.config import compose
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training.metainit import save_meta_init
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch import decompress as tdecompress
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.training.metainit import load_meta_init

torch.set_num_threads(1)

OVERRIDES = [
    "img=synthetic", "img.height=32", "img.width=32", "mlp.depth=4",
    "mlp.hidden_size=16", "masking=none", "train.num_steps=40", "train.log_steps=20",
    "quant.num_steps=10", "entropy_coding=plain",
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    mdef, mcfg = jbuild("siren", depth=4, hidden_size=16)
    init = root / "init.npz"
    save_meta_init(init, mdef.init(jax.random.PRNGKey(7), mcfg), "siren", mcfg)
    ov = OVERRIDES + [f"train.init_path={init}"]
    jres = jcompress.main(compose(ov), run_dir=str(root / "jax"))
    tres = tcompress.main(compose(ov + ["device=cpu"]), run_dir=str(root / "torch"))
    return root, init, jres, tres


def test_slice_matches_jax(runs):
    root, _, (jpsnr, jbytes), (tpsnr, tbytes) = runs
    assert tbytes == jbytes
    assert abs(tpsnr - jpsnr) <= 0.1, (tpsnr, jpsnr)
    tsum = json.loads((root / "torch" / "summary.json").read_text())
    jsum = json.loads((root / "jax" / "summary.json").read_text())
    assert tsum["Compressed Bytes"] == jsum["Compressed Bytes"]
    tmeta = (root / "torch" / "model_quantized" / "meta_data.json").read_text()
    assert tmeta == (root / "jax" / "model_quantized" / "meta_data.json").read_text()
    for key in ("fit_wall_s", "quant_wall_s", "encode_wall_s", "decode_wall_s"):
        assert tsum[key] >= 0.0
    lines = [json.loads(x) for x in (root / "torch" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if x["prefix"] == "Train"] == [20, 40]


def test_jax_decoder_reads_port_run_dir(runs):
    root, _, _, (tpsnr, _) = runs
    jdecompress.cli([str(root / "torch"), "--out", str(root / "cli.png")])
    assert (root / "cli.png").is_file()
    img, _ = jdecompress.decode_run(root / "torch", out_path=root / "j_dec.png")
    ours, _ = tdecompress.decode_run(root / "torch", out_path=root / "t_dec.png",
                                     device="cpu")
    assert img.shape == ours.shape == (32, 32, 3)
    np.testing.assert_allclose(np.asarray(img), ours, atol=1e-4)


def test_port_decoder_reads_jax_run_dir(runs):
    root, _, (jpsnr, _), _ = runs
    img, stats = tdecompress.decode_run(root / "jax", out_path=root / "jt.png", device="cpu")
    target = tcompress._load_image(compose(OVERRIDES).img)
    psnr = 10 * np.log10(1.0 / np.mean((img.astype(np.float64) - target) ** 2))
    assert psnr == pytest.approx(jpsnr, abs=1e-3)
    assert stats["render_s"] >= 0.0


def test_meta_init_loads_same_weights(runs):
    _, init, _, _ = runs
    m, c = build_model("siren", depth=4, hidden_size=16)
    params = load_meta_init(init, expect_model="siren", expect_mcfg=c)
    data = np.load(init)
    for i, layer in enumerate(params):
        for k, v in layer.items():
            np.testing.assert_array_equal(v.numpy(), data[f"params.{i}.{k}"])
    m8, c8 = build_model("siren", depth=4, hidden_size=8)
    with pytest.raises(ValueError):
        load_meta_init(init, expect_mcfg=c8)


@pytest.mark.parametrize("override", [
    ["quant.bit_alloc=auto"], ["optim=shampoo"], ["quant=qat"], ["entropy_coding.progressive=true"],
    ["profile=true"], ["+optim.preconditioner=ekfac"], ["quant=qat", "quant.qscheme=per_tensor"]])
def test_cli_options_run(tmp_path, override):
    """Bit allocation, Shampoo, QAT (per channel and per tensor), the
    progressive container, profile=True and the EKFAC preconditioner run
    through compress.main and write a container; the JAX decoder reads
    it to the weights the port decodes."""
    from implicit_image_tpu.coding import decompress_state_dict as jdecode
    from implicit_image_tpu_torch.coding import decompress_state_dict as tdecode

    cfg = compose(OVERRIDES + ["device=cpu", "train.num_steps=1"] + override)
    psnr, nbytes = tcompress.main(cfg, run_dir=str(tmp_path))
    assert np.isfinite(psnr) and nbytes > 0
    ours = tdecode(tmp_path / "model_quantized", "plain")
    theirs = jdecode(tmp_path / "model_quantized", "plain")
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
    if override[0] == "quant=qat":
        raw = json.loads((tmp_path / "model_quantized" / "meta_data.json").read_text())
        names = {v["name"] for k, v in raw.items() if k != "__meta__"}
        assert ("layers.1.qscale" in names) == (len(override) == 1)


@pytest.fixture(scope="module")
def sparse_runs(tmp_path_factory):
    """RigL from one saved mask (lottery-ticket) and one meta-init, updates
    every 10 steps up to step 30, in both packages."""
    root = tmp_path_factory.mktemp("sparse")
    mdef, mcfg = jbuild("siren", depth=4, hidden_size=16)
    init = root / "init.npz"
    save_meta_init(init, mdef.init(jax.random.PRNGKey(8), mcfg), "siren", mcfg)
    rng = np.random.default_rng(8)
    np.savez(root / "mask.npz", **{
        f"layers.{i}.mask": (rng.uniform(size=dims) < 0.5).astype(np.float32)
        for i, dims in enumerate(mcfg.layer_dims)})
    ov = [o for o in OVERRIDES if o != "masking=none"] + [
        "masking=RigL", "masking.sparse_init=lottery-ticket",
        f"masking.mask_path={root / 'mask.npz'}", "masking.interval=10",
        "masking.end_when=30", f"train.init_path={init}"]
    jres = jcompress.main(compose(ov), run_dir=str(root / "jax"))
    tres = tcompress.main(compose(ov + ["device=cpu"]), run_dir=str(root / "torch"))
    return root, ov, jres, tres


def test_rigl_slice_matches_jax(sparse_runs):
    root, _, (jpsnr, jbytes), (tpsnr, tbytes) = sparse_runs
    assert tbytes == jbytes
    assert abs(tpsnr - jpsnr) <= 0.1, (tpsnr, jpsnr)
    tsum = json.loads((root / "torch" / "summary.json").read_text())
    jsum = json.loads((root / "jax" / "summary.json").read_text())
    assert abs(tsum["Decoded MS-SSIM"] - jsum["Decoded MS-SSIM"]) <= 1e-3
    tmask, jmask = np.load(root / "torch" / "mask.npz"), np.load(root / "jax" / "mask.npz")
    assert sorted(tmask.files) == sorted(jmask.files)
    for name in tmask.files:
        assert tmask[name].sum() == jmask[name].sum()
    lines = [json.loads(x) for x in (root / "torch" / "metrics.jsonl").read_text().splitlines()]
    train = [x for x in lines if x["prefix"] == "Train"]
    assert [x["step"] for x in train] == [20, 40]
    assert all("Density" in x and "Prune Rate" in x for x in train)


def test_rigl_run_dirs_decode_across_packages(sparse_runs):
    root, ov, (jpsnr, _), (tpsnr, _) = sparse_runs
    target = tcompress._load_image(compose(ov).img)
    for run, want in (("jax", jpsnr), ("torch", tpsnr)):
        ours, _ = tdecompress.decode_run(root / run, out_path=root / f"{run}_t.png", device="cpu")
        theirs, _ = jdecompress.decode_run(root / run, out_path=root / f"{run}_j.png")
        np.testing.assert_allclose(np.asarray(theirs), ours, atol=1e-4)
        psnr = 10 * np.log10(1.0 / np.mean((ours.astype(np.float64) - target) ** 2))
        assert psnr == pytest.approx(want, abs=1e-3)
    # pruned weights are exactly 0 in the port's saved fit params
    model, mask = np.load(root / "torch" / "model.npz"), np.load(root / "torch" / "mask.npz")
    for name in mask.files:
        i = name.split(".")[1]
        assert np.all(model[f"layers.{i}.w"][mask[name] == 0] == 0.0)


@pytest.mark.parametrize("masking", ["SNFS", "Pruning", "Small_Dense"])
def test_other_masking_presets_run(tmp_path, masking):
    cfg = compose([o for o in OVERRIDES if o != "masking=none"]
                  + [f"masking={masking}", "train.num_steps=20", "train.log_steps=10",
                     "quant.num_steps=2", "device=cpu"])
    psnr, nbytes = tcompress.main(cfg, run_dir=str(tmp_path))
    assert np.isfinite(psnr) and nbytes > 0
    assert (tmp_path / "mask.npz").exists() == (masking != "Small_Dense")


# The reference's finals operating point for its harder images
# (scripts/finals.sh: SIREN w182, 9-bit k-means, zstd, 5x steps, RigL 0.5),
# cut to 16^2 pixels, depth 4 and 4 x 5 fit + 4 finetune steps; RigL starts
# from one saved mask and both fits from one meta-init.
FINALS = ["mlp.hidden_size=182", "quant.bits=9", "entropy_coding=zstd", "train.multiplier=5",
          "masking=RigL", "masking.density=0.5"]


@pytest.fixture(scope="module")
def finals_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("finals")
    mdef, mcfg = jbuild("siren", depth=4, hidden_size=182)
    init = root / "init.npz"
    save_meta_init(init, mdef.init(jax.random.PRNGKey(9), mcfg), "siren", mcfg)
    rng = np.random.default_rng(9)
    np.savez(root / "mask.npz", **{
        f"layers.{i}.mask": (rng.uniform(size=dims) < 0.5).astype(np.float32)
        for i, dims in enumerate(mcfg.layer_dims)})
    ov = ["img=synthetic", "img.height=16", "img.width=16", "mlp.depth=4"] + FINALS + [
        "train.num_steps=4", "train.log_steps=20", "quant.num_steps=4",
        "masking.sparse_init=lottery-ticket", f"masking.mask_path={root / 'mask.npz'}",
        "masking.interval=2", "masking.end_when=4", f"train.init_path={init}"]
    jres = jcompress.main(compose(ov), run_dir=str(root / "jax"))
    tres = tcompress.main(compose(ov + ["device=cpu"]), run_dir=str(root / "torch"))
    return root, ov, jres, tres


def test_finals_slice_matches_jax(finals_runs):
    """Both packages write the same manifest (9-bit labels as uint16) and
    decode within 0.1 dB. The zstd containers differ in size: the fits'
    floats differ in their last bits, and the 511-centroid f32 k-means
    gives a few weights lying between two centroids the other label (0.48%
    and 0.13% of the two quantized layers here); the gap is 73 of ~53,500
    bytes, bounded at 0.5%."""
    from implicit_image_tpu_torch.coding import read_raw_container

    root, _, (jpsnr, jbytes), (tpsnr, tbytes) = finals_runs
    assert abs(tpsnr - jpsnr) <= 0.1, (tpsnr, jpsnr)
    assert abs(tbytes - jbytes) <= 0.005 * jbytes, (tbytes, jbytes)
    tmeta = json.loads((root / "torch" / "model_quantized" / "meta_data.json").read_text())
    jmeta = json.loads((root / "jax" / "model_quantized" / "meta_data.json").read_text())
    assert tmeta == jmeta
    raw = {run: read_raw_container(root / run / "model_quantized", "zstd")
           for run in ("jax", "torch")}
    labeled = [k for k in raw["jax"] if k.endswith("labeled_weight")]
    assert len(labeled) == 2 and all(raw["jax"][k].dtype == np.uint16 for k in labeled)
    for k in labeled:
        assert raw["torch"][k].max() <= 511
        assert np.mean(raw["torch"][k] != raw["jax"][k]) <= 0.01, k
    lines = [json.loads(x) for x in (root / "torch" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if x["prefix"] == "Train"] == [20]


def test_finals_run_dirs_decode_across_packages(finals_runs):
    root, ov, (jpsnr, _), (tpsnr, _) = finals_runs
    target = tcompress._load_image(compose(ov).img)
    for run, want in (("jax", jpsnr), ("torch", tpsnr)):
        ours, _ = tdecompress.decode_run(root / run, out_path=root / f"{run}_t.png", device="cpu")
        theirs, _ = jdecompress.decode_run(root / run, out_path=root / f"{run}_j.png")
        np.testing.assert_allclose(np.asarray(theirs), ours, atol=1e-4)
        psnr = 10 * np.log10(1.0 / np.mean((ours.astype(np.float64) - target) ** 2))
        assert psnr == pytest.approx(want, abs=1e-3)


# The reference's other model families (scripts/run_studies_r5.sh): wavelet-
# SIREN dense and under RigL, Feathermap over SIREN, Fourier features; each
# at 32^2, d4/w16, 20 fit + 4 finetune steps, plain stream, from one meta-init
# written by the JAX package (RigL also from one saved mask).
FAMILIES = {
    "wavelet_siren": ["mlp=wavelet_siren", "masking=none"],
    "wavelet_rigl": ["mlp=wavelet_siren", "masking=RigL", "masking.density=0.25",
                     "masking.sparse_init=lottery-ticket", "masking.interval=5",
                     "masking.end_when=15"],
    "feathermap": ["masking=Feathermap", "masking.density=0.2"],
    "fourier": ["mlp=fourier", "mlp.map_size=16", "masking=none"],
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_runs(request, tmp_path_factory):
    from implicit_image_tpu.models import build_model_from_config as jbuild_cfg

    family = request.param
    root = tmp_path_factory.mktemp(family)
    ov = [o for o in OVERRIDES if o != "masking=none"] + FAMILIES[family] + [
        "train.num_steps=20", "quant.num_steps=4"]
    mdef, mcfg = jbuild_cfg(compose(ov))
    params = mdef.init(jax.random.PRNGKey(10), mcfg)
    save_meta_init(root / "init.npz", params, mdef.name, mcfg)
    ov.append(f"train.init_path={root / 'init.npz'}")
    if family == "wavelet_rigl":
        rng = np.random.default_rng(10)
        np.savez(root / "mask.npz", **{
            f"layers.{i}.mask": (rng.uniform(size=layer["w"].shape) < 0.25).astype(np.float32)
            for i, layer in enumerate(params)})
        ov.append(f"masking.mask_path={root / 'mask.npz'}")
    jres = jcompress.main(compose(ov), run_dir=str(root / "jax"))
    tres = tcompress.main(compose(ov + ["device=cpu"]), run_dir=str(root / "torch"))
    return family, root, ov, jres, tres


def test_family_slice_matches_jax(family_runs):
    """Equal container bytes and manifests, decoded PSNR within 0.1 dB; under
    RigL the same per-layer weight counts over both sub-SIRENs."""
    family, root, _, (jpsnr, jbytes), (tpsnr, tbytes) = family_runs
    assert tbytes == jbytes > 0
    assert abs(tpsnr - jpsnr) <= 0.1, (tpsnr, jpsnr)
    tmeta = (root / "torch" / "model_quantized" / "meta_data.json").read_text()
    assert tmeta == (root / "jax" / "model_quantized" / "meta_data.json").read_text()
    names = {v["name"] for k, v in json.loads(tmeta).items() if k != "__meta__"}
    if family == "feathermap":
        # V1 and V2 are the first and last weights: no codebook, as in JAX
        assert names == {"layers.0.weight", "layers.1.weight", "layers.2.bias"}
    if family == "fourier":
        assert "layers.0.B" in names and "layers.2.labeled_weight" in names
    if family == "wavelet_rigl":
        tmask, jmask = np.load(root / "torch" / "mask.npz"), np.load(root / "jax" / "mask.npz")
        assert sorted(tmask.files) == sorted(jmask.files) and len(tmask.files) == 8
        for name in tmask.files:
            assert tmask[name].sum() == jmask[name].sum(), name


def test_family_run_dirs_decode_across_packages(family_runs):
    _, root, ov, (jpsnr, _), (tpsnr, _) = family_runs
    target = tcompress._load_image(compose(ov).img)
    for run, want in (("jax", jpsnr), ("torch", tpsnr)):
        ours, _ = tdecompress.decode_run(root / run, out_path=root / f"{run}_t.png", device="cpu")
        theirs, _ = jdecompress.decode_run(root / run, out_path=root / f"{run}_j.png")
        np.testing.assert_allclose(np.asarray(theirs), ours, atol=1e-4)
        psnr = 10 * np.log10(1.0 / np.mean((ours.astype(np.float64) - target) ** 2))
        assert psnr == pytest.approx(want, abs=1e-3)
