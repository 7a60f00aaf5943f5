"""Port parity: the bench flagship recipe end to end, at a small size.

Both packages' compress.main run CoordX (depth 5, split 2, width 16) on the
32x32 synthetic image from one JAX-saved meta-init, under RigL at density
0.85 from one saved mask, with delta residual codebooks against that init,
the finetune on every 2nd row and `auto` coding. Decoded PSNRs within
0.1 dB, the same `auto` tag, container bytes within 1%, and each decoder
reads the other's run dir. The CLI and `init_path=auto` run too.
"""
import json

import jax
import numpy as np
import pytest
import torch

from implicit_image_tpu import compress as jcompress
from implicit_image_tpu import decompress as jdecompress
from implicit_image_tpu.coding.parsers import _AUTO_ORDER
from implicit_image_tpu.config import compose
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training.metainit import save_meta_init
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch import decompress as tdecompress

torch.set_num_threads(1)

ARCH = dict(depth=5, split_depth=2, hidden_size=16)
BASE = [
    "img=synthetic", "img.height=32", "img.width=32", "mlp=coordx", "mlp.depth=5",
    "mlp.split_depth=2", "mlp.hidden_size=16", "masking.density=0.85",
    "train.num_steps=40", "train.log_steps=20", "quant.delta=true", "quant.row_stride=2",
    "quant.num_steps=10", "entropy_coding=auto",
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("flagship")
    mdef, mcfg = jbuild("coordx", **ARCH)
    init = root / "init.npz"
    save_meta_init(init, mdef.init(jax.random.PRNGKey(11), mcfg), "coordx", mcfg,
                   matmul_precision="tensorfloat32")
    rng = np.random.default_rng(11)
    np.savez(root / "mask.npz", **{
        f"layers.{i}.mask": (rng.uniform(size=dims) < 0.85).astype(np.float32)
        for i, dims in enumerate(mcfg.layer_dims)})
    ov = BASE + ["masking.sparse_init=lottery-ticket", f"masking.mask_path={root / 'mask.npz'}",
                 "masking.interval=10", "masking.end_when=30", f"train.init_path={init}"]
    jres = jcompress.main(compose(ov), run_dir=str(root / "jax"))
    tres = tcompress.main(compose(ov + ["device=cpu"]), run_dir=str(root / "torch"))
    return root, ov, init, jres, tres


def _manifest(run_dir):
    return json.loads((run_dir / "model_quantized" / "meta_data.json").read_text())


def _tag(run_dir):
    return _AUTO_ORDER[(run_dir / "model_quantized" / "compressed_weights.data").read_bytes()[0]]


def test_flagship_slice_matches_jax(runs):
    root, _, init, (jpsnr, jbytes), (tpsnr, tbytes) = runs
    assert abs(tpsnr - jpsnr) <= 0.1, (tpsnr, jpsnr)
    assert abs(tbytes - jbytes) <= 0.01 * jbytes, (tbytes, jbytes)
    assert _tag(root / "torch") == _tag(root / "jax")
    tmeta, jmeta = _manifest(root / "torch"), _manifest(root / "jax")
    assert [v["name"] for k, v in sorted(tmeta.items()) if k != "__meta__"] == \
        [v["name"] for k, v in sorted(jmeta.items()) if k != "__meta__"]
    assert tmeta["__meta__"]["delta"] == jmeta["__meta__"]["delta"]
    delta = tmeta["__meta__"]["delta"]
    assert delta["artifact"] == str(init) and delta["layers"] == [1, 3, 4, 5]
    assert "layers.0.weight" in delta["xor"] and "layers.6.weight" in delta["xor"]
    tsum = json.loads((root / "torch" / "summary.json").read_text())
    jsum = json.loads((root / "jax" / "summary.json").read_text())
    assert abs(tsum["Decoded MS-SSIM"] - jsum["Decoded MS-SSIM"]) <= 1e-3
    assert tsum["Compressed Bytes"] == tbytes
    tmask, jmask = np.load(root / "torch" / "mask.npz"), np.load(root / "jax" / "mask.npz")
    for name in jmask.files:
        assert tmask[name].sum() == jmask[name].sum()


def test_flagship_run_dirs_decode_across_packages(runs):
    root, ov, _, (jpsnr, _), (tpsnr, _) = runs
    target = tcompress._load_image(compose(ov).img)
    for run, want in (("jax", jpsnr), ("torch", tpsnr)):
        ours, _ = tdecompress.decode_run(root / run, out_path=root / f"{run}_t.png",
                                         device="cpu")
        theirs, _ = jdecompress.decode_run(root / run, out_path=root / f"{run}_j.png")
        np.testing.assert_allclose(np.asarray(theirs), ours, atol=1e-4)
        psnr = 10 * np.log10(1.0 / np.mean((ours.astype(np.float64) - target) ** 2))
        assert psnr == pytest.approx(want, abs=1e-3)


def test_decoder_delta_artifact_option(runs, tmp_path):
    """With the artifact moved away, the decoder finds it through
    --delta-artifact, and raises without it."""
    root, _, init, _, _ = runs
    moved = tmp_path / "moved.npz"
    moved.write_bytes(init.read_bytes())
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text((root / "torch" / "config.json").read_text())
    (run / "model_quantized").mkdir()
    meta = _manifest(root / "torch")
    meta["__meta__"]["delta"]["artifact"] = str(tmp_path / "gone" / "init.npz")
    (run / "model_quantized" / "meta_data.json").write_text(json.dumps(meta))
    (run / "model_quantized" / "compressed_weights.data").write_bytes(
        (root / "torch" / "model_quantized" / "compressed_weights.data").read_bytes())
    with pytest.raises(FileNotFoundError):
        tdecompress.decode_run(run, out_path=tmp_path / "x.png", device="cpu")
    tdecompress.cli([str(run), "--out", str(tmp_path / "cli.png"),
                     "--delta-artifact", str(moved), "--device", "cpu"])
    ours, _ = tdecompress.decode_run(run, out_path=tmp_path / "y.png", device="cpu",
                                     delta_artifact=moved)
    ref, _ = tdecompress.decode_run(root / "torch", out_path=tmp_path / "z.png", device="cpu")
    np.testing.assert_array_equal(ours, ref)
    assert (tmp_path / "cli.png").is_file()


def test_cli_with_auto_init_decodes_in_jax(tmp_path, monkeypatch):
    """The flagship's overrides through the port's CLI (widths of the
    committed artifact, 16x16, 6 steps): init_path=auto picks
    coordx_s5w96_512_tf32.npz, the manifest carries its sha256, and the JAX
    decoder (its CLI too) reads the run dir."""
    import hashlib

    from implicit_image_tpu_torch.training.metainit import default_meta_dir

    art = default_meta_dir() / "coordx_s5w96_512_tf32.npz"
    monkeypatch.chdir(tmp_path)
    tcompress.cli([
        "mlp=coordx", "mlp.hidden_size=96", "mlp.split_depth=5", "masking.density=0.85",
        "train.num_steps=6", "train.log_steps=3", "train.init_path=auto", "quant.delta=true",
        "quant.row_stride=4", "quant.num_steps=2", "entropy_coding=auto", "img.height=16",
        "img.width=16", "device=cpu", f"output_dir={tmp_path / 'run'}"])
    delta = _manifest(tmp_path / "run")["__meta__"]["delta"]
    assert delta["artifact"] == str(art)
    assert delta["sha256"] == hashlib.sha256(art.read_bytes()).hexdigest()
    jdecompress.cli([str(tmp_path / "run"), "--out", str(tmp_path / "cli.png")])
    assert (tmp_path / "cli.png").is_file()
    img, _ = jdecompress.decode_run(tmp_path / "run", out_path=tmp_path / "j.png")
    ours, _ = tdecompress.decode_run(tmp_path / "run", out_path=tmp_path / "t.png", device="cpu")
    np.testing.assert_allclose(np.asarray(img), ours, atol=1e-4)
    summary = json.loads((tmp_path / "run" / "summary.json").read_text())
    assert summary["Compressed Bytes"] > 0 and np.isfinite(summary["Decoded PSNR"])


def test_delta_without_init_raises(tmp_path):
    cfg = compose(BASE + ["device=cpu", "train.num_steps=1"])
    with pytest.raises(ValueError, match="init_path"):
        tcompress.main(cfg, run_dir=str(tmp_path))
