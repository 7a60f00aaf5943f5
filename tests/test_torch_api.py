"""Port parity: the Python API (api.py). The JAX package's tests/test_api.py
cases on the port (device="cpu"); the package's lazy exports; a run dir
written by either package decodes in the other's decompress_image within
1e-4; compress_image of an array is compress.main on the same image; an
.iic from save() decodes to the run dir's image; and without device="cpu"
each entry point raises here."""
import json

import numpy as np
import pytest
import torch

import implicit_image_tpu as jiit
import implicit_image_tpu_torch as iit
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu_torch import api
from implicit_image_tpu_torch.compress import compose
from implicit_image_tpu_torch.compress import main as tmain

torch.set_num_threads(1)

FAST = [
    "mlp.depth=3", "mlp.hidden_size=16",
    "train.num_steps=30", "train.log_steps=30",
    "quant=kmeans", "quant.bits=4", "quant.num_steps=4", "quant.log_steps=4",
    "entropy_coding=zstd", "masking=none", "logging.use=false",
]
CPU = {"device": "cpu"}


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def test_package_exports_are_lazy():
    """The package exports the API by name, and importing it loads no API
    module (a fresh interpreter)."""
    import subprocess
    import sys

    assert iit.compress_image is api.compress_image
    assert iit.CompressedImage is api.CompressedImage
    code = ("import sys, implicit_image_tpu_torch\n"
            "assert 'implicit_image_tpu_torch.api' not in sys.modules\n"
            "assert 'implicit_image_tpu_torch.compress' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    with pytest.raises(AttributeError):
        iit.not_an_export  # noqa: B018


def test_compress_image_array_roundtrip(tmp_path):
    img = synthetic_image(24, 24, seed=0)
    res = iit.compress_image(img, overrides=FAST, out_dir=tmp_path / "run", **CPU)
    assert res.nbytes > 0 and np.isfinite(res.psnr)
    assert (res.run_dir / "model_quantized" / "compressed_weights.data").is_file()
    assert res.bitstream[:1]
    dec = res.decode()
    assert dec.shape == (24, 24, 3) and dec.dtype == np.float32
    # the returned PSNR is the decoded-from-container one the CLI reports
    assert abs(_psnr(dec, img) - res.psnr) < 0.05
    assert res.decode(scale=2.0).shape == (48, 48, 3)


def test_compress_image_path_input(tmp_path):
    from implicit_image_tpu_torch.data import save_img

    img = synthetic_image(20, 20, seed=1)
    src = tmp_path / "src.png"
    save_img(str(src), img)
    res = iit.compress_image(src, overrides=FAST + ["img.height=20", "img.width=20"],
                             out_dir=tmp_path / "run", **CPU)
    assert res.decode().shape == (20, 20, 3)


def test_compress_image_input_validation(tmp_path):
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        iit.compress_image(np.zeros((8, 8)), out_dir=tmp_path, **CPU)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        iit.compress_image(np.full((8, 8, 3), 2.0, np.float32), out_dir=tmp_path, **CPU)
    with pytest.raises(ValueError, match="entropy_coding"):
        iit.compress_image(synthetic_image(8, 8, seed=0), overrides=["entropy_coding=none"],
                           out_dir=tmp_path, **CPU)


def test_compress_image_nan_rejected(tmp_path):
    img = synthetic_image(8, 8, seed=0).copy()
    img[0, 0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        iit.compress_image(img, out_dir=tmp_path / "x", **CPU)


def test_compress_image_unique_default_dirs(tmp_path, monkeypatch):
    """Successive calls without out_dir do not overwrite each other."""
    monkeypatch.chdir(tmp_path)
    img = synthetic_image(12, 12, seed=0)
    r1 = iit.compress_image(img, overrides=FAST, **CPU)
    r2 = iit.compress_image(img, overrides=FAST, **CPU)
    assert r1.run_dir != r2.run_dir
    assert r1.run_dir.exists() and r2.run_dir.exists()


def test_compress_image_output_dir_override_wins(tmp_path):
    img = synthetic_image(12, 12, seed=0)
    want = tmp_path / "explicit"
    res = iit.compress_image(img, overrides=FAST + [f"output_dir={want}"],
                             out_dir=tmp_path / "ignored", **CPU)
    assert res.run_dir == want and want.exists()
    assert not (tmp_path / "ignored").exists()


def test_compress_images_fleet(tmp_path):
    """B same-shape arrays -> one fit over the member axis -> B decodable
    run dirs, each decoding to its own image at its reported PSNR."""
    imgs = [synthetic_image(16, 16, seed=s) for s in (0, 1, 2)]
    res = iit.compress_images(imgs, overrides=FAST, out_dir=tmp_path / "fleet",
                              names=["a", "b", "c"], **CPU)
    assert [r.run_dir.name for r in res] == ["a", "b", "c"]
    for r, src in zip(res, imgs):
        dec = r.decode()
        assert dec.shape == (16, 16, 3)
        assert abs(_psnr(dec, src) - r.psnr) < 0.05


def test_compress_images_validation(tmp_path):
    ok = synthetic_image(16, 16, seed=0)
    with pytest.raises(ValueError, match="share one shape"):
        iit.compress_images([ok, synthetic_image(8, 8, seed=0)], out_dir=tmp_path, **CPU)
    with pytest.raises(ValueError, match="at least one"):
        iit.compress_images([], out_dir=tmp_path, **CPU)
    with pytest.raises(ValueError, match="unique"):
        iit.compress_images([ok, ok], names=["x", "x"], out_dir=tmp_path, **CPU)
    with pytest.raises(ValueError, match="2 names"):
        iit.compress_images([ok], names=["x", "y"], out_dir=tmp_path, **CPU)


def test_array_input_is_compress_main_on_the_image(tmp_path):
    """compress_image of the synthetic stand-in passed as an array gives
    compress.main's bytes and decoded PSNR on img=synthetic, exactly."""
    cfg = compose(["seed=0", "img=synthetic", "img.height=16", "img.width=16", "device=cpu"]
                  + FAST)
    from implicit_image_tpu_torch.compress import _load_image

    img = _load_image(cfg.img)
    ref = tmain(cfg, run_dir=str(tmp_path / "main"))
    res = iit.compress_image(img, overrides=FAST, out_dir=tmp_path / "api", **CPU)
    assert (res.psnr, res.nbytes) == ref
    assert res.bitstream == (tmp_path / "main" / "model_quantized"
                             / "compressed_weights.data").read_bytes()


def test_save_writes_an_iic_that_decodes(tmp_path):
    img = synthetic_image(16, 16, seed=2)
    res = iit.compress_image(img, overrides=FAST, out_dir=tmp_path / "run", **CPU)
    packed = res.save(tmp_path / "one.iic")
    assert packed.suffix == ".iic" and packed.is_file()
    np.testing.assert_array_equal(iit.decompress_image(packed, device="cpu"), res.decode())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_run_dirs_decode_across_packages(tmp_path, writer):
    """A run dir written by either package's compress_image decodes in the
    other's decompress_image within 1e-4 of its own decoder's image."""
    img = synthetic_image(16, 16, seed=3)
    if writer == "jax":
        run = jiit.compress_image(img, overrides=FAST, out_dir=tmp_path / "run").run_dir
    else:
        run = iit.compress_image(img, overrides=FAST, out_dir=tmp_path / "run", **CPU).run_dir
    theirs = jiit.decompress_image(run)
    ours = iit.decompress_image(run, device="cpu")
    assert ours.shape == theirs.shape == (16, 16, 3)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)
    assert json.loads((run / "config.json").read_text())["img"]["height"] == 16


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = synthetic_image(8, 8, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iit.compress_image(img, overrides=FAST, out_dir=tmp_path / "a")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iit.compress_images([img], overrides=FAST, out_dir=tmp_path / "b")
    run = iit.compress_image(img, overrides=FAST, out_dir=tmp_path / "c", **CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iit.decompress_image(run.run_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.CompressedImage(run.psnr, run.nbytes, run.run_dir).decode()
