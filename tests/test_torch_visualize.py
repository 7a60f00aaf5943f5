"""Port parity: the rate-distortion scoring of
implicit_image_tpu_torch.visualize against implicit_image_tpu.visualize
(MS-SSIM within 1e-5, PSNR ladders and run-store readers equal), and its
CLI in a process where importing JAX raises."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import implicit_image_tpu.visualize.jpeg_quality_curve as jjpeg
import implicit_image_tpu.visualize.rate_distortion as jrd
import implicit_image_tpu.visualize.runs as jruns
import implicit_image_tpu_torch.visualize.jpeg_quality_curve as tjpeg
import implicit_image_tpu_torch.visualize.rate_distortion as trd
import implicit_image_tpu_torch.visualize.runs as truns
from implicit_image_tpu_torch.data import stable_seed, synthetic_image

REPO = Path(__file__).resolve().parents[1]


def _pairs():
    rng = np.random.default_rng(0)
    a = synthetic_image(96, 80, seed=1)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    c = synthetic_image(48, 48, seed=2)
    return [(a, b), (a, a), (c, np.clip(c[::-1] * 0.9, 0, 1)), (b.astype(np.float64), a)]


@pytest.mark.parametrize("i", range(4))
def test_ms_ssim_matches_jax(i):
    """The port's _ms_ssim_np (ops/ssim.py on the host) equals the JAX
    package's within 1e-5, at as many scales as each image holds."""
    a, b = _pairs()[i]
    assert abs(trd._ms_ssim_np(a, b) - jrd._ms_ssim_np(a, b)) <= 1e-5


@pytest.mark.parametrize("ext,metric", [("jpg", "psnr"), ("webp", "psnr"), ("jpg", "ms_ssim")])
def test_codec_ladder_matches_jax(ext, metric):
    """The OpenCV ladder: the same kilobytes, the PSNRs equal and the
    MS-SSIMs within 1e-5."""
    img = synthetic_image(64, 64, seed=stable_seed("bridge"))
    ours = trd.traditional_rate_distortion(img, ext, metric=metric)
    theirs = jrd.traditional_rate_distortion(img, ext, metric=metric)
    assert len(ours) == len(theirs) == 20
    for (kb, v), (jkb, jv) in zip(ours, theirs):
        assert kb == jkb
        assert abs(v - jv) <= (0.0 if metric == "psnr" else 1e-5)


def _run_store(root: Path):
    for name, summary in {
        "synthetic/a": {"Compressed Bytes": 2048, "Decoded PSNR": 30.5,
                        "Decoded MS-SSIM": 0.97},
        "synthetic/b": {"Compressed Bytes": 1024, "Quant PSNR": 28.0},
        "flower/c": {"Compressed Bytes": 4096, "PSNR": 33.0, "Decoded MS-SSIM": 0.99},
        "synthetic/d": {"PSNR": 20.0},
    }.items():
        d = root / name
        d.mkdir(parents=True)
        (d / "summary.json").write_text(json.dumps(summary))
        (d / "metrics.jsonl").write_text(json.dumps({"step": 1, "PSNR": 1.0}) + "\n")
        (d / "config.json").write_text(json.dumps({"seed": 0}))


def test_run_store_readers_match_jax(tmp_path):
    _run_store(tmp_path)
    assert truns.collect_runs(tmp_path) == jruns.collect_runs(tmp_path)
    assert truns.load_run(tmp_path / "flower/c") == jruns.load_run(tmp_path / "flower/c")
    for img in (None, "synthetic"):
        for metric in ("psnr", "ms_ssim"):
            assert (trd.ours_rate_distortion(tmp_path, img, metric)
                    == jrd.ours_rate_distortion(tmp_path, img, metric))
    assert trd.ours_rate_distortion(tmp_path, "synthetic", "ms_ssim") == [(2.0, 0.97)]


def test_jpeg_quality_curve_matches_jax():
    img = synthetic_image(64, 48, seed=stable_seed("flower_foveon"))
    assert tjpeg.quality_curve(img) == jjpeg.quality_curve(img)


def test_rate_distortion_cli_runs_without_jax(tmp_path):
    """`python -m implicit_image_tpu_torch.visualize.rate_distortion
    metric=ms_ssim` in a process where importing jax (or the JAX package)
    raises: it scores the codecs' ladders and the run store and writes the
    plot."""
    _run_store(tmp_path / "runs")
    out = tmp_path / "rd.pdf"
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'implicit_image_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['rate_distortion', 'metric=ms_ssim', 'img=synthetic',\n"
        f"            'outputs_root={tmp_path / 'runs'}', 'out={out}']\n"
        "runpy.run_module('implicit_image_tpu_torch.visualize.rate_distortion',\n"
        "                 run_name='__main__')\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"wrote {out}" in res.stdout
    assert out.stat().st_size > 0


def test_missing_package_names_it(monkeypatch):
    """Without cv2 (the GPU machine has no OpenCV) the codec ladder raises
    ImportError naming it; the run store's scoring does not need it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="'cv2' package"):
        trd.traditional_rate_distortion(synthetic_image(16, 16), "jpg")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="'matplotlib' package"):
        trd.plot_rate_distortion(synthetic_image(16, 16))
