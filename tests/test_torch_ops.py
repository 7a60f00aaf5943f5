"""Port parity: imports, data, metrics and the polynomial sine.

The same float32 inputs, made with numpy, go through the JAX function and
its counterpart in implicit_image_tpu_torch.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import data as jdata
from implicit_image_tpu.ops import fast_math as jfm
from implicit_image_tpu.ops import metrics as jmetrics
from implicit_image_tpu_torch import data as tdata
from implicit_image_tpu_torch.ops import fast_math as tfm
from implicit_image_tpu_torch.ops import metrics as tmetrics
from implicit_image_tpu_torch.ops.sine_mlp import precision_from_config

torch.set_num_threads(1)


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke, import neither jax nor
    triton nor anything of the JAX package implicit_image_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import implicit_image_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 30, names\n"
        "assert {'implicit_image_tpu_torch.parallel.' + m for m in "
        "('batched', 'pipeline', 'ladder', 'mesh', 'sharded', 'multihost')} <= set(names), "
        "names\n"
        "assert {'implicit_image_tpu_torch.' + m for m in "
        "('fleet', 'target', 'sweep', 'api', 'meta_train', 'training.metainit', "
        "'sequence', 'visualize.rate_distortion', 'visualize.bd_rate', 'visualize.width_depth', "
        "'visualize.weight_removal', 'visualize.sequence_curve', 'utils.timer', "
        "'utils.catch_error')} "
        "<= set(names), names\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "def banned(m):\n"
        "    return any(m == r or m.startswith(r + '.') "
        "for r in ('jax', 'triton', 'implicit_image_tpu'))\n"
        "bad = sorted(m for m in sys.modules if banned(m))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("fn", ["fast_sin", "fast_cos"])
def test_fast_math_accuracy_and_bit_parity(fn):
    x = np.linspace(-40.0, 40.0, 10001, dtype=np.float32)
    ref = getattr(np, fn[len("fast_"):])(x.astype(np.float64))
    ours = getattr(tfm, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5)
    wide = np.random.default_rng(0).uniform(-60, 60, 20000).astype(np.float32)
    for arr in (x, wide):
        np.testing.assert_array_equal(
            getattr(tfm, fn)(torch.from_numpy(arr)).numpy(),
            np.asarray(getattr(jfm, fn)(jnp.asarray(arr))),
        )


@pytest.mark.parametrize("hw,seed", [((32, 48), 0), ((17, 5), 123)])
def test_synthetic_image_and_grid_bit_equal(hw, seed):
    np.testing.assert_array_equal(tdata.synthetic_image(*hw, seed=seed),
                                  jdata.synthetic_image(*hw, seed=seed))
    np.testing.assert_array_equal(tdata.get_grid(*hw).numpy(), np.asarray(jdata.get_grid(*hw)))


@pytest.mark.parametrize("name", ["flower", "synthetic", "ood_text"])
def test_stable_seed_equal(name):
    assert tdata.stable_seed(name) == jdata.stable_seed(name)


def test_load_img_matches(tmp_path):
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 65535, (21, 30, 3), dtype=np.uint16)
    path = tmp_path / "img.ppm"
    header = b"P6\n30 21\n65535\n"
    path.write_bytes(header + raw.astype(">u2").tobytes())
    for mode in ("centre-crop", "resize-crop"):
        kw = dict(height=16, width=16, bits=16, crop_mode=mode)
        np.testing.assert_allclose(tdata.load_img(str(path), **kw),
                                   jdata.load_img(str(path), **kw), atol=1e-6)


def test_metrics_match():
    rng = np.random.default_rng(2)
    target = rng.uniform(size=(20, 20, 3)).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.01, target.shape), 0, 1).astype(np.float32)
    for tf, jf in ((tmetrics.mse, jmetrics.mse), (tmetrics.psnr, jmetrics.psnr),
                   (tmetrics.psnr_8bit, jmetrics.psnr_8bit)):
        a = float(tf(torch.from_numpy(pred), torch.from_numpy(target)))
        b = float(jf(jnp.asarray(pred), jnp.asarray(target)))
        assert a == pytest.approx(b, rel=1e-5)


def test_psnr_8bit_truncates():
    # 0.999 * 255 = 254.7 truncates to 254, not 255
    pred = torch.full((4, 3), 0.999)
    target = torch.ones((4, 3))
    assert float(tmetrics.psnr_8bit(pred, target)) == pytest.approx(
        10 * np.log10(255.0**2 / 1.0))


@pytest.mark.parametrize("raw,mode", [("tensorfloat32", "fp32"), ("float32", "fp32"),
                                      ("bfloat16", "bf16"), (None, "bf16")])
def test_precision_mapping(raw, mode):
    assert precision_from_config(raw) == mode


def test_precision_mapping_rejects_unknown():
    with pytest.raises(ValueError):
        precision_from_config("tf32-ish")


@pytest.mark.parametrize("raw", ["fp32", "bf16", "highest", "default", ""])
def test_precision_mapping_takes_only_the_config_values(raw):
    with pytest.raises(ValueError):
        precision_from_config(raw)


def test_jax_stays_on_cpu():
    # the JAX reference of these tests runs on the CPU (tests/conftest.py)
    assert jax.default_backend() == "cpu"
