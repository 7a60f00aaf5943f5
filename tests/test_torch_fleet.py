"""Port parity: the fleet encode CLI (fleet.py). The JAX package's three
fleet tests on the port; with masking=none and one shared meta-init nothing
is drawn at random, so the two packages' fleets give the same `plain` bytes
and decoded PSNRs within 0.1 dB; a port member decodes in the JAX
package's decode_run to the port decoder's image; and without device=cpu
the CLI raises here."""
import json

import jax
import numpy as np
import pytest
import torch

from implicit_image_tpu import decompress as jdecompress
from implicit_image_tpu import fleet as jfleet
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training.metainit import save_meta_init
from implicit_image_tpu_torch import decompress as tdecompress
from implicit_image_tpu_torch import fleet as tfleet
from implicit_image_tpu_torch.compress import _load_image, compose

torch.set_num_threads(1)


def _overrides(tmp_path, extra=()):
    return [
        "img=synthetic", "img.height=24", "img.width=24",
        "mlp.depth=3", "mlp.hidden_size=16",
        "train.num_steps=6", "train.log_steps=6",
        "masking=RigL", "masking.density=0.5",
        "masking.interval=3", "masking.end_when=4",
        "quant=kmeans", "quant.num_steps=2", "quant.log_steps=2",
        "entropy_coding=plain",
        f"output_dir={tmp_path}", "exp_name=t",
        *extra,
    ]


def _meta(path):
    mdef, mcfg = jbuild("siren", depth=3, hidden_size=16, input_size=2, output_size=3)
    save_meta_init(path, mdef.init(jax.random.PRNGKey(0), mcfg), mdef.name, mcfg)
    return path


def test_fleet_writes_decodable_run_dirs(tmp_path):
    """The JAX package's test on the port: two members, each a run dir that
    decode_run reads to its summary's decoded PSNR."""
    out = tfleet.run(_overrides(tmp_path, ["device=cpu", "fleet.images=alpha,beta"]))
    assert [n for n, _, _ in out] == ["alpha", "beta"]
    for name, psnr, nbytes in out:
        assert np.isfinite(psnr) and nbytes > 0
        run_dir = tmp_path / "fleet_t" / name
        cfg = json.loads((run_dir / "config.json").read_text())
        assert cfg["img"]["name"] == name
        assert (run_dir / "model_quantized").is_dir()
        img, _ = tdecompress.decode_run(str(run_dir), device="cpu")
        assert img.shape == (24, 24, 3)
        target = _load_image(compose(["img=synthetic", "img.height=24", "img.width=24",
                                      f"img.name={name}"]).img)
        mse = float(np.mean((np.asarray(img, np.float64) - target) ** 2))
        summary = json.loads((run_dir / "summary.json").read_text())
        assert abs(10 * np.log10(1 / mse) - summary["Decoded PSNR"]) < 1e-3
        assert summary["members"] == 2 and summary["fit_wall_s"] >= 0.0
    # the two members are different images -> different streams
    assert out[0][1] != out[1][1]


def test_fleet_requires_images(tmp_path):
    with pytest.raises(ValueError, match="fleet.images"):
        tfleet.run(_overrides(tmp_path, ["device=cpu"]))


def test_fleet_dense_and_warm_start(tmp_path):
    path = _meta(tmp_path / "meta.npz")
    out = tfleet.run(_overrides(tmp_path, [
        "device=cpu", "fleet.images=gamma", "masking=none", f"train.init_path={path}"]))
    assert len(out) == 1 and np.isfinite(out[0][1])


def test_dense_warm_fleet_matches_jax(tmp_path):
    """masking=none from one shared meta-init: nothing is random, so both
    packages' fleets (3 members, 24², d3 w16, 30 + 4 steps, k-means 8-bit,
    plain) give each member the same container bytes and decoded PSNRs
    within 0.1 dB; each port member decodes in JAX's decode_run within 1e-4
    of the port decoder's image."""
    path = _meta(tmp_path / "meta.npz")
    ov = ["img=synthetic", "img.height=24", "img.width=24", "mlp.depth=3", "mlp.hidden_size=16",
          "train.num_steps=30", "train.log_steps=10", "masking=none", "quant=kmeans",
          "quant.num_steps=4", "entropy_coding=plain", "exp_name=t",
          f"train.init_path={path}", "fleet.images=alpha,beta,gamma"]
    jout = jfleet.run(ov + [f"output_dir={tmp_path / 'jax'}"])
    tout = tfleet.run(ov + [f"output_dir={tmp_path / 'port'}", "device=cpu"])
    for (jn, jp, jb), (tn, tp, tb) in zip(jout, tout):
        assert tn == jn and tb == jb
        assert abs(tp - jp) <= 0.1, (tn, tp, jp)
    for name, _, _ in tout:
        run_dir = tmp_path / "port" / "fleet_t" / name
        theirs, _ = jdecompress.decode_run(run_dir, out_path=run_dir / "jax.png")
        ours, _ = tdecompress.decode_run(run_dir, out_path=run_dir / "port.png", device="cpu")
        np.testing.assert_allclose(np.asarray(theirs), ours, atol=1e-4)


def test_fleet_cli_raises_without_cuda(tmp_path):
    """Without device=cpu the fleet looks for the card: RuntimeError from
    run, and the CLI exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.run(_overrides(tmp_path, ["fleet.images=alpha"]))
    with pytest.raises(SystemExit) as err:
        tfleet.cli(_overrides(tmp_path, ["fleet.images=alpha"]))
    assert err.value.code == 1
