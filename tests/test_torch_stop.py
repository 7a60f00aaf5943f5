"""Port parity: encode-to-quality early stop (train.stop_at_psnr).

The port keeps the JAX package's boundary cadence (train.segment_steps, or
its auto formula, copied as compress.auto_segment_steps) and checks the
PSNR there; the stop step must equal JAX's on the same problem. The check
runs at the precision JAX's eval_psnr uses (one bf16 pass; JAX on the CPU
computes fp32), so the stop PSNRs agree within 0.1 dB and the targets here
sit between two boundaries' readings, not on one.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import compress as jcompress
from implicit_image_tpu.config import compose as jcompose
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import fit as jfit
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)

IMG = np.asarray(synthetic_image(24, 24, seed=1, complexity=3))
LR = 2e-3


def _port_fit(n, init=None, **kw):
    m, c = build_model("siren", depth=3, hidden_size=16)
    return fit(torch.Generator().manual_seed(0), m, c, get_grid(24, 24), IMG,
               TrainConfig(num_steps=n, log_steps=10, segment_steps=10), OptimConfig(lr=LR),
               init_params=None if init is None else params_from_jax(init, "cpu"),
               device="cpu", **kw)


def test_stop_triggers_and_prefix_is_bit_identical():
    res = _port_fit(40, stop_psnr=1.0)
    assert res.stopped_at == 10 and res.stop_psnr_db >= 1.0
    assert len(res.metrics["loss"]) == 10 and len(res.metrics["psnr"]) == 10
    full = _port_fit(10)
    for la, lb in zip(res.params, full.params):
        for k in la:
            assert torch.equal(la[k], lb[k])


def test_no_stop_below_threshold_runs_full_budget():
    res = _port_fit(20, stop_psnr=200.0)
    assert res.stopped_at is None and res.stop_psnr_db is None
    assert len(res.metrics["loss"]) == 20


def test_stop_step_matches_jax():
    """From one init: JAX's unstopped fit reads the PSNR at each boundary
    (its in-loop eval there, fp32 on the CPU, is what its check reads); a
    target halfway between the 3rd and 4th readings stops both packages at
    step 40."""
    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jc))
    tc = JTrain(num_steps=80, log_steps=10, segment_steps=10, matmul_precision="tensorfloat32")
    run = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(24, 24), jnp.asarray(IMG), tc, JOptim(lr=LR),
               init_params=jax.tree.map(jnp.asarray, init))
    readings = np.asarray(run.metrics["psnr"])[9::10]
    assert readings[3] - readings[2] > 0.2  # room for the bf16 check
    target = float((readings[2] + readings[3]) / 2)
    jres = jfit(jax.random.PRNGKey(0), jm, jc, jgrid(24, 24), jnp.asarray(IMG), tc, JOptim(lr=LR),
                init_params=jax.tree.map(jnp.asarray, init), stop_psnr=target)
    tres = _port_fit(80, init=init, stop_psnr=target)
    assert jres.stopped_at == tres.stopped_at == 40
    assert abs(tres.stop_psnr_db - jres.stop_psnr_db) <= 0.1
    assert len(tres.metrics["psnr"]) == len(np.asarray(jres.metrics["psnr"])) == 40


CLI = ["img=synthetic", "img.height=24", "img.width=24", "mlp.depth=3", "mlp.hidden_size=16",
       "train.num_steps=40", "train.log_steps=10", "train.segment_steps=10",
       "train.stop_at_psnr=1.0", "masking=none", "quant=none", "entropy_coding=plain"]


def test_cli_stop_at_psnr(tmp_path):
    psnr, nbytes = tcompress.main(compose(CLI + ["device=cpu"]), run_dir=str(tmp_path / "t"))
    jpsnr, jbytes = jcompress.main(jcompose(CLI), run_dir=str(tmp_path / "j"))
    assert np.isfinite(psnr) and psnr >= 1.0 and nbytes == jbytes
    lines = [json.loads(x) for x in (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()]
    jlines = [json.loads(x) for x in (tmp_path / "j" / "metrics.jsonl").read_text().splitlines()]
    assert [(x["step"], sorted(x)) for x in lines if x["prefix"] == "Train"] == \
        [(x["step"], sorted(x)) for x in jlines if x["prefix"] == "Train"]
    assert json.loads((tmp_path / "t" / "summary.json").read_text())["stopped_at"] == 10


@pytest.mark.parametrize("overrides", [
    [], ["mlp.hidden_size=512"], ["mlp.hidden_size=182", "img.height=1024", "img.width=1024"],
    ["mlp=hashgrid"], ["mlp=hashgrid", "mlp.n_levels=16", "img.height=1024"],
    ["train.segment_steps=25"], ["mlp=coordx", "mlp.hidden_size=96"]])
def test_auto_segment_steps_matches_jax(overrides):
    assert tcompress.auto_segment_steps(compose(overrides)) == \
        jcompress._auto_segment_steps(jcompose(overrides))
