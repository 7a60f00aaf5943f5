"""Port parity: the per-layer bit allocation (quant.bit_alloc=auto,
quant/allocate.py).

One JAX fit (numpy-seeded image, JAX's own init) gives the params; both
packages' allocate_bits search them, the port in its fp32 mode (JAX on the
CPU computes every product in fp32). Tolerances: every probe's label rate
equal (the same k-means labels), every ΔD within 1e-5 of the probe's image
MSE (ΔD = probe MSE - unsnapped MSE; the port's MSE is a float64 mean, JAX's
an fp32 one), the joint MSEs within 1e-5 relative; the λ-hull allocations,
the chosen allocation and `chosen_uniform` equal. Then the JAX package's
own allocation tests, on the port.
"""
import json

import jax
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.quant import QuantConfig as JQuant
from implicit_image_tpu.quant.allocate import allocate_bits as j_allocate
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import fit as jfit
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.quant.allocate import _label_rate_bytes, allocate_bits

torch.set_num_threads(1)

SIDE, DEPTH, WIDTH = 32, 4, 32


@pytest.fixture(scope="module")
def fitted():
    img = synthetic_image(SIDE, SIDE, seed=3)
    mdef, mcfg = jbuild("siren", depth=DEPTH, hidden_size=WIDTH)
    res = jfit(jax.random.PRNGKey(0), mdef, mcfg, jgrid(SIDE, SIDE), img,
               JTrain(num_steps=120, log_steps=60), JOptim(lr=1e-3))
    params = [{k: np.asarray(v) for k, v in layer.items()} for layer in res.params]
    return img, params


def _both(img, params, jparams=None, **kw):
    jmdef, jmcfg = jbuild("siren", depth=DEPTH, hidden_size=WIDTH)
    jrep = j_allocate(jmdef, jmcfg, tuple(jparams or params), jgrid(SIDE, SIDE), img,
                      JQuant(bits=8), **kw)
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=WIDTH)
    trep = allocate_bits(mdef, mcfg, params_from_jax(params, "cpu"), get_grid(SIDE, SIDE),
                         img, QuantConfig(bits=8), precision="fp32", **kw)
    return jrep, trep


@pytest.mark.parametrize("candidates", [(5, 6, 7, 8, 9, 10), (4, 6, 8)])
def test_allocation_table_and_choice_match_jax(fitted, candidates):
    img, params = fitted
    jrep, trep = _both(img, params, candidates=candidates)
    assert sorted(trep.per_layer) == sorted(jrep.per_layer) == [1, 2]
    for i, jrow in jrep.per_layer.items():
        assert sorted(trep.per_layer[i]) == sorted(jrow)
        for b, (jdd, jrate) in jrow.items():
            tdd, trate = trep.per_layer[i][b]
            assert trate == pytest.approx(jrate, rel=1e-12), (i, b)
            assert abs(tdd - jdd) <= 1e-5 * (jrep.base_mse + jdd), (i, b, tdd, jdd)
    assert trep.base_mse == pytest.approx(jrep.base_mse, rel=1e-5)
    assert trep.mse == pytest.approx(jrep.mse, rel=1e-5)
    assert trep.base_rate == pytest.approx(jrep.base_rate, rel=1e-12)
    assert trep.rate == pytest.approx(jrep.rate, rel=1e-12)
    assert trep.bits_per_layer == tuple(jrep.bits_per_layer)
    assert trep.chosen_uniform == jrep.chosen_uniform
    assert trep.base_bits == jrep.base_bits == 8


def test_lambda_hull_allocations_match_jax(fitted):
    """The separable λ sweep over both tables gives the same hull."""
    img, params = fitted
    jrep, trep = _both(img, params)

    def hull(table):
        out = []
        for lam in np.logspace(-12, 0, 64):
            alloc = tuple(min(table[i], key=lambda b: table[i][b][0] + lam * table[i][b][1])
                          for i in sorted(table))
            if alloc not in out:
                out.append(alloc)
        return out

    assert hull(trep.per_layer) == hull(jrep.per_layer)
    assert len(hull(trep.per_layer)) >= 2


def test_insensitive_layer_parity_and_narrowing(fitted):
    """The JAX package's own case: a nearly transparent layer (weights x
    1e-4) must leave the uniform width, and the choice must dominate the
    baseline in the search's own terms — in both packages, identically."""
    img, params = fitted
    params = [dict(layer) for layer in params]
    params[2]["w"] = params[2]["w"] * np.float32(1e-4)
    jrep, trep = _both(img, params, candidates=(4, 5, 6, 7, 8))
    for rep in (jrep, trep):
        assert not rep.chosen_uniform
        assert rep.rate < rep.base_rate
        assert rep.mse <= rep.base_mse * (1.0 + 1e-9)
        assert rep.bits_per_layer[2] <= 6
        assert rep.bits_per_layer[0] is None and rep.bits_per_layer[-1] is None
    assert trep.bits_per_layer == tuple(jrep.bits_per_layer)


def test_label_rate_model():
    labels = np.array([0, 0, 1, 1, 2, 3, 3, 3], np.int32)
    p = np.array([2, 2, 1, 3]) / 8
    expect = 8 * float(-(p * np.log2(p)).sum()) / 8 + 2.0 * 4
    assert _label_rate_bytes(labels, 2) == pytest.approx(expect)


def test_cli_bit_alloc_auto(tmp_path):
    """quant.bit_alloc=auto through the port's compress.main (the JAX
    package's test_cli_bit_alloc_auto): the Bit Allocation key, both A/B
    containers, and the quant wall covering both finetunes."""
    cfg = tcompress.compose([
        "img=synthetic", "img.height=24", "img.width=24", "mlp.depth=4",
        "mlp.hidden_size=16", "train.num_steps=100", "train.log_steps=50",
        "quant.num_steps=10", "quant.bit_alloc=auto", "entropy_coding=zstd", "device=cpu",
    ])
    psnr, nbytes = tcompress.main(cfg, run_dir=str(tmp_path))
    assert np.isfinite(psnr) and nbytes > 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    alloc = summary["Bit Allocation"]
    assert len(alloc) == 4 and alloc[0] == -1 and alloc[-1] == -1
    assert all(2 <= b <= 16 for b in alloc[1:-1])
    assert (tmp_path / "bit_alloc_auto" / "compressed_weights.data").exists()
    assert (tmp_path / "bit_alloc_uniform" / "compressed_weights.data").exists()
    assert summary["bit_alloc_search_s"] >= 0.0
    assert 0.0 < summary["Decoded MS-SSIM"] <= 1.0
