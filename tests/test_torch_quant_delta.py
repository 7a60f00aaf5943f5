"""Port parity: delta quantization (quant.delta) and the row-stride
codebook finetune.

Delta k-means and ECVQ cluster the residual w - offset and keep label 0 for
pruned weights: labels and centroids equal JAX's in float64. The finetune
with offsets, masks and quant.row_stride=2 on a CoordX model gives JAX's
quant PSNR and the same reconstruction rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.quant import QuantConfig as JQuant
from implicit_image_tpu.quant.kmeans import ecvq_refine as j_ecvq
from implicit_image_tpu.quant.kmeans import quantize_weight as j_quantize
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.quant_phase import quant_finetune as j_finetune
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.quant.kmeans import ecvq_refine, quantize_weight
from implicit_image_tpu_torch.training.fit import OptimConfig
from implicit_image_tpu_torch.training.quant_phase import quant_finetune

torch.set_num_threads(1)


def _weight_and_offset(dtype, seed, shape=(48, 40), zeros=0.15):
    rng = np.random.default_rng(seed)
    offset = rng.normal(0, 0.05, shape)
    w = offset + rng.normal(0, 0.004, shape)
    w[rng.uniform(size=shape) < zeros] = 0.0
    return w.astype(dtype), offset.astype(dtype)


@pytest.mark.parametrize("bits,lam", [(4, 1.0), (8, 1.0), (6, 0.0)])
def test_delta_kmeans_and_ecvq_float64_identical(bits, lam):
    with jax.enable_x64(True):
        w, off = _weight_and_offset(np.float64, seed=bits)
        jsnap, jbook = j_quantize(jnp.asarray(w), bits, 5, offset=jnp.asarray(off))
        tsnap, tbook = quantize_weight(torch.from_numpy(w), bits, 5, offset=torch.from_numpy(off))
        books = [(jbook, tbook)]
        if lam > 0:
            books.append((j_ecvq(jnp.asarray(w), jbook, lam, 10, offset=jnp.asarray(off)),
                          ecvq_refine(torch.from_numpy(w), tbook, lam, 10,
                                      offset=torch.from_numpy(off))))
        for jb, tb in books:
            np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
            np.testing.assert_allclose(tb.centroids.numpy(), np.asarray(jb.centroids),
                                       rtol=0, atol=1e-12)
        np.testing.assert_allclose(tsnap.numpy(), np.asarray(jsnap), rtol=0, atol=1e-12)
    # label 0 marks exactly the pruned weights
    for _, tb in books:
        lab = tb.labels.numpy()
        np.testing.assert_array_equal(lab == 0, w == 0.0)
    np.testing.assert_array_equal(tsnap.numpy() == 0.0, w == 0.0)


def test_delta_kmeans_float32_labels_agree():
    w, off = _weight_and_offset(np.float32, seed=21, shape=(96, 96))
    _, jbook = j_quantize(jnp.asarray(w), 8, 5, offset=jnp.asarray(off))
    _, tbook = quantize_weight(torch.from_numpy(w), 8, 5, offset=torch.from_numpy(off))
    assert np.mean(tbook.labels.numpy() == np.asarray(jbook.labels)) >= 0.999
    assert np.all((tbook.labels.numpy() == 0) == (w == 0.0))


@pytest.mark.parametrize("stride", [2, 1])
def test_delta_row_stride_finetune_matches_jax(stride):
    """CoordX d5 s2 w16 at 16x16: params near a meta-init, masks at 0.85,
    5-bit residual codebooks against the meta-init, 10 finetune steps on
    every `stride`-th row. Quant PSNR within 0.02 dB of JAX's, labels agree
    on >= 99.9%, pruned weights exactly 0, and the weights follow
    w = (offset + centroids[labels]) * (labels != 0)."""
    arch = dict(depth=5, hidden_size=16, split_depth=2)
    jm, jc = jbuild("coordx", **arch)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(9), jc))
    rng = np.random.default_rng(9)
    masks = [(rng.uniform(size=layer["w"].shape) < 0.85).astype(np.float32) for layer in init]
    params = [{"w": ((layer["w"] + rng.normal(0, 2e-3, layer["w"].shape)) * m).astype(np.float32),
               "b": layer["b"]} for layer, m in zip(init, masks)]
    img = synthetic_image(16, 16, seed=9)
    kw = dict(bits=5, num_steps=10, ecvq_lambda=1.0, lr=1e-3, row_stride=stride)
    jres = j_finetune(params, jnp.asarray(img), jm, jc, jgrid(16, 16), JQuant(**kw),
                      JOptim(), masks=tuple(jnp.asarray(m) for m in masks),
                      offset_params=init, matmul_precision="float32")
    m, c = build_model("coordx", **arch)
    tres = quant_finetune(params_from_jax(params, "cpu"), img, m, c, get_grid(16, 16),
                          QuantConfig(**kw), OptimConfig(), precision="fp32",
                          masks=tuple(torch.from_numpy(x) for x in masks),
                          offset_params=params_from_jax(init, "cpu"))
    assert tres.metrics["quant_psnr"] == pytest.approx(float(jres.metrics["quant_psnr"]),
                                                       abs=0.02)
    n_books = 0
    for i, (tb, jb) in enumerate(zip(tres.codebooks, jres.codebooks)):
        assert (tb is None) == (jb is None)
        if tb is None:
            continue
        n_books += 1
        lab = tb.labels.numpy()
        assert np.mean(lab == np.asarray(jb.labels)) >= 0.999
        w = tres.params[i]["w"].numpy()
        np.testing.assert_array_equal(w[masks[i] == 0], 0.0)
        want = (tb.centroids.numpy()[lab] + init[i]["w"]) * (lab != 0)
        np.testing.assert_allclose(w, want, rtol=0, atol=1e-7)
    assert n_books == 4  # the (16, 16) layers; the (1, 16) and (16, 3) ones stay fp
