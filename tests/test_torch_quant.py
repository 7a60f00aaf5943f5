"""Port parity: k-means codebooks, ECVQ refinement and the codebook finetune."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.quant import QuantConfig as JQuant
from implicit_image_tpu.quant import quantized_layer_indices as j_qidx
from implicit_image_tpu.quant.kmeans import ecvq_refine as j_ecvq
from implicit_image_tpu.quant.kmeans import quantize_weight as j_quantize
from implicit_image_tpu_torch.data import get_grid, synthetic_image
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.quant import QuantConfig, convert, dequantize, quantized_layer_indices
from implicit_image_tpu_torch.quant.kmeans import (
    ecvq_refine,
    gather_centroids,
    quantize_weight,
    segment_sum,
)
from implicit_image_tpu_torch.training.fit import OptimConfig
from implicit_image_tpu_torch.training.quant_phase import quant_finetune

torch.set_num_threads(1)


def _weight(dtype, seed=0, shape=(64, 64), zeros=0.1):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, shape)
    w[rng.uniform(size=shape) < zeros] = 0.0
    return w.astype(dtype)


def _both(w, bits, lam):
    jw = jnp.asarray(w)
    _, jbook = j_quantize(jw, bits, 5)
    jbook2 = j_ecvq(jw, jbook, lam, 10)
    tw = torch.from_numpy(w)
    _, tbook = quantize_weight(tw, bits, 5)
    tbook2 = ecvq_refine(tw, tbook, lam, 10)
    return (jbook, jbook2), (tbook, tbook2)


@pytest.mark.parametrize("bits,lam", [(4, 1.0), (8, 1.0), (6, 5.0)])
def test_kmeans_and_ecvq_float64_identical(bits, lam):
    with jax.enable_x64(True):
        w = _weight(np.float64, seed=bits)
        jbooks, tbooks = _both(w, bits, lam)
        for jb, tb in zip(jbooks, tbooks):
            np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
            np.testing.assert_allclose(tb.centroids.numpy(), np.asarray(jb.centroids),
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("bits,lam", [(8, 1.0), (5, 0.5)])
def test_kmeans_and_ecvq_float32_labels_agree(bits, lam):
    w = _weight(np.float32, seed=10 + bits, shape=(128, 128))
    jbooks, tbooks = _both(w, bits, lam)
    for jb, tb in zip(jbooks, tbooks):
        agree = np.mean(tb.labels.numpy() == np.asarray(jb.labels))
        assert agree >= 0.999, agree
        assert float(tb.centroids[0]) == 0.0


def test_quantized_layer_indices_match():
    m, c = build_model("siren", depth=5, hidden_size=16)
    params = m.init(torch.Generator().manual_seed(0), c)
    for cfg_kw in ({}, {"bits": 9}, {"skip_layers": (0,)}):
        np_params = [{k: v.numpy() for k, v in layer.items()} for layer in params]
        assert quantized_layer_indices(params, QuantConfig(**cfg_kw)) == j_qidx(
            np_params, JQuant(**cfg_kw))


def test_convert_snaps_to_codebook():
    m, c = build_model("siren", depth=4, hidden_size=16)
    params = m.init(torch.Generator().manual_seed(0), c)
    snapped, books = convert(params, QuantConfig(bits=4))
    assert books[0] is None and books[-1] is None
    for layer, book in zip(snapped, books):
        if book is not None:
            torch.testing.assert_close(layer["w"], dequantize(book.labels, book.centroids))
            assert book.centroids.numel() == 16


def test_codebook_finetune_keeps_zero_centroid_and_improves():
    m, c = build_model("siren", depth=4, hidden_size=16)
    params = m.init(torch.Generator().manual_seed(0), c)
    img = synthetic_image(12, 12, seed=3)
    cfg0 = QuantConfig(bits=4, num_steps=0, ecvq_lambda=1.0)
    cfg = QuantConfig(bits=4, num_steps=30, ecvq_lambda=1.0, lr=1e-3)
    r0 = quant_finetune(params, img, m, c, get_grid(12, 12), cfg0, OptimConfig())
    r1 = quant_finetune(params, img, m, c, get_grid(12, 12), cfg, OptimConfig())
    assert r1.metrics["quant_psnr"] > r0.metrics["quant_psnr"]
    for layer, book in zip(r1.params, r1.codebooks):
        if book is not None:
            assert float(book.centroids[0]) == 0.0
            torch.testing.assert_close(layer["w"], book.centroids[book.labels.long()])


def test_quant_config_builds_qat():
    """QuantConfig(name="QAT") builds (per channel by default), and
    bits_per_layer stays KMeans-only, as the JAX config's assert holds."""
    assert QuantConfig(name="QAT").qscheme == "per_channel"
    assert QuantConfig(name="QAT", qscheme="per_tensor").name == "QAT"
    with pytest.raises(ValueError, match="KMeans-only"):
        QuantConfig(name="QAT", bits_per_layer=(None, 6, None))
    with pytest.raises(AssertionError):
        JQuant(name="QAT", bits_per_layer=(None, 6, None))


@pytest.mark.parametrize("n,k", [(4096, 255), (1000, 16), (37, 64)])
def test_segment_sum_matches_jax_one_hot_float64(n, k):
    """The deterministic segment sum equals the JAX functions' one-hot
    product in float64, to the bound of the k-means test above."""
    rng = np.random.default_rng(n + k)
    idx = rng.integers(0, k, n)
    vals = rng.normal(size=n)
    with jax.enable_x64(True):
        ref = np.asarray(jax.nn.one_hot(jnp.asarray(idx), k, dtype=jnp.float64).T
                         @ jnp.asarray(vals))
    ours = segment_sum(torch.from_numpy(idx), torch.from_numpy(vals), k).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_gather_centroids_gradient_is_the_cluster_sum():
    rng = np.random.default_rng(3)
    centroids = torch.from_numpy(rng.normal(size=16)).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, 16, (8, 12)))
    upstream = torch.from_numpy(rng.normal(size=(8, 12)))
    (g_ours,) = torch.autograd.grad((gather_centroids(centroids, labels) * upstream).sum(),
                                    centroids)
    (g_ref,) = torch.autograd.grad((centroids[labels] * upstream).sum(), centroids)
    torch.testing.assert_close(g_ours, g_ref, rtol=0, atol=1e-12)


def test_masked_finetune_keeps_pruned_weights_zero():
    """With the fit's masks, every pruned weight stays exactly 0 in the
    finetuned params, and its label is the 0 centroid's."""
    m, c = build_model("siren", depth=4, hidden_size=16)
    params = m.init(torch.Generator().manual_seed(1), c)
    gen = torch.Generator().manual_seed(2)
    masks = tuple((torch.rand(layer["w"].shape, generator=gen) < 0.5).float()
                  for layer in params)
    params = tuple({**layer, "w": layer["w"] * mk} for layer, mk in zip(params, masks))
    img = synthetic_image(12, 12, seed=4)
    res = quant_finetune(params, img, m, c, get_grid(12, 12),
                         QuantConfig(bits=4, num_steps=10, ecvq_lambda=1.0, lr=1e-3),
                         OptimConfig(), masks=masks)
    for layer, mk, book in zip(res.params, masks, res.codebooks):
        assert torch.all(layer["w"][mk == 0] == 0.0)
        if book is not None:
            assert torch.all(book.labels[mk == 0] == 0)
