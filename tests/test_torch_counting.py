"""Port parity: the MicroNet FLOP and size accounting
(sparsity/counting.py, the port's own copy of the JAX package's numpy
module). Every public function against the JAX package's on the same
inputs, exactly (the same float64 arithmetic in the same order): params
and masks as torch tensors on the port's side and as jax arrays on JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu.sparsity import counting as jc
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.sparsity import counting as tc


@pytest.mark.parametrize("fan_in,fan_out,sparsity,bias,act", [
    (4, 8, 0.0, True, True), (100, 10, 0.5, False, False), (128, 128, 0.37, True, False),
    (2, 3, 0.9, False, True)])
def test_layer_flops(fan_in, fan_out, sparsity, bias, act):
    assert tc.layer_flops(fan_in, fan_out, sparsity, bias, act) == jc.layer_flops(
        fan_in, fan_out, sparsity, bias, act)


@pytest.mark.parametrize("size,k,padding,stride", [(32, 3, "same", 1), (31, 5, "valid", 2),
                                                   (8, 1, "same", 3)])
def test_conv_counting(size, k, padding, stride):
    assert tc.conv_output_size(size, k, padding, stride) == jc.conv_output_size(
        size, k, padding, stride)
    for depthwise in (False, True):
        for s in (0.0, 0.6):
            args = (size, k, 16, 24 if not depthwise else 16, stride, padding, s, True, True,
                    depthwise)
            assert tc.conv_layer_flops(*args) == jc.conv_layer_flops(*args)
            pargs = (k, 16, 24, s, True, 16, depthwise)
            assert tc.conv_param_bits(*pargs) == jc.conv_param_bits(*pargs)
    with pytest.raises(ValueError):
        tc.conv_output_size(8, 3, "full")


def _model_and_masks(depth=5, width=32, sparsity=0.6, seed=0):
    m, c = build_model("siren", depth=depth, hidden_size=width)
    rng = np.random.default_rng(seed)
    p = tuple({k: rng.uniform(-0.1, 0.1, v.shape).astype(np.float32) for k, v in layer.items()}
              for layer in m.init(torch.Generator().manual_seed(seed), c))
    masks = [None] + [(rng.uniform(size=layer["w"].shape) >= sparsity).astype(np.float32)
                      for layer in p[1:-1]] + [None]
    p = tuple({**layer, "w": layer["w"] * mk} if mk is not None else layer
              for layer, mk in zip(p, masks))
    return p, masks


def _both(p, masks):
    tm = [None if mk is None else torch.from_numpy(mk) for mk in masks]
    jm = [None if mk is None else jnp.asarray(mk) for mk in masks]
    return (params_from_jax(p, "cpu"), tm), (jax.tree.map(jnp.asarray, p), jm)


@pytest.mark.parametrize("sparsity", [0.0, 0.6])
def test_model_counts(sparsity):
    p, masks = _model_and_masks(sparsity=sparsity)
    (tp, tm), (jp, jm) = _both(p, masks)
    assert tc.inference_flops(tp, tm) == jc.inference_flops(jp, jm)
    assert tc.inference_flops(tp) == jc.inference_flops(jp)
    assert tc.dense_flops(tp) == jc.dense_flops(jp)
    for bits in (32, 16):
        assert tc.sparse_param_bits(tp, tm, bits) == jc.sparse_param_bits(jp, jm, bits)
        assert tc.micronet_summary(tp, tm, bits, bits, bits) == jc.micronet_summary(
            jp, jm, bits, bits, bits)
        assert tc.micronet_score(tp, tm, bits, bits, bits) == jc.micronet_score(
            jp, jm, bits, bits, bits)
    assert tc.micronet_score(tp, tm, ref_params_mbytes=0.5, ref_mflops=2.0) == jc.micronet_score(
        jp, jm, ref_params_mbytes=0.5, ref_mflops=2.0)
    if sparsity == 0.0:
        assert abs(tc.micronet_score(tp) - 2.0) < 1e-9
        assert tc.inference_flops(tp) == tc.dense_flops(tp)
    else:
        assert tc.inference_flops(tp, tm) < tc.dense_flops(tp)


def test_sparse_param_bits_by_hand():
    half = ({"w": torch.cat([torch.ones(2, 4), torch.zeros(2, 4)]), "b": torch.ones(4)},)
    assert tc.sparse_param_bits(half) == (8 * 32 + 16) + 4 * 32  # nnz*32 + mask + bias
