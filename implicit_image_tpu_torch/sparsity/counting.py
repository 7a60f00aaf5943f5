"""Sparse FLOPs / parameter-size accounting, the MicroNet challenge's
(counterpart of implicit_image_tpu/sparsity/counting.py, numpy; the port's
own copy): per-sample FLOPs of the fully-connected layers (a dot product of
effective length n counts n mults and n - 1 adds, the sparsity scaling the
effective fan-in; a bias one add per output; an activation one mult per
output, the reference's 'relu' accounting, applied to the sine too), of a
square conv, and sparse storage as nnz * param_bits + one mask bit per
element. Params and masks may be torch tensors on any device or arrays.
The JAX package's `xla_cost_analysis` (XLA's cost model) has no
counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "layer_flops",
    "conv_output_size",
    "conv_layer_flops",
    "conv_param_bits",
    "inference_flops",
    "dense_flops",
    "sparse_param_bits",
    "micronet_summary",
    "micronet_score",
]


def layer_flops(
    fan_in: int,
    fan_out: int,
    sparsity: float = 0.0,
    has_bias: bool = True,
    activation: bool = True,
) -> Tuple[float, float]:
    """(mults, adds) per input sample for one (possibly sparse) FC layer."""
    n_elements = fan_in * (1.0 - sparsity)
    mults = n_elements * fan_out
    adds = (n_elements - 1.0) * fan_out
    if has_bias:
        adds += fan_out
    if activation:
        mults += fan_out  # 'relu' accounting (micronet_challenge.py:106-110)
    return mults, adds


def conv_output_size(
    image_size: int, kernel_size: int, padding: str = "same", stride: int = 1
) -> int:
    """Spatial output size of a square conv (micronet_challenge.py
    get_conv_output_size :139-158). padding is 'same' (pad = k//2) or
    'valid' (pad = 0)."""
    if padding == "same":
        pad = kernel_size // 2
    elif padding == "valid":
        pad = 0
    else:
        raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
    return int(np.ceil((image_size - kernel_size + 1.0 + 2 * pad) / stride))


def conv_layer_flops(
    image_size: int,
    kernel_size: int,
    c_in: int,
    c_out: int,
    stride: int = 1,
    padding: str = "same",
    sparsity: float = 0.0,
    has_bias: bool = True,
    activation: bool = True,
    depthwise: bool = False,
) -> Tuple[float, float]:
    """(mults, adds) per input image for one (possibly sparse) square conv.

    Semantics of the reference's Conv2D / DepthWiseConv2D branches of
    count_ops (micronet_challenge.py:161-285): each output element is one
    dot product of the flattened kernel patch (effective length scaled by
    1 - sparsity) — n mults, n-1 adds — plus one add per output for bias
    and the 'relu' activation cost (1 mult) per output element. For
    depthwise convs (groups == c_in) the patch spans one channel and
    c_out == c_in channels are produced independently.
    """
    if depthwise:
        vector_length = kernel_size * kernel_size * (1.0 - sparsity)
        n_out = conv_output_size(image_size, kernel_size, padding, stride) ** 2 * c_in
    else:
        vector_length = kernel_size * kernel_size * c_in * (1.0 - sparsity)
        n_out = conv_output_size(image_size, kernel_size, padding, stride) ** 2 * c_out
    mults = vector_length * n_out
    adds = (vector_length - 1.0) * n_out
    if has_bias:
        adds += n_out
    if activation:
        mults += n_out  # 'relu' accounting (micronet_challenge.py:106-110)
    return mults, adds


def conv_param_bits(
    kernel_size: int,
    c_in: int,
    c_out: int,
    sparsity: float = 0.0,
    has_bias: bool = True,
    param_bits: int = 32,
    depthwise: bool = False,
) -> float:
    """Bits to store a (possibly sparse) conv kernel + bias
    (get_sparse_size applied to the kernel shape, ops.py:37-67)."""
    n_elements = kernel_size * kernel_size * (c_in if not depthwise else 1) * (
        c_out if not depthwise else c_in
    )
    bits = n_elements * param_bits * (1.0 - sparsity)
    if sparsity > 0:
        bits += n_elements  # 1-bit mask
    if has_bias:
        bits += (c_out if not depthwise else c_in) * param_bits
    return bits


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _mask_sparsity(weight, mask) -> float:
    arr = _host(weight if mask is None else mask)
    return float((arr == 0).sum() / arr.size)


def inference_flops(params, masks: Optional[Sequence] = None) -> float:
    """Per-sample forward FLOPs at the ACTUAL weight sparsity
    (reference Masking.inference_FLOPs, core.py:362-384)."""
    total = 0.0
    n = len(params)
    widx = [i for i, layer in enumerate(params) if "w" in layer]
    for j, i in enumerate(widx):
        layer = params[i]
        fan_in, fan_out = layer["w"].shape[-2], layer["w"].shape[-1]
        mask = masks[i] if masks is not None else None
        s = _mask_sparsity(layer["w"], mask)
        mults, adds = layer_flops(
            fan_in,
            fan_out,
            sparsity=s,
            has_bias="b" in layer,
            activation=(j < len(widx) - 1),
        )
        total += mults + adds
    return total


def dense_flops(params) -> float:
    """Per-sample forward FLOPs of the dense model (core.py:229)."""
    dense_params = tuple(
        {k: _host(v) * 0 + 1.0 for k, v in layer.items()} for layer in params
    )
    return inference_flops(dense_params, None)


def sparse_param_bits(params, masks=None, param_bits: int = 32) -> float:
    """Bits to store the (sparse) weights+biases (get_sparse_size)."""
    total = 0.0
    for i, layer in enumerate(params):
        for k, v in layer.items():
            arr = _host(v)
            if k == "w" and masks is not None and masks[i] is not None:
                s = _mask_sparsity(v, masks[i])
            else:
                s = float((arr == 0).sum() / arr.size)
            bits = arr.size * param_bits * (1.0 - s)
            if s > 0:
                bits += arr.size  # 1-bit mask
            total += bits
    return total


def micronet_summary(
    params,
    masks: Optional[Sequence] = None,
    param_bits: int = 32,
    add_bits: int = 32,
    mul_bits: int = 32,
) -> dict:
    """MicroNet-challenge totals for the (possibly sparse) model.

    Reproduces MicroNetCounter.print_summary/process_counts semantics
    (reference micronet_challenge.py:312-480) for the FC model zoo:
    per-layer sparse param bits + mults/adds, then the challenge's
    bit-width normalization — params reported in MBytes (bits/8/1e6),
    mults scaled by mul_bits/32, adds by add_bits/32, in millions.
    Quantized ("freebie" 16-bit) configs pass param_bits/add_bits/
    mul_bits=16.
    """
    total_param_bits = 0.0
    total_mults = 0.0
    total_adds = 0.0
    widx = [i for i, layer in enumerate(params) if "w" in layer]
    for j, i in enumerate(widx):
        layer = params[i]
        fan_in, fan_out = layer["w"].shape[-2], layer["w"].shape[-1]
        s = _mask_sparsity(layer["w"], masks[i] if masks is not None else None)
        # sparse weight storage (get_sparse_size :120-138)
        total_param_bits += fan_in * fan_out * param_bits * (1.0 - s)
        if s > 0:
            total_param_bits += fan_in * fan_out  # 1-bit mask
        if "b" in layer:
            total_param_bits += fan_out * param_bits
        mults, adds = layer_flops(
            fan_in, fan_out,
            sparsity=s,
            has_bias="b" in layer,
            activation=(j < len(widx) - 1),
        )
        total_mults += mults
        total_adds += adds
    return {
        "params_mbytes": total_param_bits / 8.0 / 1e6,
        "mults_m": total_mults * mul_bits / 32.0 / 1e6,
        "adds_m": total_adds * add_bits / 32.0 / 1e6,
        "mflops": (total_mults * mul_bits + total_adds * add_bits) / 32.0 / 1e6,
    }


def micronet_score(
    params,
    masks: Optional[Sequence] = None,
    param_bits: int = 32,
    add_bits: int = 32,
    mul_bits: int = 32,
    ref_params_mbytes: Optional[float] = None,
    ref_mflops: Optional[float] = None,
) -> float:
    """The challenge-style normalized total the reference reports via its
    counter tables: storage/ref_storage + math/ref_math.

    The official MicroNet normalizers are task-specific (e.g. WideResNet
    -28-10 for CIFAR); for implicit image compression no official task
    exists, so the natural normalizer — and the default — is the DENSE
    fp32 model at the same architecture, making the score
    `storage_ratio + flop_ratio` (2.0 = dense fp32; smaller is better).
    """
    summary = micronet_summary(params, masks, param_bits, add_bits, mul_bits)
    if ref_params_mbytes is None or ref_mflops is None:
        dense = micronet_summary(params, None, 32, 32, 32)
        ref_params_mbytes = ref_params_mbytes or dense["params_mbytes"]
        ref_mflops = ref_mflops or dense["mflops"]
    return (
        summary["params_mbytes"] / ref_params_mbytes
        + summary["mflops"] / ref_mflops
    )
