"""Uniform fake-quantization, the QAT quantizer (counterpart of
implicit_image_tpu/quant/uniform.py; fbgemm's semantics).

  * `fake_quant_per_channel` / `per_channel_quantize_weight`: fbgemm's
    default QAT weight scheme (quant.qscheme=per_channel), symmetric over
    the OUTPUT channel of the (in, out) layout: scale = amax / ((2^b - 1) /
    2), codes clipped to [-2^(b-1), 2^(b-1) - 1] and stored as int8
    (`PerChannelCodebook`; decode is codes * scales[None, :]).
  * `fake_quant` / `uniform_quantize_weight`: per-tensor affine
    (quant.qscheme=per_tensor), the range holding 0; its convert emits the
    k-means layout (labels = the codes, centroids = (q - zero_point) *
    scale, 2^b entries).
  * `ObserverState` / `observe_minmax`: MovingAverageMinMaxObserver's
    running min / max for activation ranges (the first batch sets them,
    later ones move them by averaging_constant).

Rounding: torch.round, like jnp.round, rounds half to even, so the codes
equal the JAX package's; a code that flipped here would change the
container's bytes. For the same reason the scales are computed as the
JAX package's compiled programs compute them: XLA rewrites a division by
a constant into a product with its fp32 reciprocal (amax * (1 / 127.5),
not amax / 127.5, one ulp apart at times), and a weight near a half-way
point takes the code of the scale it is divided by.

The fake-quant outputs are x + (xq - x) with the difference detached, the
JAX package's x + stop_gradient(xq - x), value and gradient alike (the sum
can differ from xq in its last bit).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.quant.kmeans import LayerCodebook

__all__ = [
    "fake_quant",
    "uniform_quantize_weight",
    "fake_quant_per_channel",
    "per_channel_quantize_weight",
    "PerChannelCodebook",
    "ObserverState",
    "observer_init",
    "observe_minmax",
]


class PerChannelCodebook(NamedTuple):
    """codes: int8, the weight's (in, out) shape; scales: (out,).
    weight = codes * scales[None, :]."""

    codes: torch.Tensor
    scales: torch.Tensor


class ObserverState(NamedTuple):
    min_val: torch.Tensor  # 0-d
    max_val: torch.Tensor  # 0-d
    initialized: torch.Tensor  # 0-d bool


def observer_init(device="cpu") -> ObserverState:
    zero = torch.zeros((), device=device)
    return ObserverState(zero, zero.clone(), torch.zeros((), dtype=torch.bool, device=device))


def observe_minmax(state: ObserverState, x: torch.Tensor,
                   averaging_constant: float = 0.01) -> ObserverState:
    bmin, bmax = torch.min(x), torch.max(x)
    c = averaging_constant
    new_min = torch.where(state.initialized, state.min_val + c * (bmin - state.min_val), bmin)
    new_max = torch.where(state.initialized, state.max_val + c * (bmax - state.max_val), bmax)
    return ObserverState(new_min, new_max, torch.ones_like(state.initialized))


def _reciprocal(c: float) -> float:
    """1 / c rounded to fp32: the factor XLA multiplies by for x / c."""
    return float(np.float32(1.0 / c))


def _qparams(x: torch.Tensor, bits: int):
    qmax = float(2**bits - 1)
    lo = torch.clamp(torch.min(x), max=0.0)  # the range includes 0
    hi = torch.clamp(torch.max(x), min=0.0)
    scale = torch.clamp((hi - lo) * _reciprocal(qmax), min=1e-12)
    zero_point = torch.clamp(torch.round(-lo / scale), 0.0, qmax)
    return scale, zero_point, qmax


def fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-tensor quantize-dequantize with a straight-through gradient."""
    scale, zero_point, qmax = _qparams(x, bits)
    q = torch.clamp(torch.round(x / scale + zero_point), 0.0, qmax)
    xq = (q - zero_point) * scale
    return x + (xq - x).detach()


def uniform_quantize_weight(weight: torch.Tensor, bits: int = 8
                            ) -> Tuple[torch.Tensor, LayerCodebook]:
    """(snapped weight, LayerCodebook): centroids[q] = (q - zero_point) *
    scale, labels = the codes q (int32)."""
    scale, zero_point, qmax = _qparams(weight, bits)
    q = torch.clamp(torch.round(weight / scale + zero_point), 0.0, qmax).to(torch.int32)
    centroids = (torch.arange(2**bits, dtype=weight.dtype, device=weight.device)
                 - zero_point) * scale
    return centroids[q.long()], LayerCodebook(centroids=centroids, labels=q)


def _per_channel_qparams(weight: torch.Tensor, bits: int, axis: int = 1):
    """Symmetric per-channel scales over `axis` (the output channel of the
    (in, out) layout): amax / ((2^b - 1) / 2), torch's per_channel_symmetric
    formula (amax / 127.5 at 8 bits), as a product with the reciprocal."""
    reduce_dims = tuple(i for i in range(weight.ndim) if i != axis)
    lo = torch.amin(weight, dim=reduce_dims)
    hi = torch.amax(weight, dim=reduce_dims)
    qmax = float(2 ** (bits - 1) - 1)
    amax = torch.clamp(torch.maximum(-lo, hi), min=0.0)
    scale = torch.clamp(amax * _reciprocal((2.0**bits - 1.0) / 2.0), min=1e-12)
    return scale, qmax


def _per_channel_codes(weight: torch.Tensor, bits: int, axis: int):
    scale, qmax = _per_channel_qparams(weight, bits, axis)
    shape = [1] * weight.ndim
    shape[axis] = -1
    s = scale.reshape(shape)
    q = torch.clamp(torch.round(weight / s), -qmax - 1, qmax)
    return q, s, scale


def fake_quant_per_channel(weight: torch.Tensor, bits: int = 8, axis: int = 1) -> torch.Tensor:
    """Per-channel symmetric quantize-dequantize with a straight-through
    gradient (QAT re-observes the weight's range every step)."""
    q, s, _ = _per_channel_codes(weight, bits, axis)
    return weight + (q * s - weight).detach()


def per_channel_quantize_weight(weight: torch.Tensor, bits: int = 8, axis: int = 1
                                ) -> Tuple[torch.Tensor, PerChannelCodebook]:
    """(snapped weight = codes * scales, PerChannelCodebook(int8 codes,
    scales in the weight's dtype))."""
    q, s, scale = _per_channel_codes(weight, bits, axis)
    return q * s, PerChannelCodebook(codes=q.to(torch.int8), scales=scale.to(weight.dtype))
