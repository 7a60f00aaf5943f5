"""Prune-rate decay schedules (counterpart of
implicit_image_tpu/sparsity/decay.py).

  * cosine_decay: eta_min + (r0 - eta_min)·(1 + cos(π·t/T_max))/2, t
    clamped to [0, T_max];
  * linear_decay: r0·(1 - t/T_max), clamped;
  * magnitude_prune_decay: the Zhu-Gupta cubic cumulative sparsity s(t);
    rate = max(s(t) - current_sparsity, 0).

The step is a Python int in the fit loop, so everything that depends on it
alone is computed on the host in float32 numpy scalars, one operation after
another in the JAX functions' order, and gives their float32 bits. The
cosine is the C library's `cosf`, which is what the JAX function evaluates
on the CPU (torch.cos and numpy's cos round some arguments the other way).
Only `current_sparsity` may live on the device: the magnitude-prune rate is
then one device subtraction and clamp. Nothing reads a device value.

The JAX schedules take `final_sparsity` as a traced override so that one
compiled program serves a ladder of final densities. The port builds one
schedule per fit instead: a GMP density ladder (parallel/ladder.py) builds
one for each member from that member's masking config (its
`final_density`), `training.fit.SparseFit` keeps it beside the member's
mask state, and each member's rates are those of a single fit at its
target, the same float32 bits.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Callable

import numpy as np
import torch

__all__ = [
    "cosine_decay",
    "linear_decay",
    "magnitude_prune_decay",
    "cumulative_sparsity",
    "build_decay",
]

# prune_rate_fn(step, current_sparsity=None) -> float32 rate: a numpy
# float32, or a 0-d tensor on current_sparsity's device when that is a tensor
PruneRateFn = Callable

_f32 = np.float32


@functools.cache
def _libm_cosf():
    cosf = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    cosf.argtypes = [ctypes.c_float]
    cosf.restype = ctypes.c_float
    return cosf


def _cos32(x: np.float32) -> np.float32:
    return _f32(_libm_cosf()(float(x)))


def _clamped_step(step: int, t_max: int) -> np.float32:
    return _f32(min(max(_f32(step), _f32(0.0)), _f32(t_max)))


def cosine_decay(prune_rate: float, T_max: int, eta_min: float = 0.0) -> PruneRateFn:
    def fn(step, current_sparsity=None):
        t = _clamped_step(step, T_max)
        c = _cos32(_f32(_f32(math.pi) * t) / _f32(T_max))
        return _f32(eta_min) + _f32(_f32(prune_rate - eta_min) * (_f32(1.0) + c)) / _f32(2.0)

    return fn


def linear_decay(prune_rate: float, T_max: int) -> PruneRateFn:
    def fn(step, current_sparsity=None):
        t = _clamped_step(step, T_max)
        return _f32(prune_rate) * (_f32(1.0) - t / _f32(T_max))

    return fn


def cumulative_sparsity(step, initial_sparsity: float, final_sparsity: float,
                        T_start: int, T_max: int) -> np.float32:
    """Zhu-Gupta cubic cumulative sparsity s(t), float32."""
    t = _f32(step)
    frac = (t - _f32(T_start)) / _f32(T_max - T_start)
    frac = min(max(frac, _f32(0.0)), _f32(1.0))
    m = _f32(1.0) - frac
    mul = m * m * m
    s = _f32(final_sparsity) + _f32(initial_sparsity - final_sparsity) * mul
    return _f32(initial_sparsity) if t < _f32(T_start) else s


def magnitude_prune_decay(final_sparsity: float, T_max: int, T_start: int,
                          interval: int, initial_sparsity: float = 0.0) -> PruneRateFn:
    """rate = max(cumulative_sparsity(t) - current_sparsity, 0); without a
    current sparsity, the schedule's own value one interval earlier."""

    def fn(step, current_sparsity=None):
        cum = cumulative_sparsity(step, initial_sparsity, final_sparsity, T_start, T_max)
        if current_sparsity is None:
            current_sparsity = cumulative_sparsity(
                step - interval, initial_sparsity, final_sparsity, T_start, T_max)
        if isinstance(current_sparsity, torch.Tensor):
            return torch.clamp(float(cum) - current_sparsity, min=0.0)
        return max(cum - _f32(current_sparsity), _f32(0.0))

    return fn


def build_decay(masking_cfg) -> PruneRateFn:
    """The schedule a masking config names."""
    schedule = masking_cfg.decay_schedule
    if schedule == "magnitude-prune":
        return magnitude_prune_decay(
            final_sparsity=1.0 - masking_cfg.final_density,
            T_max=masking_cfg.end_when,
            T_start=masking_cfg.start_when,
            interval=masking_cfg.interval,
        )
    if schedule == "cosine":
        return cosine_decay(masking_cfg.prune_rate, T_max=masking_cfg.end_when)
    if schedule == "linear":
        return linear_decay(masking_cfg.prune_rate, T_max=masking_cfg.end_when)
    raise KeyError(f"Unknown decay schedule {schedule!r}")
