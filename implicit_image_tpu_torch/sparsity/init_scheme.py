"""Sparsity initialization schemes (counterpart of
implicit_image_tpu/sparsity/init_scheme.py).

  * erdos-renyi / erdos-renyi-kernel: the ERK epsilon solver gives each
    layer a keep probability ∝ Σdims / Πdims, marking layers dense while the
    solution would exceed 1. It is numpy shape math, the JAX package's
    function line for line, so both packages get the same probabilities;
  * random: Bernoulli(density) per layer, the first masked layer kept dense
    (excluded from masking);
  * resume: the nonzero pattern of given weights;
  * lottery-ticket[-dist]: saved masks, shuffled within each layer for -dist;
  * struct-*: channel-structured masks, which need 4-D kernels; every
    model of the port is an MLP, so they raise, as in the JAX package.

Bernoulli draws and shuffles come from a CPU torch.Generator and the masks
then move to `device`, so they differ from the JAX package's jax.random
draws for the same seed; parity tests inject masks (lottery-ticket).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["erdos_renyi_probs", "init_masks", "registry_names"]

registry_names = (
    "erdos-renyi",
    "erdos-renyi-kernel",
    "lottery-ticket",
    "lottery-ticket-dist",
    "random",
    "resume",
    "struct-erdos-renyi",
    "struct-erdos-renyi-kernel",
    "struct-random",
)


def erdos_renyi_probs(
    shapes: Sequence[Tuple[int, ...]], density: float, is_kernel: bool = True
) -> List[float]:
    """ERK epsilon solver -> per-layer keep probability."""
    n = len(shapes)
    dense_layers: set = set()
    erk_power_scale = 1.0
    raw_probabilities: Dict[int, float] = {}
    while True:
        divisor = 0.0
        rhs = 0.0
        raw_probabilities = {}
        for i, shape in enumerate(shapes):
            n_param = int(np.prod(shape))
            n_zeros = int(n_param * (1.0 - density))
            n_ones = int(n_param * density)
            if i in dense_layers:
                rhs -= n_zeros
            else:
                rhs += n_ones
                if is_kernel:
                    raw_probabilities[i] = (np.sum(shape) / np.prod(shape)) ** erk_power_scale
                else:
                    n_in, n_out = shape[:2]
                    raw_probabilities[i] = (n_in + n_out) / (n_in * n_out)
                divisor += raw_probabilities[i] * n_param
        epsilon = rhs / divisor
        max_prob = max(raw_probabilities.values())
        if max_prob * epsilon > 1.0:
            for i, p in raw_probabilities.items():
                if p == max_prob:
                    dense_layers.add(i)
        else:
            break
    return [1.0 if i in dense_layers else float(epsilon * raw_probabilities[i])
            for i in range(n)]


def _bernoulli_mask(generator, shape, prob, device) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) < prob).to(torch.float32).to(device)


def init_masks(
    generator: Optional[torch.Generator],
    weight_shapes: Sequence[Tuple[int, ...]],
    density: float,
    scheme: str = "erdos-renyi-kernel",
    weights: Optional[Sequence[torch.Tensor]] = None,
    lottery_masks: Optional[Sequence] = None,
    device="cpu",
) -> List[Optional[torch.Tensor]]:
    """Initial 0/1 float32 masks for the masked weight tensors, aligned with
    `weight_shapes`; None means the layer is excluded from masking."""
    if scheme not in registry_names:
        raise KeyError(f"Sparse init {scheme!r} not found. Available {registry_names}")
    n = len(weight_shapes)

    if scheme in ("erdos-renyi", "erdos-renyi-kernel"):
        probs = erdos_renyi_probs(weight_shapes, density,
                                  is_kernel=(scheme == "erdos-renyi-kernel"))
        return [_bernoulli_mask(generator, weight_shapes[i], probs[i], device)
                for i in range(n)]

    if scheme == "random":
        return [None] + [_bernoulli_mask(generator, weight_shapes[i], density, device)
                         for i in range(1, n)]

    if scheme == "resume":
        src = lottery_masks if lottery_masks is not None else weights
        if src is None:
            raise ValueError("resume init needs weights (live or from npz)")
        return [(torch.as_tensor(w) != 0).to(torch.float32).to(device) for w in src]

    if scheme in ("lottery-ticket", "lottery-ticket-dist"):
        if lottery_masks is None:
            raise ValueError("lottery init needs a saved mask (masking.mask_path)")
        out = []
        for m in lottery_masks:
            m = torch.as_tensor(np.asarray(m, np.float32))
            if scheme == "lottery-ticket-dist":
                # keep the layer's density, shuffle the positions
                flat = m.reshape(-1)
                m = flat[torch.randperm(flat.numel(), generator=generator)].reshape(m.shape)
            out.append(m.to(device))
        return out

    # struct-*: channel-structured masks need 4-D conv kernels
    raise ValueError(
        "struct-* sparsity init requires 4D conv kernels; the MLP model zoo has none"
    )
