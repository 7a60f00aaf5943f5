"""Growth functions (counterpart of implicit_image_tpu/sparsity/grow.py):
regrow among the masked-out weights.

  * abs_grad_growth (RigL): the top-|grad| holes;
  * momentum_growth (SNFS): the top-|momentum| holes, momentum being Adam's
    mu / (sqrt(nu) + 1e-8) (optim.adam_momentum);
  * random_growth: Bernoulli(num_growth / holes) on the holes, drawn from a
    CPU torch.Generator, so its masks differ from the JAX package's draws;
  * no_growth, and struct_abs_grad_growth for 4-D kernels.

Each returns (new_mask, new_weight) with the regrown weights set to 0.
`num_growth` is a 0-d float32 tensor; ranks come from the stable argsort
of prune.py, so tied scores (live entries score -1, zero gradients tie at 0)
are taken in index order as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from implicit_image_tpu_torch.sparsity.prune import ranks_descending

__all__ = [
    "abs_grad_growth",
    "momentum_growth",
    "random_growth",
    "no_growth",
    "struct_abs_grad_growth",
    "registry_names",
]

registry_names = (
    "absolute-gradient",
    "momentum",
    "random",
    "none",
    "struct-absolute-gradient-mean",
    "struct-absolute-gradient-min",
)


def _score_growth(mask: torch.Tensor, weight: torch.Tensor, score: torch.Tensor,
                  num_growth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grow the top-`num_growth` positions of |score| among mask == 0."""
    is_zero = mask == 0
    s = torch.where(is_zero, score.abs(), -1.0)
    grow = is_zero & (ranks_descending(s) < torch.minimum(num_growth, is_zero.sum()))
    return torch.maximum(mask, grow.to(mask.dtype)), torch.where(grow, 0.0, weight)


def abs_grad_growth(mask, weight, grad, num_growth):
    """RigL regrowth by largest |grad| among holes."""
    return _score_growth(mask, weight, grad, num_growth)


def momentum_growth(mask, weight, momentum, num_growth):
    """SNFS regrowth by largest |momentum| among holes."""
    return _score_growth(mask, weight, momentum, num_growth)


def random_growth(mask, weight, score, num_growth,
                  generator: Optional[torch.Generator] = None):
    """Each hole grows with probability num_growth / holes."""
    is_zero = mask == 0
    n = is_zero.sum()
    prob = torch.where(n > 0, num_growth / torch.clamp(n, min=1), 0.0)
    draw = torch.rand(mask.shape, generator=generator).to(mask.device)
    grow = is_zero & (draw < prob)
    new_mask = torch.maximum(mask, grow.to(mask.dtype))
    new_weight = torch.where(grow | (new_mask == 0), 0.0, weight)
    return new_mask, new_weight


def no_growth(mask, weight, score, num_growth):
    return mask, weight


def struct_abs_grad_growth(mask, weight, grad, num_growth, criterion="mean"):
    """Channel-structured regrowth of a 4-D kernel tensor."""
    if weight.ndim != 4:
        raise ValueError("struct growth requires 4D kernels")
    c_in, c_out, h, w = weight.shape
    kernel_size = h * w
    red = grad.abs().reshape(c_in * c_out, kernel_size)
    scores = red.mean(-1) if criterion == "mean" else red.amin(-1)
    kernel_zero = mask.reshape(c_in * c_out, kernel_size).sum(-1) == 0
    s = torch.where(kernel_zero, scores, -1.0)
    grow = (kernel_zero & (ranks_descending(s) < num_growth / kernel_size)).reshape(
        c_in, c_out, 1, 1)
    new_mask = torch.maximum(mask, grow.expand(mask.shape).to(mask.dtype))
    return new_mask, torch.where(grow.expand(weight.shape), 0.0, weight)
