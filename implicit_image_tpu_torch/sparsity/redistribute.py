"""Redistribution statistics (counterpart of
implicit_image_tpu/sparsity/redistribute.py): an unnormalized per-layer
statistic; normalized across layers it is the share of regrowth."""
from __future__ import annotations

import torch

__all__ = [
    "momentum_redistribution",
    "grad_redistribution",
    "nonzero_redistribution",
    "registry_names",
]

registry_names = ("momentum", "grad", "nonzero", "none")


def _live_mean_abs(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    live = mask > 0
    return (values.abs() * live).sum() / torch.clamp(live.sum(), min=1)


def momentum_redistribution(mask, weight, grad, momentum) -> torch.Tensor:
    """Mean |momentum| over the surviving weights."""
    return _live_mean_abs(mask, momentum)


def grad_redistribution(mask, weight, grad, momentum) -> torch.Tensor:
    """Mean |grad| over the surviving weights."""
    return _live_mean_abs(mask, grad)


def nonzero_redistribution(mask, weight, grad, momentum) -> torch.Tensor:
    """Surviving-weight count (keeps the existing distribution)."""
    return (mask > 0).sum().to(torch.float32)
