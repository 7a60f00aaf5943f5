"""Optimizers (counterpart of implicit_image_tpu/optim/__init__.py): Adam
only; Shampoo and EKFAC are not ported yet (ROADMAP.md)."""
from __future__ import annotations

from implicit_image_tpu_torch.optim.adam import (
    AdamState,
    adam_init,
    adam_momentum,
    adam_update,
)
from implicit_image_tpu_torch.optim.schedules import cosine_lr, step_lr

__all__ = [
    "AdamState",
    "adam_init",
    "adam_update",
    "adam_momentum",
    "step_lr",
    "cosine_lr",
    "opt_init",
    "opt_update",
]


def _check(optim_cfg) -> None:
    if optim_cfg.name != "adam":
        raise NotImplementedError(
            f"optim={optim_cfg.name} is not ported yet (ROADMAP.md); use optim=adam"
        )


def opt_init(params, optim_cfg):
    _check(optim_cfg)
    return adam_init(params)


def opt_update(grads, opt_state, params, lr: float, optim_cfg):
    """One optimizer step (in place); returns (params, state)."""
    _check(optim_cfg)
    return adam_update(grads, opt_state, params, lr)
