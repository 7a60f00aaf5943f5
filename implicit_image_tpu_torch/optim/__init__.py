"""Optimizers (counterpart of implicit_image_tpu/optim/__init__.py): Adam
and Shampoo (optim.name, `optimizer_registry`), both after the opt-in
global-norm gradient clipping (optim.grad_clip). The EKFAC preconditioner
(optim.preconditioner=ekfac, optim/ekfac.py) acts on the gradients in the
fit loop before either (training/fit.py)."""
from __future__ import annotations

from typing import Optional

import torch

from implicit_image_tpu_torch.optim.adam import (
    TRAINABLE_KEYS,
    AdamState,
    adam_init,
    adam_momentum,
    adam_update,
)
from implicit_image_tpu_torch.optim.schedules import cosine_lr, step_lr
from implicit_image_tpu_torch.optim.shampoo import ShampooState, shampoo_init, shampoo_update

__all__ = [
    "AdamState",
    "adam_init",
    "adam_update",
    "adam_momentum",
    "ShampooState",
    "shampoo_init",
    "shampoo_update",
    "optimizer_registry",
    "step_lr",
    "cosine_lr",
    "clip_by_global_norm",
    "opt_init",
    "opt_update",
]

optimizer_registry = ["adam", "shampoo"]


def clip_by_global_norm(grads, max_norm: float):
    """Scale the gradients so that their global L2 norm is at most max_norm:
    returns (grads * scale, scale), scale = min(1, max_norm / max(norm,
    1e-12)) a 0-d tensor. The squared norms are summed in a fixed order
    (layer by layer, keys sorted, as jax.tree_util orders the JAX package's
    leaves), with no atomics; nothing is read on the host."""
    leaves = [layer[k] for layer in grads for k in sorted(layer)]
    total = None
    for g in leaves:
        sq = torch.sum(g * g)
        total = sq if total is None else total + sq
    scale = torch.clamp(max_norm / torch.clamp(torch.sqrt(total), min=1e-12), max=1.0)
    return tuple({k: v * scale for k, v in layer.items()} for layer in grads), scale


def opt_init(params, optim_cfg, members: bool = False):
    """The state of optim_cfg.name's optimizer; `members`: params whose
    leaves carry a leading member axis (M fits: Shampoo then keeps one
    factor stack per member; Adam is elementwise either way)."""
    if optim_cfg.name == "adam":
        return adam_init(params)
    if optim_cfg.name == "shampoo":
        return shampoo_init(params, float(optim_cfg.epsilon), members=members)
    raise KeyError(f"optim={optim_cfg.name!r} is not one of {optimizer_registry}")


def _clip_members(grads, max_norm: float):
    """clip_by_global_norm of each member of grads whose leaves carry a
    leading member axis: each member's norm over its own slices, in the
    single clip's order (so each member has its single fit's bits); returns
    (grads, the (M,) scales)."""
    first = next(v for layer in grads for v in layer.values())
    scales = torch.stack([clip_by_global_norm(tuple({k: v[m] for k, v in layer.items()}
                                                    for layer in grads), max_norm)[1]
                          for m in range(first.shape[0])])
    return tuple({k: v * scales.reshape((-1,) + (1,) * (v.ndim - 1)) for k, v in layer.items()}
                 for layer in grads), scales


def opt_update(grads, opt_state, params, lr: float, optim_cfg, stats: Optional[dict] = None,
               members: bool = False):
    """One step of optim_cfg.name's optimizer (in place); returns (params,
    state). With optim.grad_clip > 0 the gradients are clipped to that
    global norm first, where the JAX package clips (after the fit's
    gradient masking and the EKFAC preconditioning), and `stats`, when
    given, receives the clip's scale under "clip_scale". `members`: the
    leaves carry a leading member axis (M fits): each member is clipped to
    its own global norm (the scales are then (M,)), and Shampoo
    preconditions each member on its own."""
    clip = float(getattr(optim_cfg, "grad_clip", 0.0) or 0.0)
    if clip > 0:
        trainable = tuple({k: v for k, v in layer.items() if k in TRAINABLE_KEYS}
                          for layer in grads)
        grads, scale = (_clip_members if members else clip_by_global_norm)(trainable, clip)
        if stats is not None:
            stats["clip_scale"] = scale
    if optim_cfg.name == "adam":
        return adam_update(grads, opt_state, params, lr)
    if optim_cfg.name == "shampoo":
        return shampoo_update(grads, opt_state, params, lr, momentum=float(optim_cfg.momentum),
                              weight_decay=float(optim_cfg.weight_decay),
                              graft_norm=bool(optim_cfg.graft_norm),
                              update_freq=int(optim_cfg.update_freq), members=members)
    raise KeyError(f"optim={optim_cfg.name!r} is not one of {optimizer_registry}")
