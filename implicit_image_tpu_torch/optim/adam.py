"""Functional Adam with torch.optim.Adam semantics (counterpart of
implicit_image_tpu/optim/adam.py):

    mu  <- b1*mu + (1-b1)*g
    nu  <- b2*nu + (1-b2)*g^2
    p   <- p - lr * (mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps)

The state is a plain tuple of per-layer dicts, as in the JAX package, so
SNFS's momentum growth and redistribution read the raw moments through
`adam_momentum`. Unlike the
JAX version, the update is IN PLACE: params, mu and nu are overwritten,
which saves one copy of each per step. Leaves stored under a key outside
TRAINABLE_KEYS are left untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["AdamState", "TRAINABLE_KEYS", "adam_init", "adam_update", "adam_momentum"]

TRAINABLE_KEYS = ("w", "b", "centroids")


@dataclass
class AdamState:
    mu: Any
    nu: Any
    count: int


def adam_init(params) -> AdamState:
    zeros = lambda: tuple(  # noqa: E731
        {k: torch.zeros_like(v) for k, v in layer.items()} for layer in params
    )
    return AdamState(mu=zeros(), nu=zeros(), count=0)


@torch.no_grad()
def adam_update(grads, state: AdamState, params, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step in place; returns (params, state)."""
    count = state.count + 1
    dev = params[0][next(iter(params[0]))].device
    t = torch.tensor(float(count), dtype=torch.float32, device=dev)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), t)
    for layer, mu_l, nu_l, g_l in zip(params, state.mu, state.nu, grads):
        for k, p in layer.items():
            if k not in TRAINABLE_KEYS:
                continue
            g = g_l[k]
            mu, nu = mu_l[k], nu_l[k]
            mu.mul_(b1).add_((1.0 - b1) * g)
            nu.mul_(b2).add_((1.0 - b2) * (g * g))
            m_hat = mu / bc1
            denom = torch.sqrt(nu / bc2) + eps
            p.sub_(lr * m_hat / denom)
    state.count = count
    return params, state


def adam_momentum(state, layer: int, key: str = "w") -> torch.Tensor:
    """The momentum statistic of SNFS's growth and redistribution (the
    reference's get_momentum_for_weight): mu / (sqrt(nu) + 1e-8) of one
    tensor for an AdamState, the raw momentum buffer (SGD's
    momentum_buffer) for a ShampooState."""
    if isinstance(state, AdamState):
        return state.mu[layer][key] / (torch.sqrt(state.nu[layer][key]) + 1e-8)
    return state.momentum_buf[layer][key]
