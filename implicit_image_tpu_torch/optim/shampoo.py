"""Functional Shampoo (counterpart of implicit_image_tpu/optim/shampoo.py),
with torch_optimizer's update semantics, as the JAX package sets them out:

    g   <- (1 - momentum) * grad + momentum * buf   (buf: the previous
                                                     preconditioned grad;
                                                     step 0 takes grad)
    g   <- g + weight_decay * p
    per dim i:  P_i += mat_i(g) @ mat_i(g)^T
                g    = P_i^(-1/order) @ mat_i(g)     (order = g.ndim)
    g   <- g * |g_blend| / |g|                       (graft_norm)
    buf <- g
    p   <- p - lr * g

The inverse roots are cached and refreshed when count % update_freq == 0
(count counts from 0, so the first step refreshes). P^(-1/order) comes from
`torch.linalg.eigh` in fp32 with the eigenvalues clamped at 1e-12.

The state is a dataclass of per-layer dicts like AdamState, and the update
is in place (params, buffers and factors overwritten). Dimension i of every
leaf is preconditioned in one round: the round's factors due for a refresh
are stacked by shape into one batched `eigh` each (a d8/w128 SIREN: 4
batched calls in place of 23 on a refreshing step); a leaf's dimension i+1
reads the result of its dimension i, so the rounds run in order. Nothing is
read on the host: the refresh and the step-0 blend are decisions on the
Python step count. On the card the Gram products must be true fp32
(ops.check_fp32: TF32 off).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from implicit_image_tpu_torch.ops import check_fp32, eigh_by_shape
from implicit_image_tpu_torch.optim.adam import TRAINABLE_KEYS

__all__ = ["ShampooState", "shampoo_init", "shampoo_update", "inverse_roots"]


@dataclass
class ShampooState:
    momentum_buf: Any  # per layer {key: the previous preconditioned grad}
    preconds: Any  # per layer {key: [P_i for each dim]}
    inv_preconds: Any  # per layer {key: [P_i^(-1/order) for each dim]}
    count: int


def shampoo_init(params, epsilon: float = 1e-4) -> ShampooState:
    def eyes(p, scale):
        return [scale * torch.eye(d, dtype=torch.float32, device=p.device) for d in p.shape]

    trainable = [{k: v for k, v in layer.items() if k in TRAINABLE_KEYS} for layer in params]
    return ShampooState(
        momentum_buf=tuple({k: torch.zeros_like(v) for k, v in layer.items()}
                           for layer in trainable),
        preconds=tuple({k: eyes(v, epsilon) for k, v in layer.items()} for layer in trainable),
        inv_preconds=tuple({k: eyes(v, 1.0) for k, v in layer.items()} for layer in trainable),
        count=0,
    )


def inverse_roots(mats, order: int):
    """[m^(-1/order) for m in mats] (symmetric PSD): fp32 eigh (one batched
    call per shape), eigenvalues clamped at 1e-12."""
    roots = []
    for w, v in eigh_by_shape([m.float() for m in mats]):
        roots.append((v * torch.clamp(w, min=1e-12).pow(-1.0 / order)) @ v.t())
    return roots


def _matricize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`dim` to the front, the rest flattened."""
    perm = (dim,) + tuple(i for i in range(x.ndim) if i != dim)
    return x.permute(perm).reshape(x.shape[dim], -1)


def _unmatricize(m: torch.Tensor, dim: int, shape) -> torch.Tensor:
    moved = (shape[dim],) + tuple(s for i, s in enumerate(shape) if i != dim)
    inv_perm = list(range(1, dim + 1)) + [0] + list(range(dim + 1, len(shape)))
    return m.reshape(moved).permute(inv_perm)


@torch.no_grad()
def shampoo_update(grads, state: ShampooState, params, lr: float, momentum: float = 0.9,
                   weight_decay: float = 0.0, graft_norm: bool = True, update_freq: int = 1):
    """One Shampoo step in place; returns (params, state). `grads` holds an
    entry for every trainable leaf (TRAINABLE_KEYS) and may omit frozen
    ones."""
    refresh = state.count % max(1, int(update_freq)) == 0
    leaves = []  # (layer, key, param, blended grad, working grad)
    for i, layer in enumerate(params):
        for k, p in layer.items():
            if k not in TRAINABLE_KEYS:
                continue
            g = grads[i][k]
            check_fp32(g, "optim=shampoo")
            if momentum > 0.0 and state.count > 0:
                g = (1.0 - momentum) * g + momentum * state.momentum_buf[i][k]
            if weight_decay:
                g = g + weight_decay * p
            leaves.append([i, k, p, g, g])
    rounds = max((leaf[3].ndim for leaf in leaves), default=0)
    for dim in range(rounds):
        at = [leaf for leaf in leaves if leaf[4].ndim > dim]
        mats = [_matricize(leaf[4], dim) for leaf in at]
        for leaf, mat in zip(at, mats):
            pcs = state.preconds[leaf[0]][leaf[1]]
            pcs[dim] = pcs[dim] + mat @ mat.t()
        if refresh:
            by_order = {}
            for j, leaf in enumerate(at):
                by_order.setdefault(max(leaf[4].ndim, 1), []).append(j)
            for order, idx in by_order.items():
                roots = inverse_roots([state.preconds[at[j][0]][at[j][1]][dim] for j in idx],
                                      order)
                for j, root in zip(idx, roots):
                    state.inv_preconds[at[j][0]][at[j][1]][dim] = root
        for leaf, mat in zip(at, mats):
            inv = state.inv_preconds[leaf[0]][leaf[1]][dim]
            leaf[4] = _unmatricize(inv @ mat, dim, leaf[4].shape)
    for i, k, p, g_blend, g in leaves:
        if graft_norm:
            gn = torch.sqrt(torch.sum(g_blend * g_blend))
            pn = torch.sqrt(torch.sum(g * g))
            g = g * (gn / torch.clamp(pn, min=1e-16))
        state.momentum_buf[i][k] = g.contiguous()
        p.sub_(lr * g)
    state.count += 1
    return params, state
