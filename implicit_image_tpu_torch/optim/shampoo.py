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

Over a member axis (M fits whose leaves carry a leading member axis, the
batched fit's: `members=True`) each member keeps its own factor stack
(M, d, d) over its leaf's own dimensions, as the JAX package's jax.vmap of
the update does: the member axis is never matricized with a leaf's
dimensions, which would mix the members. A refresh decomposes every
member's factors of one shape in one batched eigh.
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


def shampoo_init(params, epsilon: float = 1e-4, members: bool = False) -> ShampooState:
    """The state of a fit's params, or (`members`) of M fits whose leaves
    carry a leading member axis: then each factor is a stack (M, d, d), one
    per member, over the leaf's own dimensions (the member axis is not one)."""
    lead = int(members)

    def eyes(p, scale):
        out = []
        for d in p.shape[lead:]:
            e = scale * torch.eye(d, dtype=torch.float32, device=p.device)
            out.append(e.expand(p.shape[0], d, d).clone() if members else e)
        return out

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


def _matricize(x: torch.Tensor, dim: int, lead: int = 0) -> torch.Tensor:
    """Dimension `dim` (after `lead` leading member axes) to the front, the
    rest flattened: (d, rest), or (M, d, rest) over a member axis."""
    dims = range(lead, x.ndim)
    at = lead + dim
    perm = tuple(range(lead)) + (at,) + tuple(i for i in dims if i != at)
    return x.permute(perm).reshape(x.shape[:lead] + (x.shape[at], -1))


def _unmatricize(m: torch.Tensor, dim: int, shape, lead: int = 0) -> torch.Tensor:
    at = lead + dim
    moved = tuple(shape[:lead]) + (shape[at],) + tuple(s for i, s in enumerate(shape)
                                                       if i >= lead and i != at)
    inv_perm = (list(range(lead)) + list(range(lead + 1, at + 1)) + [lead]
                + list(range(at + 1, len(shape))))
    return m.reshape(moved).permute(inv_perm)


def _sq_norm(g: torch.Tensor, lead: int) -> torch.Tensor:
    """Sum of squares of a leaf, or of each member's slice (shaped to
    broadcast against the leaf)."""
    if not lead:
        return torch.sum(g * g)
    return torch.sum(g * g, dim=tuple(range(lead, g.ndim)), keepdim=True)


@torch.no_grad()
def shampoo_update(grads, state: ShampooState, params, lr: float, momentum: float = 0.9,
                   weight_decay: float = 0.0, graft_norm: bool = True, update_freq: int = 1,
                   members: bool = False):
    """One Shampoo step in place; returns (params, state). `grads` holds an
    entry for every trainable leaf (TRAINABLE_KEYS) and may omit frozen
    ones. `members`: the leaves carry a leading member axis (shampoo_init
    with members): each member's factors see only its own slice, every
    refresh decomposes the M x (leaves of a shape) factors in one batched
    eigh, and the graft norms are per member."""
    lead = int(members)
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
    rounds = max((leaf[3].ndim - lead for leaf in leaves), default=0)
    for dim in range(rounds):
        at = [leaf for leaf in leaves if leaf[4].ndim - lead > dim]
        mats = [_matricize(leaf[4], dim, lead) for leaf in at]
        for leaf, mat in zip(at, mats):
            pcs = state.preconds[leaf[0]][leaf[1]]
            pcs[dim] = pcs[dim] + mat @ mat.transpose(-1, -2)
        if refresh:
            by_order = {}
            for j, leaf in enumerate(at):
                by_order.setdefault(max(leaf[4].ndim - lead, 1), []).append(j)
            for order, idx in by_order.items():
                factors = [state.preconds[at[j][0]][at[j][1]][dim] for j in idx]
                if members:  # every member's factor of every leaf, one eigh per shape
                    roots = inverse_roots([f for fs in factors for f in fs.unbind(0)], order)
                    per = len(roots) // len(idx)
                    roots = [torch.stack(roots[r * per:(r + 1) * per])
                             for r in range(len(idx))]
                else:
                    roots = inverse_roots(factors, order)
                for j, root in zip(idx, roots):
                    state.inv_preconds[at[j][0]][at[j][1]][dim] = root
        for leaf, mat in zip(at, mats):
            inv = state.inv_preconds[leaf[0]][leaf[1]][dim]
            leaf[4] = _unmatricize(inv @ mat, dim, leaf[4].shape, lead)
    for i, k, p, g_blend, g in leaves:
        if graft_norm:
            gn = torch.sqrt(_sq_norm(g_blend, lead))
            pn = torch.sqrt(_sq_norm(g, lead))
            g = g * (gn / torch.clamp(pn, min=1e-16))
        state.momentum_buf[i][k] = g.contiguous()
        p.sub_(lr * g)
    state.count += 1
    return params, state
