"""Params exchange between the JAX package's layout and torch tensors.

Both packages keep params as a tuple of per-layer dicts,
`{"w": (fan_in, fan_out), "b": (fan_out,)}` (implicit_image_tpu/models/
siren.py). These helpers move such a tuple between numpy arrays (what the
JAX package hands out via `np.asarray`) and torch tensors on a device, an
optimizer state between the packages, and read a JAX training checkpoint
into the port's state. A fit over a member axis (the JAX package's jax.vmap,
the port's parallel/batched.py) keeps the same trees with a leading member
axis on every leaf, so the stacked params of a batched fit (a hashgrid's
tables too) and its stacked optimizer state convert with the same helpers.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy", "opt_state_from_jax", "checkpoint_from_jax"]


def params_from_jax(
    np_params: Sequence[dict], device, dtype: torch.dtype = torch.float32
) -> Tuple[dict, ...]:
    """numpy (or array-like) params tuple -> torch tensors on `device`."""
    return tuple(
        {
            k: torch.as_tensor(np.array(v), dtype=dtype).to(device)
            for k, v in layer.items()
        }
        for layer in np_params
    )


def params_to_numpy(params: Sequence[dict]) -> Tuple[dict, ...]:
    """torch params tuple -> numpy arrays (on the host)."""
    return tuple(
        {k: v.detach().cpu().numpy() for k, v in layer.items()}
        for layer in params
    )


def opt_state_from_jax(state, device="cpu"):
    """A JAX package's optimizer state -> the port's on `device`: Adam's
    (mu, nu) as an optim.adam.AdamState, Shampoo's (momentum buffers, Gram
    factors and their inverse roots per trainable leaf) as an
    optim.shampoo.ShampooState, or EKFAC's bases and moments as an
    optim.ekfac.EkfacState; one fit's, or M fits' stacked by jax.vmap (each
    leaf and factor with a leading member axis: then pass `members=True` to
    the port's update). The step count, a scalar in JAX (a member-axis vector
    of one value under vmap), is a Python int here."""
    from implicit_image_tpu_torch.optim.adam import TRAINABLE_KEYS, AdamState
    from implicit_image_tpu_torch.optim.ekfac import EkfacState
    from implicit_image_tpu_torch.optim.shampoo import ShampooState

    def t(x):
        return torch.as_tensor(np.array(x), dtype=torch.float32).to(device)

    if hasattr(state, "ua"):
        return EkfacState(*(tuple(t(x) for x in part) for part in state))
    counts = np.unique(np.asarray(state.count))
    if counts.size != 1:
        raise ValueError(f"the members are at different step counts {counts.tolist()}")
    count = int(counts[0])
    if hasattr(state, "preconds"):
        def leaves(tree, f):
            return tuple({k: f(v) for k, v in layer.items() if k in TRAINABLE_KEYS}
                         for layer in tree)

        return ShampooState(momentum_buf=leaves(state.momentum_buf, t),
                            preconds=leaves(state.preconds, lambda v: [t(m) for m in v]),
                            inv_preconds=leaves(state.inv_preconds, lambda v: [t(m) for m in v]),
                            count=count)
    return AdamState(mu=params_from_jax(state.mu, device), nu=params_from_jax(state.nu, device),
                     count=count)


def checkpoint_from_jax(path, device="cpu"):
    """A JAX package's `checkpoint.npz` -> the port's training state: {"step",
    "params", "opt_state", for a sparse fit "mask_state" and for an EKFAC
    fit "ekfac_state" (an optim.ekfac.EkfacState)}, tensors on
    `device` (training/checkpoint.py reads both packages' files: they share
    their key names). The JAX PRNG key does not carry over; a fit resumed
    from it draws from the generator it is given."""
    from implicit_image_tpu_torch.training.checkpoint import load_checkpoint

    return load_checkpoint(path, device)
