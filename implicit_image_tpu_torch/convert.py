"""Params exchange between the JAX package's layout and torch tensors.

Both packages keep params as a tuple of per-layer dicts,
`{"w": (fan_in, fan_out), "b": (fan_out,)}` (implicit_image_tpu/models/
siren.py). These helpers move such a tuple between numpy arrays (what the
JAX package hands out via `np.asarray`) and torch tensors on a device, and
read a JAX training checkpoint into the port's state.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy", "checkpoint_from_jax"]


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


def checkpoint_from_jax(path, device="cpu"):
    """A JAX package's `checkpoint.npz` -> the port's training state: {"step",
    "params", "opt_state", for a sparse fit "mask_state" and for an EKFAC
    fit "ekfac_state" (an optim.ekfac.EkfacState)}, tensors on
    `device` (training/checkpoint.py reads both packages' files: they share
    their key names). The JAX PRNG key does not carry over; a fit resumed
    from it draws from the generator it is given."""
    from implicit_image_tpu_torch.training.checkpoint import load_checkpoint

    return load_checkpoint(path, device)
