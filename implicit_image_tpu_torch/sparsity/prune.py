"""Prune functions (counterpart of implicit_image_tpu/sparsity/prune.py).

Rank-based, as in the JAX package: the k smallest scores go, where k is a
0-d float32 tensor that stays on the device (no host read). Ranks come from
a stable argsort, like `jnp.argsort`, so tied scores (every masked-out entry
scores -1) fall in index order in both packages. Counts are float32 tensors
computed as the JAX functions compute them, `ceil(prune_rate · nonzeros)`
included, and ranks are compared against them in float32.

  * magnitude_prune: zero the k = zeros + ceil(rate·nonzeros) smallest |w|;
  * global_magnitude_prune: the exact global top-k over all masked layers;
  * struct_magnitude_prune: whole (h, w) kernels of a 4-D tensor.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = [
    "ranks_ascending",
    "ranks_descending",
    "magnitude_prune",
    "global_magnitude_prune",
    "struct_magnitude_prune",
    "registry_names",
]

registry_names = (
    "magnitude",
    "global-magnitude",
    "struct-magnitude-max",
    "struct-magnitude-mean",
)


def ranks_ascending(x: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of x[i] in the ascending sort (ties by index)."""
    flat = x.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(flat.numel(), device=flat.device)
    return ranks.reshape(x.shape)


def ranks_descending(x: torch.Tensor) -> torch.Tensor:
    return ranks_ascending(-x)


def magnitude_prune(mask: torch.Tensor, weight: torch.Tensor, prune_rate: torch.Tensor,
                    nonzeros: torch.Tensor) -> torch.Tensor:
    """Layer-wise magnitude pruning: the k = zeros + ceil(prune_rate ·
    nonzeros) smallest-|w| positions are zeroed; masked-out entries score -1
    so they take the lowest ranks."""
    num_remove = torch.ceil(prune_rate * nonzeros)
    k = (mask.numel() - nonzeros) + num_remove
    scores = torch.where(mask > 0, weight.abs(), -1.0)
    return mask * (ranks_ascending(scores) >= k).to(mask.dtype)


def global_magnitude_prune(
    masks: Sequence[Optional[torch.Tensor]],
    weights: Sequence[torch.Tensor],
    prune_rate: torch.Tensor,
    baseline_nonzero: torch.Tensor,
) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
    """Exact global magnitude pruning across all masked layers: the
    ceil(prune_rate · baseline_nonzero) globally smallest |w| go. Returns
    (new masks, total removed)."""
    live = [i for i, m in enumerate(masks) if m is not None]
    scores = torch.cat([
        torch.where(masks[i] > 0, weights[i].abs(), -1.0).reshape(-1) for i in live
    ])
    total_nonzero = torch.stack([masks[i].sum() for i in live]).sum()
    keep_k = total_nonzero - torch.ceil(prune_rate * baseline_nonzero)
    keep = (ranks_descending(scores) < keep_k).to(torch.float32)

    new_masks: List[Optional[torch.Tensor]] = list(masks)
    offset = 0
    for i in live:
        n = masks[i].numel()
        new_masks[i] = masks[i] * keep[offset:offset + n].reshape(masks[i].shape)
        offset += n
    total_removed = total_nonzero - torch.stack([new_masks[i].sum() for i in live]).sum()
    return new_masks, total_removed


def struct_magnitude_prune(mask: torch.Tensor, weight: torch.Tensor, prune_rate: torch.Tensor,
                           nonzeros: torch.Tensor, criterion: str = "mean") -> torch.Tensor:
    """Channel-structured magnitude pruning of a 4-D (c_in, c_out, h, w)
    tensor: each kernel reduces to one score and the k smallest kernels go."""
    if weight.ndim != 4:
        raise ValueError("struct pruning requires 4D kernels")
    c_in, c_out, h, w = weight.shape
    kernel_size = h * w
    red = weight.abs().reshape(c_in * c_out, kernel_size)
    if criterion == "mean":
        scores = red.mean(-1)
    elif criterion == "max":
        scores = red.amax(-1)
    else:
        raise KeyError(criterion)
    kernel_live = mask.reshape(c_in * c_out, kernel_size).sum(-1) > 0
    scores = torch.where(kernel_live, scores, -1.0)
    num_remove = torch.ceil(prune_rate * nonzeros / kernel_size)
    k = ((c_in * c_out) - kernel_live.sum()) + num_remove
    keep = (ranks_ascending(scores) >= k).to(mask.dtype).reshape(c_in, c_out, 1, 1)
    return mask * keep
