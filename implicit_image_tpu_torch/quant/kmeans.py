"""K-means codebook quantization (counterpart of
implicit_image_tpu/quant/kmeans.py).

Same algorithm and the same operation order as the JAX functions: cluster
the nonzero weights into 2^bits - 1 centroids with Lloyd's iterations from
a linspace init, prepend a 0 centroid, sort by |c| (stable, like
jnp.argsort), assign every weight. The JAX one-hot matmuls / segment sums
become `segment_sum`, a masked column sum: a plain reduction, so the same
inputs give the same bits on every run, on the card too (`index_add_` adds
with atomics on CUDA and does not). Sums run in another order than XLA's:
in float64 the two packages agree to rounding; in float32 a weight lying
almost exactly between two centroids may take the other label.

`gather_centroids` is `centroids[labels]` whose gradient is that segment
sum (the default backward of the gather accumulates with atomics on CUDA).

`ecvq_refine` is the entropy-constrained re-assignment (quant.ecvq_lambda).

Delta mode (quant.delta, the `offset` argument): cluster the residual
weight - offset, where the offset (the meta-init artifact's weight) is
shared by encoder and decoder. The decode rule is
w = (offset + centroids[labels]) * (labels != 0): label 0 stays reserved
for pruned (zero) weights, so a nonzero weight never takes it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from implicit_image_tpu_torch.data import unit_linspace

__all__ = [
    "LayerCodebook",
    "segment_sum",
    "gather_centroids",
    "kmeans_fit",
    "quantize_weight",
    "ecvq_refine",
]


class LayerCodebook(NamedTuple):
    centroids: torch.Tensor  # (k,), centroids[0] == 0
    labels: torch.Tensor  # weight-shaped int32


def segment_sum(index: torch.Tensor, values: torch.Tensor, k: int) -> torch.Tensor:
    """out[j] = sum of values[i] over index[i] == j, for j < k (1-D inputs):
    the JAX functions' `one_hot(index, k).T @ values`, as a column sum."""
    hit = index[:, None] == torch.arange(k, device=index.device)
    return torch.where(hit, values[:, None], values.new_zeros(())).sum(0)


class _GatherCentroids(torch.autograd.Function):
    @staticmethod
    def forward(ctx, centroids, labels):
        ctx.save_for_backward(labels)
        ctx.k = centroids.shape[0]
        return centroids[labels]

    @staticmethod
    def backward(ctx, g):
        (labels,) = ctx.saved_tensors
        return segment_sum(labels.reshape(-1), g.reshape(-1), ctx.k), None


def gather_centroids(centroids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """centroids[labels] (labels int64, any shape); each centroid's gradient
    is the segment sum of the output's gradient over its cluster."""
    return _GatherCentroids.apply(centroids, labels)


def kmeans_fit(values: torch.Tensor, valid: torch.Tensor, centers: torch.Tensor,
               iters: int = 5) -> torch.Tensor:
    """Weighted 1-D Lloyd's algorithm with a fixed iteration count; invalid
    points (valid == 0) do not pull centroids, empty clusters keep theirs."""
    k = centers.shape[0]
    for _ in range(iters):
        d = (values[:, None] - centers[None, :]) ** 2
        assign = torch.argmin(d, dim=1)
        counts = segment_sum(assign, valid, k)
        sums = segment_sum(assign, values * valid, k)
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
    return centers


def _reserve_label0(d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Delta mode: a valid weight may not take label 0, a pruned one must."""
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    col0 = torch.where(valid > 0, inf, -inf)
    return torch.cat([col0[:, None], d[:, 1:]], dim=1)


def quantize_weight(weight: torch.Tensor, bits: int, iters: int = 5,
                    offset: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, LayerCodebook]:
    """Cluster a weight tensor's nonzeros (their residuals against `offset`
    in delta mode) into 2^bits - 1 centroids (+0); returns (snapped weight,
    LayerCodebook)."""
    n_clusters = 2**bits - 1
    flat = weight.reshape(-1)
    valid = (flat != 0.0).to(flat.dtype)
    if offset is not None:
        points = torch.where(valid > 0, flat - offset.reshape(-1), flat.new_zeros(()))
    else:
        points = flat
    big = torch.tensor(float("inf"), dtype=flat.dtype, device=flat.device)
    lo = torch.min(torch.where(valid > 0, points, big))
    hi = torch.max(torch.where(valid > 0, points, -big))
    guess = unit_linspace(n_clusters, flat.device, flat.dtype) * (hi - lo) + lo

    centers = kmeans_fit(points, valid, guess, iters=iters)
    centroids = torch.cat([torch.zeros(1, dtype=flat.dtype, device=flat.device), centers])
    order = torch.argsort(torch.abs(centroids), stable=True)
    centroids = centroids[order]

    d = (points[:, None] - centroids[None, :]) ** 2
    if offset is not None:
        d = _reserve_label0(d, valid)
    labels = torch.argmin(d, dim=1).to(torch.int32)
    snapped = centroids[labels]
    if offset is not None:
        snapped = (snapped + offset.reshape(-1)) * (labels != 0)
    snapped = snapped.reshape(weight.shape)
    return snapped, LayerCodebook(centroids=centroids, labels=labels.reshape(weight.shape))


def ecvq_refine(weight: torch.Tensor, book: LayerCodebook, lam: float,
                iters: int = 10, offset: Optional[torch.Tensor] = None) -> LayerCodebook:
    """Entropy-constrained assignment: re-assign each nonzero weight to
    argmin_j (w - c_j)^2 + λ·σ²·R_j, R_j = -log2 p_j under the current label
    frequencies, σ² the layer's mean initial quantization error; then a
    Lloyd step on the new assignment. Label 0 (the zero centroid) stays 0.
    In delta mode (`offset`) it runs on the residuals, and a nonzero weight
    never moves onto label 0."""
    flat = weight.reshape(-1)
    labels = book.labels.reshape(-1).long()
    centroids = book.centroids
    valid = (flat != 0.0).to(flat.dtype)
    if offset is not None:
        flat = torch.where(valid > 0, flat - offset.reshape(-1), flat.new_zeros(()))
    n = flat.shape[0]
    n_valid = torch.clamp(torch.sum(valid), min=1.0)
    k = centroids.shape[0]

    err0 = torch.sum(valid * (flat - centroids[labels]) ** 2)
    scale = lam * err0 / n_valid
    ones = torch.ones_like(flat)
    for _ in range(iters):
        p = segment_sum(labels, ones, k) / n
        rate = -torch.log2(torch.clamp(p, min=1e-12))
        d2 = (flat[:, None] - centroids[None, :]) ** 2
        if offset is not None:
            d2 = _reserve_label0(d2, valid)
        new = torch.argmin(d2 + scale * rate[None, :], dim=1)
        labels = torch.where(valid > 0, new, torch.zeros_like(new))
        counts_nz = segment_sum(labels, valid, k)
        sums = segment_sum(labels, flat * valid, k)
        centroids = torch.where(counts_nz > 0, sums / torch.clamp(counts_nz, min=1.0),
                                centroids)
        centroids = torch.cat([centroids.new_zeros(1), centroids[1:]])
    return LayerCodebook(centroids=centroids,
                         labels=labels.to(torch.int32).reshape(weight.shape))
