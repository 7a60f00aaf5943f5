"""Quantization (counterpart of implicit_image_tpu/quant/__init__.py):
k-means codebooks, at one width or per layer (`bits_per_layer`, which the
bit allocation of quant/allocate.py fills), and the progressive container's
base-codebook finetune (quant/base_layer.py). QAT / uniform fake-quant are
not ported yet (ROADMAP.md)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from implicit_image_tpu_torch.quant.kmeans import (
    LayerCodebook,
    ecvq_refine,
    kmeans_fit,
    quantize_weight,
)

__all__ = [
    "QuantConfig",
    "LayerCodebook",
    "kmeans_fit",
    "quantize_weight",
    "ecvq_refine",
    "convert",
    "dequantize",
    "quantized_layer_indices",
]


@dataclass(frozen=True)
class QuantConfig:
    """The k-means fields of the JAX QuantConfig (conf/quant/kmeans.yaml)."""

    name: str = "KMeans"
    bits: int = 8
    num_steps: int = 100
    lloyd_iters: int = 5
    ecvq_lambda: float = 0.0
    ecvq_iters: int = 10
    skip_layers: Optional[Tuple[int, ...]] = None
    lr: Optional[float] = None
    bits_per_layer: Optional[Tuple[Optional[int], ...]] = None
    row_stride: int = 1

    def __post_init__(self):
        if self.name != "KMeans":
            raise NotImplementedError(
                f"quant={self.name} is not ported yet (ROADMAP.md); use quant=kmeans"
            )
        if int(self.row_stride) < 1:
            raise ValueError(f"quant.row_stride must be >= 1, got {self.row_stride}")
        if self.bits_per_layer is not None and not all(
            b is None or 2 <= int(b) <= 16 for b in self.bits_per_layer
        ):
            raise ValueError(f"quant.bits_per_layer out of range: {self.bits_per_layer}")

    def layer_bits(self, i: int) -> int:
        """Codebook bits for params-layer i."""
        bpl = self.bits_per_layer
        if bpl is not None and i < len(bpl) and bpl[i] is not None:
            return int(bpl[i])
        return self.bits


def quantized_layer_indices(params, cfg: QuantConfig) -> List[int]:
    """Weight-bearing layers subject to quantization: all but the first and
    last (or cfg.skip_layers), and none with fewer weights than codebook
    entries."""
    widx = [i for i, layer in enumerate(params) if "w" in layer]
    if cfg.skip_layers is not None:
        skip = set(cfg.skip_layers)
    else:
        skip = {widx[0], widx[-1]} if widx else set()
    skip |= {i for i in widx if params[i]["w"].numel() < 2 ** cfg.layer_bits(i)}
    return [i for i in widx if i not in skip]


def convert(params, cfg: QuantConfig):
    """Snap every quantized layer to its codebook; returns (snapped params,
    codebooks) with codebooks[i] None for layers kept full precision."""
    qidx = set(quantized_layer_indices(params, cfg))
    out, books = [], []
    for i, layer in enumerate(params):
        if i in qidx:
            snapped, book = quantize_weight(layer["w"], cfg.layer_bits(i), cfg.lloyd_iters)
            out.append({**layer, "w": snapped})
            books.append(book)
        else:
            out.append(layer)
            books.append(None)
    return tuple(out), tuple(books)


def dequantize(labels: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """weight = centroids[labels]."""
    return centroids[labels.long()]
