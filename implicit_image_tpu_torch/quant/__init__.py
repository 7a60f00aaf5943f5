"""Quantization (counterpart of implicit_image_tpu/quant/__init__.py):
k-means codebooks, at one width or per layer (`bits_per_layer`, which the
bit allocation of quant/allocate.py fills), QAT's uniform fake-quant
(quant/uniform.py: per channel, fbgemm's default, or per tensor,
`qscheme`), and the progressive container's base-codebook finetune
(quant/base_layer.py)."""
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
from implicit_image_tpu_torch.quant.uniform import (
    ObserverState,
    PerChannelCodebook,
    fake_quant,
    fake_quant_per_channel,
    observe_minmax,
    per_channel_quantize_weight,
    uniform_quantize_weight,
)

__all__ = [
    "QuantConfig",
    "LayerCodebook",
    "PerChannelCodebook",
    "ObserverState",
    "observe_minmax",
    "kmeans_fit",
    "quantize_weight",
    "ecvq_refine",
    "uniform_quantize_weight",
    "per_channel_quantize_weight",
    "fake_quant",
    "fake_quant_per_channel",
    "quantize_params",
    "convert",
    "dequantize",
    "quantized_layer_indices",
]


@dataclass(frozen=True)
class QuantConfig:
    """The JAX QuantConfig's fields (conf/quant/{kmeans,qat}.yaml) but
    log_steps, which the port does not log by."""

    name: str = "KMeans"  # "KMeans" | "QAT"
    bits: int = 8
    num_steps: int = 100
    lloyd_iters: int = 5
    ecvq_lambda: float = 0.0
    ecvq_iters: int = 10
    skip_layers: Optional[Tuple[int, ...]] = None
    lr: Optional[float] = None
    bits_per_layer: Optional[Tuple[Optional[int], ...]] = None
    row_stride: int = 1
    # QAT's weight scheme: "per_channel" (fbgemm's default) | "per_tensor"
    qscheme: str = "per_channel"

    def __post_init__(self):
        if self.name not in ("KMeans", "QAT"):
            raise ValueError(f"quant.name must be KMeans or QAT, got {self.name!r}")
        if self.qscheme not in ("per_channel", "per_tensor"):
            raise ValueError(f"quant.qscheme must be per_channel or per_tensor, "
                             f"got {self.qscheme!r}")
        if self.bits_per_layer is not None and self.name != "KMeans":
            raise ValueError("quant.bits_per_layer is KMeans-only")
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


def _snap(weight: torch.Tensor, cfg: QuantConfig, i: int):
    bits = cfg.layer_bits(i)
    if cfg.name == "KMeans":
        return quantize_weight(weight, bits, cfg.lloyd_iters)
    if cfg.qscheme == "per_channel":
        return per_channel_quantize_weight(weight, bits)
    return uniform_quantize_weight(weight, bits)


def quantize_params(params, cfg: QuantConfig):
    """Every quantized layer's weight snapped to its codebook (the QAT
    finetune's forward, each step)."""
    qidx = set(quantized_layer_indices(params, cfg))
    return tuple({**layer, "w": _snap(layer["w"], cfg, i)[0]} if i in qidx else layer
                 for i, layer in enumerate(params))


def convert(params, cfg: QuantConfig):
    """Snap every quantized layer to its codebook; returns (snapped params,
    codebooks) with codebooks[i] None for layers kept full precision: a
    LayerCodebook (k-means, per-tensor QAT) or a PerChannelCodebook."""
    qidx = set(quantized_layer_indices(params, cfg))
    out, books = [], []
    for i, layer in enumerate(params):
        if i in qidx:
            snapped, book = _snap(layer["w"], cfg, i)
            out.append({**layer, "w": snapped})
            books.append(book)
        else:
            out.append(layer)
            books.append(None)
    return tuple(out), tuple(books)


def dequantize(labels: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """weight = centroids[labels]."""
    return centroids[labels.long()]
