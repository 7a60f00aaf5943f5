"""Fourier-feature positional-encoding MLP (counterpart of
implicit_image_tpu/models/fourier.py):

  * a frozen random encoding B ~ N(0, 1) * map_scale of shape
    (input_size, map_size // 2), stored as params layer 0, {"B": B}: it is
    part of the container, but no gradient, optimizer step or mask reaches
    it (optim.adam.TRAINABLE_KEYS);
  * encoding(x) = [sin(2πx B), cos(2πx B)] with torch.sin / torch.cos, as
    the JAX package uses jnp.sin / jnp.cos (not the polynomial sine);
  * a ReLU MLP of depth - 1 linear layers and a sigmoid output;
  * Small-Dense width scaling by sqrt(density);
  * torch nn.Linear's default init: W, b ~ U(±1/sqrt(fan_in)), drawn from an
    explicit torch.Generator after B.

The products are plain `torch.matmul` (the JAX package computes them
with jnp.dot, outside any Pallas kernel), in every precision mode of the
fit, as CoordX's (ops/precision.py): "fp32" true fp32 (on the card a CUDA
forward raises while `torch.backends.cuda.matmul.allow_tf32` is set, rather
than run 1-pass TF32); "bf16" one bf16 pass per product, the encoding's
too; "+mixed" the JAX package's casts: the encoding, each W and b, and each
hidden activation rounded to bf16 (the products exact in fp32, the
sigmoid in fp32).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from implicit_image_tpu_torch.ops import check_fp32
from implicit_image_tpu_torch.ops.precision import matmul, maybe_cast, modes

__all__ = ["FourierConfig", "init_fourier", "fourier_apply", "fourier_apply_flat"]


@dataclass(frozen=True)
class FourierConfig:
    """Static architecture config (defaults mirror conf/mlp/fourier.yaml)."""

    input_size: int = 2
    output_size: int = 3
    depth: int = 8
    hidden_size: int = 128
    map_size: int = 256
    map_scale: float = 16.0
    small_dense_density: float = 1.0

    def __post_init__(self):
        assert self.map_size % 2 == 0, "Need even map size"

    @property
    def effective_hidden(self) -> int:
        return int(self.hidden_size * math.sqrt(self.small_dense_density))

    @property
    def layer_dims(self) -> Sequence[Tuple[int, int]]:
        """Dims of the linear layers (params layers 1 ..)."""
        h = self.effective_hidden
        return [(self.map_size, h)] + [(h, h)] * (self.depth - 3) + [(h, self.output_size)]


def init_fourier(generator: torch.Generator, cfg: FourierConfig, device="cpu"):
    """B first, then each linear layer's weights and biases; numbers are
    drawn on the CPU from `generator`, then moved to `device`."""
    b_enc = torch.randn((cfg.input_size, cfg.map_size // 2), generator=generator) * cfg.map_scale
    params = [{"B": b_enc.to(device)}]
    for fan_in, fan_out in cfg.layer_dims:
        bound = 1.0 / math.sqrt(fan_in)
        w = (torch.rand((fan_in, fan_out), generator=generator) * 2.0 - 1.0) * bound
        b = (torch.rand((fan_out,), generator=generator) * 2.0 - 1.0) * bound
        params.append({"w": w.to(device), "b": b.to(device)})
    return tuple(params)


def fourier_apply_flat(params, coords: torch.Tensor, cfg: FourierConfig,
                       precision: str = "fp32") -> torch.Tensor:
    """Forward over flat coordinates (N, input_size) -> (N, output_size)."""
    check_fp32(coords, "mlp=fourier")
    bf16, mixed = modes(precision)
    xp = matmul(2.0 * math.pi * coords, params[0]["B"], bf16)
    x = maybe_cast(torch.cat([torch.sin(xp), torch.cos(xp)], dim=-1), mixed)
    layers = params[1:]
    for i, layer in enumerate(layers):
        x = matmul(x, maybe_cast(layer["w"], mixed), bf16) + maybe_cast(layer["b"], mixed)
        if i < len(layers) - 1:
            x = maybe_cast(torch.relu(x), mixed)
    return torch.sigmoid(x)


def fourier_apply(params, grid: torch.Tensor, cfg: FourierConfig,
                  precision: str = "fp32") -> torch.Tensor:
    h, w, c = grid.shape
    return fourier_apply_flat(params, grid.reshape(h * w, c), cfg, precision).reshape(h, w, -1)
