"""SIREN — sine-activation coordinate MLP (counterpart of
implicit_image_tpu/models/siren.py).

Params keep the JAX package's layout: a tuple of {"w": (fan_in, fan_out),
"b": (fan_out,)} dicts, so the tests compare like with like and weights
copy across unchanged (convert.py). Init bounds are the reference's:
  * first layer weights  ~ U(±1/fan_in)
  * hidden layer weights ~ U(±sqrt(6/fan_in)/ω₀)
  * biases ~ U(±1/sqrt(fan_in))
drawn from an explicit torch.Generator (so they differ from what
jax.random draws for the same seed — tests copy weights instead).

The forward with the polynomial sine (the default) runs through the fused
chain of ops/sine_mlp.py: the CUDA kernels for a CUDA tensor, the plain
chain for a CPU tensor. `mlp.fast_sine=false` asks for the exact sine
(JAX's `jnp.sin` path, XLA there): a plain torch chain with `torch.sin`
and autograd, on either device, in every precision mode (ops/precision.py);
the kernels carry the polynomial only, so such a run launches none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from implicit_image_tpu_torch.ops.precision import matmul, maybe_cast, modes
from implicit_image_tpu_torch.ops.sine_mlp import (
    siren_apply_flat_batched_fused,
    siren_apply_flat_fused,
)

__all__ = ["SirenConfig", "init_siren", "siren_apply", "siren_apply_flat",
           "siren_apply_flat_members", "siren_apply_members"]

Params = Tuple[dict, ...]


@dataclass(frozen=True)
class SirenConfig:
    """Static architecture config (defaults mirror conf/mlp/siren.yaml)."""

    input_size: int = 2
    output_size: int = 3
    depth: int = 8
    hidden_size: int = 128
    first_omega_0: float = 50.0
    hidden_omega_0: float = 30.0
    outermost_linear: bool = True
    small_dense_density: float = 1.0
    fast_sine: bool = True

    @property
    def effective_hidden(self) -> int:
        # Small-Dense width compensation: hidden_size * sqrt(density)
        return int(self.hidden_size * math.sqrt(self.small_dense_density))

    @property
    def layer_dims(self) -> Sequence[Tuple[int, int]]:
        h = self.effective_hidden
        return [(self.input_size, h)] + [(h, h)] * (self.depth - 2) + [(h, self.output_size)]

    @property
    def omegas(self) -> Sequence[float]:
        return [self.first_omega_0] + [self.hidden_omega_0] * (self.depth - 1)

    def weight_bound(self, layer: int) -> float:
        fan_in = self.layer_dims[layer][0]
        if layer == 0:
            return 1.0 / fan_in
        return math.sqrt(6.0 / fan_in) / self.omegas[layer]


def init_siren(generator: torch.Generator, cfg: SirenConfig, device="cpu") -> Params:
    """SIREN initialization with the reference's exact bounds; numbers are
    drawn on the CPU from `generator`, then moved to `device`."""
    params = []
    for layer, (fan_in, fan_out) in enumerate(cfg.layer_dims):
        wb = cfg.weight_bound(layer)
        bb = 1.0 / math.sqrt(fan_in)
        w = (torch.rand((fan_in, fan_out), generator=generator) * 2.0 - 1.0) * wb
        b = (torch.rand((fan_out,), generator=generator) * 2.0 - 1.0) * bb
        params.append({"w": w.to(device), "b": b.to(device)})
    return tuple(params)


def siren_apply_flat(
    params: Params, coords: torch.Tensor, cfg: SirenConfig, precision: str = "fp32"
) -> torch.Tensor:
    """Forward over flat coordinates (N, input_size) in [0, 1] ->
    (N, output_size): input mapped to [-1, 1], output mapped back by
    x/2 + 0.5. `precision` is the kernel mode ("fp32" | "bf16", either
    with "+mixed")."""
    if not cfg.fast_sine:
        return _siren_apply_flat_exact(params, coords, cfg, precision)
    return siren_apply_flat_fused(params, coords, cfg, precision)


def _siren_apply_flat_exact(params: Params, coords: torch.Tensor, cfg: SirenConfig,
                            precision: str) -> torch.Tensor:
    """The chain with torch.sin (mlp.fast_sine=false), as the JAX package's
    siren_apply_flat computes it: under "+mixed" x, W, b and each
    activation cast to bf16; "bf16" products in one bf16 pass."""
    bf16, mixed = modes(precision)
    x = maybe_cast((coords - 0.5) * 2.0, mixed)
    last = len(params) - 1
    for i, layer in enumerate(params):
        x = matmul(x, maybe_cast(layer["w"], mixed), bf16) + maybe_cast(layer["b"], mixed)
        if not (i == last and cfg.outermost_linear):
            x = torch.sin(cfg.omegas[i] * x)
        if i != last:
            x = maybe_cast(x, mixed)
    return x / 2.0 + 0.5


def siren_apply(
    params: Params, grid: torch.Tensor, cfg: SirenConfig, precision: str = "fp32"
) -> torch.Tensor:
    """Forward over an (H, W, input_size) grid -> (H, W, output_size)."""
    h, w, c = grid.shape
    return siren_apply_flat(params, grid.reshape(h * w, c), cfg, precision).reshape(h, w, -1)


def siren_apply_flat_members(params: Params, coords: torch.Tensor, cfg: SirenConfig,
                             precision: str = "fp32") -> torch.Tensor:
    """The member-axis forward: params whose leaves carry a leading member
    axis, over flat coords (N, in) -> (M, N, out), differentiable. With the
    polynomial sine one K1 (forward) and one K2 (backward) launch over the
    member axis on the card (ops.sine_mlp.SineMLPBatchedFunction), each
    member the bits of its own chain; with the exact sine torch.func.vmap of
    the torch.sin chain."""
    if cfg.fast_sine:
        return siren_apply_flat_batched_fused(params, coords, cfg, precision)
    return torch.func.vmap(lambda p: _siren_apply_flat_exact(p, coords, cfg, precision))(params)


def siren_apply_members(params: Params, grid: torch.Tensor, cfg: SirenConfig,
                        precision: str = "fp32") -> torch.Tensor:
    """siren_apply_flat_members over an (H, W, in) grid -> (M, H, W, out)."""
    h, w, c = grid.shape
    out = siren_apply_flat_members(params, grid.reshape(h * w, c), cfg, precision)
    return out.reshape(out.shape[0], h, w, -1)
