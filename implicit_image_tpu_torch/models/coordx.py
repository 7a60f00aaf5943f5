"""CoordX — split coordinate-MLP (counterpart of
implicit_image_tpu/models/coordx.py; Liang et al., ICLR 2022,
arXiv:2201.12425).

The early layers are factorized over the coordinate axes: each 1-D branch
embeds one coordinate with SIREN-style sine layers, O(H + W) work; the
branch features are fused elementwise (product, scaled by √2 to restore
SIREN's activation statistics, or sum); only the late layers run per pixel.

Params keep the JAX package's layout, one flat tuple of {"w": (fan_in,
fan_out), "b": (fan_out,)} dicts: x-branch × split_depth, y-branch ×
split_depth, then the fused layers. Init bounds per layer are SIREN's
(each branch's first layer U(±1/fan_in), the others U(±√(6/fan_in)/ω),
biases U(±1/√fan_in)), drawn from an explicit torch.Generator.

`coordx_apply` needs a tensor-product (H, W, 2) grid, what data.get_grid
makes; `coordx_apply_flat` takes any (N, 2) coordinates. A branch's first
layer has fan_in 1 and is a broadcast multiply, not a product.

The products are plain `torch.matmul` (the JAX package runs CoordX in XLA,
outside any Pallas kernel): fp32, or under "bf16" (train.matmul_precision
bfloat16 or null) one bf16 pass, operands rounded and fp32 accumulation,
in the forward and the backward (ops/precision.py). On the card they must
never be 1-pass TF32: with `torch.backends.cuda.matmul.allow_tf32` set, a
CUDA forward raises. "+mixed" (train.mixed_precision) casts the inputs,
weights, biases and activations to bf16 where the JAX package's
coordx.py does (a branch's fan_in-1 layer and the fusion then compute in
bf16: each of their ops rounds).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from implicit_image_tpu_torch.ops import check_fp32
from implicit_image_tpu_torch.ops.fast_math import fast_sin
from implicit_image_tpu_torch.ops.precision import matmul, maybe_cast, modes

__all__ = ["CoordXConfig", "init_coordx", "coordx_apply", "coordx_apply_flat"]

Params = Tuple[dict, ...]


@dataclass(frozen=True)
class CoordXConfig:
    """Static architecture config (conf/mlp/coordx.yaml). depth counts
    split_depth branch layers + (depth - split_depth - 1) fused hidden
    layers + 1 output layer."""

    input_size: int = 2
    output_size: int = 3
    depth: int = 8
    hidden_size: int = 128
    split_depth: int = 3
    first_omega_0: float = 50.0
    hidden_omega_0: float = 30.0
    outermost_linear: bool = True
    small_dense_density: float = 1.0
    fast_sine: bool = True
    fusion: str = "product"  # "product" | "sum"

    def __post_init__(self):
        if self.input_size != 2:
            raise ValueError("CoordX factorizes 2-D (row, col) grids")
        if not 1 <= self.split_depth <= self.depth - 2:
            raise ValueError("need at least one fused hidden layer and the output layer")
        if self.fusion not in ("product", "sum"):
            raise ValueError(f"mlp.fusion must be 'product' or 'sum', got {self.fusion!r}")

    @property
    def effective_hidden(self) -> int:
        # Small-Dense width compensation: hidden_size * sqrt(density)
        return int(self.hidden_size * math.sqrt(self.small_dense_density))

    @property
    def n_fused_hidden(self) -> int:
        return self.depth - self.split_depth - 1

    @property
    def branch_dims(self) -> Sequence[Tuple[int, int]]:
        h = self.effective_hidden
        return [(1, h)] + [(h, h)] * (self.split_depth - 1)

    @property
    def fused_dims(self) -> Sequence[Tuple[int, int]]:
        h = self.effective_hidden
        return [(h, h)] * self.n_fused_hidden + [(h, self.output_size)]

    @property
    def layer_dims(self) -> Sequence[Tuple[int, int]]:
        """Dims of each params entry: x-branch, y-branch, fused."""
        return list(self.branch_dims) * 2 + list(self.fused_dims)

    def weight_bound(self, flat_layer: int) -> float:
        fan_in, _ = self.layer_dims[flat_layer]
        if flat_layer in (0, self.split_depth):  # first layer of each branch
            return 1.0 / fan_in
        return math.sqrt(6.0 / fan_in) / self.hidden_omega_0


def init_coordx(generator: torch.Generator, cfg: CoordXConfig, device="cpu") -> Params:
    """CoordX initialization; numbers are drawn on the CPU from `generator`
    (each layer's weights, then its biases), then moved to `device`."""
    params = []
    for i, (fan_in, fan_out) in enumerate(cfg.layer_dims):
        wb = cfg.weight_bound(i)
        bb = 1.0 / math.sqrt(fan_in)
        w = (torch.rand((fan_in, fan_out), generator=generator) * 2.0 - 1.0) * wb
        b = (torch.rand((fan_out,), generator=generator) * 2.0 - 1.0) * bb
        params.append({"w": w.to(device), "b": b.to(device)})
    return tuple(params)


def _sin(cfg: CoordXConfig):
    return fast_sin if cfg.fast_sine else torch.sin


def _run_branch(params_slice, x: torch.Tensor, cfg: CoordXConfig, bf16: bool = False,
                mixed: bool = False) -> torch.Tensor:
    """x: (N, 1), one coordinate in [-1, 1] -> (N, C) sine features."""
    sin = _sin(cfg)
    x = maybe_cast(x, mixed)
    for i, layer in enumerate(params_slice):
        w, b = maybe_cast(layer["w"], mixed), maybe_cast(layer["b"], mixed)
        omega = cfg.first_omega_0 if i == 0 else cfg.hidden_omega_0
        if w.shape[0] == 1:
            # fan_in 1: a broadcast multiply (in bf16 under mixed precision)
            z = maybe_cast(maybe_cast(x * w[0], mixed) + b, mixed)
            pre = maybe_cast(_scalar(omega, mixed) * z, mixed)
        else:
            pre = omega * (matmul(x, w, bf16) + b)
        x = maybe_cast(sin(pre), mixed)
    return x


def _run_fused(params_slice, z: torch.Tensor, cfg: CoordXConfig, bf16: bool = False,
               mixed: bool = False) -> torch.Tensor:
    """z: (N, C) fused features -> (N, out) in [0, 1]."""
    sin = _sin(cfg)
    last = len(params_slice) - 1
    for i, layer in enumerate(params_slice):
        z = matmul(z, maybe_cast(layer["w"], mixed), bf16) + maybe_cast(layer["b"], mixed)
        if not (i == last and cfg.outermost_linear):
            z = sin(cfg.hidden_omega_0 * z)
        if i != last:
            z = maybe_cast(z, mixed)
    return z / 2.0 + 0.5


def _fuse(fy: torch.Tensor, fx: torch.Tensor, cfg: CoordXConfig,
          mixed: bool = False) -> torch.Tensor:
    # under mixed precision the features are bf16, and so is the scale (a
    # Python float takes the array's type in JAX)
    if cfg.fusion == "product":
        # E[sin²]·E[sin²] ≈ 1/4 against the 1/2 SIREN's init expects
        return maybe_cast(maybe_cast(fy * fx, mixed) * _scalar(math.sqrt(2.0), mixed), mixed)
    return maybe_cast(maybe_cast(fy + fx, mixed) * _scalar(1.0 / math.sqrt(2.0), mixed), mixed)


def _scalar(v: float, mixed: bool) -> float:
    return float(torch.tensor(v).to(torch.bfloat16)) if mixed else v


def _split(params: Params, cfg: CoordXConfig):
    s = cfg.split_depth
    return params[:s], params[s : 2 * s], params[2 * s :]


def coordx_apply(params: Params, grid: torch.Tensor, cfg: CoordXConfig,
                 precision: str = "fp32") -> torch.Tensor:
    """Factorized forward over a tensor-product (H, W, 2) grid ->
    (H, W, out): the row coordinate is read from grid[:, 0, 0], the column
    coordinate from grid[0, :, 1]; only the fused layers run per pixel."""
    check_fp32(grid, "mlp=coordx")
    bf16, mixed = modes(precision)
    h, w, _ = grid.shape
    px, py, pf = _split(params, cfg)
    ys = (grid[:, 0, 0:1] - 0.5) * 2.0  # (H, 1) row coordinate
    xs = (grid[0, :, 1:2] - 0.5) * 2.0  # (W, 1) column coordinate
    fy = _run_branch(py, ys, cfg, bf16, mixed)  # (H, C)
    fx = _run_branch(px, xs, cfg, bf16, mixed)  # (W, C)
    z = _fuse(fy[:, None, :], fx[None, :, :], cfg, mixed).reshape(h * w, -1)
    return _run_fused(pf, z, cfg, bf16, mixed).reshape(h, w, -1)


def coordx_apply_flat(params: Params, coords: torch.Tensor, cfg: CoordXConfig,
                      precision: str = "fp32") -> torch.Tensor:
    """Forward over any (N, 2) coordinates in [0, 1] -> (N, out); the
    branches run per point."""
    check_fp32(coords, "mlp=coordx")
    bf16, mixed = modes(precision)
    px, py, pf = _split(params, cfg)
    ys = (coords[:, 0:1] - 0.5) * 2.0
    xs = (coords[:, 1:2] - 0.5) * 2.0
    z = _fuse(_run_branch(py, ys, cfg, bf16, mixed), _run_branch(px, xs, cfg, bf16, mixed),
              cfg, mixed)
    return _run_fused(pf, z, cfg, bf16, mixed)
