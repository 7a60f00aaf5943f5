"""Feathermap — structured multi-hashing compression (Zhu et al.;
counterpart of implicit_image_tpu/feathermap/__init__.py).

Every weight and bias of the base model is a slice of the rank-m product
V = V1 @ V2, scaled by a trainable scalar per tensor:

  * n = ceil(sqrt(total weight + bias elements)), m = ceil(compress * n / 2)
    (at SIREN d8/w128 and density 0.2: n = 316, m = 32);
  * V1, V2 ~ U(±bound), bound = sqrt(12) / 2 * m^(-1/4);
  * a tensor's scaler starts at its layer's SIREN init bound where the
    model config has `weight_bound` (the bias shares the weight's), else
    at 1/sqrt(fan_in) of the layer's weight;
  * leaves other than w and b (Fourier's encoding B) pass through unhashed
    and frozen: they travel in params layer 2 as `frozen_{layer}_{key}`.

The wrapped model's params are ({"w": V1}, {"w": V2}, {"b": scalers,
frozen_*}), so the optimizer, the codebook finetune and the container take
them like any other layer stack. `materialize` is one `torch.matmul`
V1 @ V2 (in the JAX package an XLA product, outside any Pallas kernel)
followed by each tensor's slice times its scaler; the base model then runs
as it is, so over SIREN the materialized weights enter the fused chain (the
CUDA kernels on the card) and autograd carries the kernels' dW back into
V1, V2 and the scalers. A separable base (CoordX) keeps its grid forward.
The product takes the fit's precision mode as the JAX package's does: true
fp32 (TF32 off on the card), or one bf16 pass in the "bf16" mode; under
"+mixed" it stays fp32 and the base model casts what it reads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.ops import check_fp32
from implicit_image_tpu_torch.ops.precision import matmul, modes

__all__ = [
    "FeatherSpec",
    "build_feather_model",
    "feather_init",
    "materialize",
    "materialize_tensor",
]

_HASHED = ("w", "b")


@dataclass(frozen=True)
class FeatherSpec:
    """Static layout: how the base model's tensors tile the flat V."""

    entries: Tuple[Tuple[int, str, Tuple[int, ...], int], ...]  # (layer, key, shape, offset)
    size_n: int
    size_m: int
    compress: float

    @property
    def total(self) -> int:
        last = self.entries[-1]
        return last[3] + int(math.prod(last[2]))


def _plan(base_params, compress: float) -> FeatherSpec:
    entries = []
    offset = 0
    for i, layer in enumerate(base_params):
        for key in _HASHED:
            if key in layer:
                shape = tuple(layer[key].shape)
                entries.append((i, key, shape, offset))
                offset += int(math.prod(shape))
    n = math.ceil(math.sqrt(offset))
    m = max(1, math.ceil(compress * n / 2))
    return FeatherSpec(entries=tuple(entries), size_n=n, size_m=m, compress=compress)


def _scaler_init(mcfg, layer: int, key: str, shape) -> float:
    """The layer's init bound where the config provides one, else
    1/sqrt(fan_in) of the layer's weight ((fan_in, fan_out) layout)."""
    if hasattr(mcfg, "weight_bound"):
        try:
            return float(mcfg.weight_bound(layer))
        except Exception:  # noqa: BLE001 - a layer the bound does not cover
            pass
    return 1.0 / math.sqrt(shape[0])


def _frozen_extras(base_params) -> dict:
    return {i: {k: v for k, v in layer.items() if k not in _HASHED}
            for i, layer in enumerate(base_params)
            if any(k not in _HASHED for k in layer)}


def feather_init(generator: torch.Generator, base_params, mcfg, compress: float,
                 device="cpu"):
    """(feather params, spec, frozen extras): ({"w": V1}, {"w": V2},
    {"b": scalers}); V1 then V2 drawn on the CPU from `generator`, then
    moved to `device`. The extras map layer index -> its leaves other than
    w and b."""
    spec = _plan(base_params, compress)
    bound = math.sqrt(12.0) / 2.0 * spec.size_m ** (-0.25)
    v1 = (torch.rand((spec.size_n, spec.size_m), generator=generator) * 2.0 - 1.0) * bound
    v2 = (torch.rand((spec.size_m, spec.size_n), generator=generator) * 2.0 - 1.0) * bound
    wshape = {layer: shape for layer, key, shape, _ in spec.entries if key == "w"}
    scalers = [_scaler_init(mcfg, layer, key, wshape[layer])
               for layer, key, _, _ in spec.entries]
    fparams = (
        {"w": v1.to(device)},
        {"w": v2.to(device)},
        {"b": torch.tensor(scalers, dtype=torch.float32, device=device)},
    )
    return fparams, spec, _frozen_extras(base_params)


def materialize(fparams, spec: FeatherSpec, frozen=None, n_layers: int = None,
                bf16: bool = False):
    """Feather params -> the base model's params: one product (one bf16
    pass when bf16), then slices."""
    v1, v2, scalers = fparams[0]["w"], fparams[1]["w"], fparams[2]["b"]
    flat = matmul(v1, v2, bf16).reshape(-1)
    n_layers = n_layers or (max(e[0] for e in spec.entries) + 1)
    layers: list = [dict() for _ in range(n_layers)]
    for i, extras in (frozen or {}).items():
        layers[i].update(extras)
    for idx, (layer, key, shape, offset) in enumerate(spec.entries):
        size = int(math.prod(shape))
        layers[layer][key] = scalers[idx] * flat[offset : offset + size].reshape(shape)
    return tuple(layers)


def materialize_tensor(fparams, spec: FeatherSpec, entry_index: int):
    """One tensor from the rows of V1 that cover its slice (the reference's
    deploy mode): equal to its entry of `materialize`."""
    layer, key, shape, offset = spec.entries[entry_index]
    size = int(math.prod(shape))
    n = spec.size_n
    row0 = offset // n
    row1 = (offset + size - 1) // n + 1
    v1, v2, scalers = fparams[0]["w"], fparams[1]["w"], fparams[2]["b"]
    block = (v1[row0:row1] @ v2).reshape(-1)
    local = offset - row0 * n
    return scalers[entry_index] * block[local : local + size].reshape(shape)


def build_feather_model(mdef: ModelDef, mcfg, compress: float) -> ModelDef:
    """Wrap a ModelDef so its params are feather-hashed: init returns the
    (V1, V2, scalers [+ frozen extras]) tuple; apply / apply_flat
    materialize the base params and delegate. The layout is planned from a
    template init on the CPU."""
    base_template = mdef.init(torch.Generator().manual_seed(0), mcfg, "cpu")
    spec = _plan(base_template, compress)
    n_layers = len(base_template)

    def init(generator, cfg, device="cpu"):
        base = mdef.init(generator, cfg, device)
        fparams, _, frozen = feather_init(generator, base, cfg, compress, device)
        extras = {f"frozen_{i}_{k}": v for i, d in frozen.items() for k, v in d.items()}
        return (fparams[0], fparams[1], {**fparams[2], **extras})

    def _split(params):
        frozen, scal_layer = {}, {}
        for k, v in params[2].items():
            if k.startswith("frozen_"):
                _, i, key = k.split("_", 2)
                frozen.setdefault(int(i), {})[key] = v
            else:
                scal_layer[k] = v
        return (params[0], params[1], scal_layer), frozen

    def base_params(params, x, precision):
        check_fp32(x, "masking=Feathermap")
        fparams, frozen = _split(params)
        return materialize(fparams, spec, frozen, n_layers, bf16=modes(precision)[0])

    def apply_flat(params, coords, cfg, precision="fp32"):
        return mdef.apply_flat(base_params(params, coords, precision), coords, cfg, precision)

    def apply(params, grid, cfg, precision="fp32"):
        return mdef.apply(base_params(params, grid, precision), grid, cfg, precision)

    # over a member axis: each member's base params materialized under
    # torch.func.vmap, then the base model's member-axis forward (over SIREN
    # the member-axis kernels)
    def base_members(params, x, precision):
        return torch.func.vmap(lambda p: base_params(p, x, precision))(params)

    def apply_flat_members(params, coords, cfg, precision="fp32"):
        return mdef.apply_flat_members(base_members(params, coords, precision), coords, cfg,
                                       precision)

    def apply_members(params, grid, cfg, precision="fp32"):
        return mdef.apply_members(base_members(params, grid, precision), grid, cfg, precision)

    return ModelDef(
        name=f"feather_{mdef.name}",
        config_cls=mdef.config_cls,
        init=init,
        apply=apply,
        apply_flat=apply_flat,
        separable=mdef.separable,
        full_grid=mdef.full_grid,
        apply_members=apply_members,
        apply_flat_members=apply_flat_members,
    )
