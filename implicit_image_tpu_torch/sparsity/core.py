"""Sparsity core (counterpart of implicit_image_tpu/sparsity/core.py): masks
over a params tuple, and the mask topology update.

Masks are dense 0/1 float32 tensors on the params' device, one per weight
("w") tensor or None for a layer excluded from masking; biases are never
masked. Masked weights enter the SIREN kernels dense, as they entered the
MXU in JAX.

  * apply_masks: weights * mask, out of place and differentiable (the
    codebook finetune masks its reconstructed weights inside autograd);
  * apply_masks_, mask_grads, mask_momentum: the same in place, under
    no_grad, for the fit loop, whose Adam updates params and moments in place;
  * update_connections: one topology update — statistics, per-layer prune
    rates, prune, redistribute, grow, apply, smoothing adjustment.

No function here reads a device value on the host, with one exception: the
residual-redistribution solver of `_calc_redistributed`, which only the
momentum and grad redistribution modes reach (SNFS; RigL's mode is none).
Its iteration count depends on the values, as the JAX `lax.while_loop` did;
it copies its (L,) inputs to the host once and runs the loop there in
float32, summing in index order like XLA's small reductions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.sparsity import grow as grow_mod
from implicit_image_tpu_torch.sparsity import prune as prune_mod
from implicit_image_tpu_torch.sparsity import redistribute as redist_mod
from implicit_image_tpu_torch.sparsity.init_scheme import init_masks

__all__ = [
    "MaskingConfig",
    "MaskState",
    "create_mask_state",
    "load_lottery_masks",
    "apply_masks",
    "apply_masks_",
    "mask_grads",
    "mask_momentum",
    "update_connections",
    "total_density",
]


@dataclass(frozen=True)
class MaskingConfig:
    """Masking config; field names mirror conf/masking/*.yaml."""

    name: str = "RigL"
    density: float = 0.5
    sparse_init: str = "erdos-renyi-kernel"
    dense_gradients: bool = True
    prune_mode: str = "magnitude"
    growth_mode: str = "absolute-gradient"
    redistribution_mode: str = "none"
    decay_schedule: str = "cosine"
    prune_rate: float = 0.1
    final_density: float = 0.5
    start_when: int = 5
    end_when: int = 1500
    interval: int = 20
    dense: bool = False
    print_FLOPs: bool = False
    # lottery-ticket / resume source: a prior run's mask.npz (layers.{i}.mask)
    # or model.npz (masks from the nonzero entries)
    mask_path: Optional[str] = None

    def __post_init__(self):
        for value, names, what in (
            (self.prune_mode, prune_mod.registry_names, "prune"),
            (self.growth_mode, grow_mod.registry_names, "growth"),
            (self.redistribution_mode, redist_mod.registry_names, "redistribute"),
        ):
            if value not in names:
                raise ValueError(f"Available {what} modes: {names}, got {value!r}")

    @property
    def global_prune(self) -> bool:
        return "global" in self.prune_mode


class MaskState(NamedTuple):
    """Masks and the update's running scalars (0-d float32 tensors on the
    masks' device)."""

    masks: Tuple[Optional[torch.Tensor], ...]  # aligned with the params layers
    baseline_nonzero: torch.Tensor
    total_params: torch.Tensor  # masked layers only
    adjusted_growth: torch.Tensor
    adj_sum: torch.Tensor  # running sum of adjustments
    adj_count: torch.Tensor  # running count of adjustments
    final_sparsity: torch.Tensor  # 1 - final_density


def load_lottery_masks(path: str) -> List[torch.Tensor]:
    """A prior run's mask.npz (`layers.{i}.mask`) or model.npz
    (`layers.{i}.w`) -> per-layer float32 masks (the nonzero pattern), in
    layer-index order, on the CPU."""
    data = np.load(path)
    by_idx = {}
    for name in data.files:
        parts = name.split(".")
        if len(parts) != 3 or parts[0] != "layers":
            continue
        if parts[2] in ("mask", "w", "weight"):
            by_idx[int(parts[1])] = data[name]
    if not by_idx:
        raise ValueError(f"{path} has no layers.*.mask or layers.*.w arrays")
    return [torch.from_numpy((by_idx[i] != 0).astype(np.float32)) for i in sorted(by_idx)]


def create_mask_state(generator: Optional[torch.Generator], params, cfg: MaskingConfig,
                      lottery_masks=None) -> MaskState:
    """Masks for every weight tensor per cfg.sparse_init, on the params'
    device; random draws come from `generator` (CPU)."""
    widx = [i for i, layer in enumerate(params) if "w" in layer]
    device = params[widx[0]]["w"].device
    mask_list = init_masks(
        generator,
        [tuple(params[i]["w"].shape) for i in widx],
        cfg.density,
        scheme=cfg.sparse_init,
        weights=[params[i]["w"] for i in widx],
        lottery_masks=lottery_masks,
        device=device,
    )
    masks: List[Optional[torch.Tensor]] = [None] * len(params)
    for i, m in zip(widx, mask_list):
        masks[i] = m
    live = [m for m in masks if m is not None]

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return MaskState(
        masks=tuple(masks),
        baseline_nonzero=torch.stack([m.sum() for m in live]).sum(),
        total_params=scalar(float(sum(m.numel() for m in live))),
        adjusted_growth=scalar(0.0),
        adj_sum=scalar(0.0),
        adj_count=scalar(0.0),
        final_sparsity=scalar(1.0 - cfg.final_density),
    )


def apply_masks(params, masks):
    """weights * mask for every masked layer; a new params tuple."""
    return tuple(layer if m is None else {**layer, "w": layer["w"] * m}
                 for layer, m in zip(params, masks))


@torch.no_grad()
def apply_masks_(params, masks):
    """weights *= mask in place; returns params."""
    for layer, m in zip(params, masks):
        if m is not None:
            layer["w"].mul_(m)
    return params


def mask_grads(grads, masks):
    """grad *= mask in place (dense_gradients=False)."""
    return apply_masks_(grads, masks)


def mask_momentum(opt_state, masks):
    """The optimizer's momentum buffers *= mask in place: Adam's mu and nu,
    or Shampoo's momentum buffer; any other state raises TypeError."""
    if hasattr(opt_state, "mu"):
        apply_masks_(opt_state.mu, masks)
        apply_masks_(opt_state.nu, masks)
    elif hasattr(opt_state, "momentum_buf"):
        apply_masks_(opt_state.momentum_buf, masks)
    else:
        raise TypeError(f"unknown optimizer state {type(opt_state).__name__}")
    return opt_state


def total_density(state: MaskState) -> torch.Tensor:
    live = [m for m in state.masks if m is not None]
    return torch.stack([m.sum() for m in live]).sum() / state.total_params


def _seq_sum(values: np.ndarray) -> np.float32:
    acc = np.float32(0.0)
    for v in values:
        acc = acc + v
    return acc


def _calc_redistributed(variance, zeros, removed, total_removed, adjusted_growth
                        ) -> torch.Tensor:
    """Residual-redistribution solver over the (L,) layer axis: layers whose
    share exceeds 0.99 of their room are capped and the excess is spread
    evenly, until the residual is 0 or stops falling (at most 1000 rounds)."""
    device = variance.device
    host = [np.asarray(t.detach().cpu(), np.float32)
            for t in (variance, zeros, removed, total_removed, adjusted_growth)]
    variance, zeros, removed, total_removed, adjusted_growth = host
    n_layers = variance.shape[0]
    cap = np.float32(0.99) * (zeros + removed)
    init_prop = np.round(variance * (total_removed + adjusted_growth))
    regrowth = np.zeros_like(variance)
    mean_res = np.float32(0.0)
    residual, prev_residual = np.float32(9999.0), np.float32(np.inf)
    i = 0
    while residual > 0 and residual < prev_residual and i < 1000:
        prop = (regrowth if i else init_prop) + mean_res
        over = prop > cap
        regrowth = np.where(over, cap, prop)
        prev_residual, residual = residual, _seq_sum(np.where(over, prop - cap, np.float32(0)))
        mean_res = residual / np.float32(n_layers)
        i += 1
    return torch.from_numpy(regrowth).to(device)


def _layer_prune(cfg: MaskingConfig, mask, weight, rate, nonzeros):
    if cfg.prune_mode == "magnitude":
        return prune_mod.magnitude_prune(mask, weight, rate, nonzeros)
    if cfg.prune_mode == "struct-magnitude-mean":
        return prune_mod.struct_magnitude_prune(mask, weight, rate, nonzeros, "mean")
    if cfg.prune_mode == "struct-magnitude-max":
        return prune_mod.struct_magnitude_prune(mask, weight, rate, nonzeros, "max")
    raise KeyError(cfg.prune_mode)


def _layer_grow(cfg: MaskingConfig, mask, weight, grad, momentum, num_growth, generator):
    gm = cfg.growth_mode
    if gm == "absolute-gradient":
        return grow_mod.abs_grad_growth(mask, weight, grad, num_growth)
    if gm == "momentum":
        return grow_mod.momentum_growth(mask, weight, momentum, num_growth)
    if gm == "random":
        return grow_mod.random_growth(mask, weight, grad, num_growth, generator)
    if gm == "none":
        return grow_mod.no_growth(mask, weight, grad, num_growth)
    if gm == "struct-absolute-gradient-mean":
        return grow_mod.struct_abs_grad_growth(mask, weight, grad, num_growth, criterion="mean")
    if gm == "struct-absolute-gradient-min":
        return grow_mod.struct_abs_grad_growth(mask, weight, grad, num_growth, criterion="min")
    raise KeyError(gm)


def _redistribution_stat(cfg: MaskingConfig, mask, weight, grad, momentum):
    rm = cfg.redistribution_mode
    if rm == "momentum":
        return redist_mod.momentum_redistribution(mask, weight, grad, momentum)
    if rm == "grad":
        return redist_mod.grad_redistribution(mask, weight, grad, momentum)
    return redist_mod.nonzero_redistribution(mask, weight, grad, momentum)


@torch.no_grad()
def update_connections(params, grads, momenta, state: MaskState, prune_rate,
                       generator: Optional[torch.Generator], cfg: MaskingConfig):
    """One mask topology update (the reference's truncate_weights).

    params: the current (masked) params, updated IN PLACE; grads: their
    dense gradients; momenta: per-layer momentum tensors or None (only the
    momentum modes read them); prune_rate: this step's decayed rate (a
    float or a 0-d tensor). Returns (params, new MaskState).
    """
    widx = [i for i, m in enumerate(state.masks) if m is not None]
    n_layers = len(widx)
    masks = list(state.masks)
    device = masks[widx[0]].device
    if not isinstance(prune_rate, torch.Tensor):
        # a fill, not a host-to-device copy (which would wait for the stream)
        prune_rate = torch.full((), float(prune_rate), dtype=torch.float32, device=device)
    mom = {i: momenta[i] if momenta[i] is not None else torch.zeros_like(params[i]["w"])
           for i in widx}

    # gather statistics
    variance = torch.nan_to_num(torch.stack([
        _redistribution_stat(cfg, masks[i], params[i]["w"], grads[i]["w"], mom[i])
        for i in widx]))
    nonzeros = torch.stack([(masks[i] > 0).sum().to(torch.float32) for i in widx])
    numels = torch.stack([masks[i].new_full((), float(masks[i].numel())) for i in widx])
    zeros = numels - nonzeros
    variance = variance / torch.clamp(variance.sum(), min=1e-30)
    total_nonzero = nonzeros.sum()

    # per-layer prune rates: nearly dense layers with little variance keep more
    sparsity = zeros / numels
    expected_vs_actual = (1.0 / n_layers) / torch.clamp(variance, min=1e-30)
    layer_rates = torch.where((sparsity < 0.2) & (expected_vs_actual < 1.0),
                              torch.minimum(sparsity, prune_rate), prune_rate)

    # prune
    if cfg.global_prune:
        pruned, total_removed = prune_mod.global_magnitude_prune(
            [masks[i] for i in widx], [params[i]["w"] for i in widx], prune_rate,
            state.baseline_nonzero)
        for j, i in enumerate(widx):
            masks[i] = pruned[j]
        removed = nonzeros - torch.stack([masks[i].sum() for i in widx])
    else:
        removed = []
        for j, i in enumerate(widx):
            masks[i] = _layer_prune(cfg, masks[i], params[i]["w"], layer_rates[j], nonzeros[j])
            removed.append(nonzeros[j] - masks[i].sum())
        removed = torch.stack(removed)
        total_removed = removed.sum()

    # grow
    if cfg.growth_mode == "none":
        total_nonzero_new = total_nonzero - total_removed
    else:
        if cfg.redistribution_mode not in ("nonzero", "none"):
            regrowth = _calc_redistributed(variance, zeros, removed, total_removed,
                                           state.adjusted_growth)
        else:
            regrowth = removed
        num_growth = torch.floor(regrowth)
        nonzero_new = []
        for j, i in enumerate(widx):
            masks[i], new_w = _layer_grow(cfg, masks[i], params[i]["w"], grads[i]["w"],
                                          mom[i], num_growth[j], generator)
            params[i]["w"].copy_(new_w)
            nonzero_new.append(masks[i].sum())
        total_nonzero_new = torch.stack(nonzero_new).sum()

    # apply, then the smoothing adjustment
    apply_masks_(params, masks)
    adjustment = state.baseline_nonzero - total_nonzero_new
    adj_sum = state.adj_sum + adjustment
    adj_count = state.adj_count + 1.0
    adjusted_growth = 0.25 * state.adjusted_growth + 0.75 * adjustment + adj_sum / adj_count
    return params, state._replace(masks=tuple(masks), adjusted_growth=adjusted_growth,
                                  adj_sum=adj_sum, adj_count=adj_count)
