"""The fit loop (counterpart of implicit_image_tpu/training/fit.py).

A Python loop of train steps: full-grid forward (for SIREN through the
fused chain), the loss (MSE, or the `ms-ssim` mix), backward (for SIREN the
CUDA backward kernel on the card), functional Adam with StepLR, and an
eval at the log cadence — (step+1) % log_steps == 0 plus the final step,
so short runs still report a PSNR. Metric arrays have one entry per step, NaN where no
eval ran, like the JAX fit's.

Sparse masking (RigL, SNFS, GMP) follows the JAX step order: grads; masked
when dense_gradients is false; Adam (in place); weights re-masked in place;
Adam's moments masked when dense_gradients is false; the decayed prune
rate; a topology update (sparsity.update_connections, reading this step's
grads) when (step+1) % interval == 0 and step <= end_when, never at step 0;
the density. The update cadence is a Python test on the step, and the
density only changes at an update, so it is recomputed there only. Nothing
in the step reads a device value on the host.

A separable model (CoordX) evaluates the loss and the eval through its
grid forward `mdef.apply`, whose branches run O(H + W), instead of the flat
coordinate list.

`pixel_chunks` > 1 accumulates the loss and gradient over equal pixel
chunks (mean of chunk means = the full-batch mean); for a separable model
whose chunks are whole row blocks (k divides H), each chunk is itself a
tensor-product grid and keeps the grid forward. A full-grid model
(wavelet_siren: its sub-SIRENs run on their own DWT lattices) takes no
chunks and raises before the first step.

Only the tensors an optimizer step trains (optim.adam.TRAINABLE_KEYS: w,
b, centroids) take gradients; frozen leaves (Fourier's encoding B,
Feathermap's frozen_* extras) take none. The JAX package's TPU-runtime
scaffolding (`segment_steps`, `program_cache`, `use_pallas`, `remat`,
`estimate_step_flops`) has no counterpart here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.ops.metrics import mse, psnr_8bit
from implicit_image_tpu_torch.ops.sine_mlp import precision_from_config
from implicit_image_tpu_torch.optim import adam_momentum, cosine_lr, opt_init, opt_update, step_lr
from implicit_image_tpu_torch.optim.adam import TRAINABLE_KEYS
from implicit_image_tpu_torch.sparsity import (
    MaskingConfig,
    MaskState,
    apply_masks_,
    build_decay,
    create_mask_state,
    load_lottery_masks,
    mask_grads,
    mask_momentum,
    total_density,
    update_connections,
)

__all__ = [
    "TrainConfig",
    "OptimConfig",
    "FitResult",
    "make_loss_fn",
    "make_grad_fn",
    "forward_flat",
    "fit",
    "synchronize",
    "set_trainable_",
]


@dataclass(frozen=True)
class TrainConfig:
    """The cfg.train keys the port reads."""

    num_steps: int = 2000
    log_steps: int = 1000
    pixel_chunks: int = 1
    loss: str = "mse"  # or "ms-ssim": (1-w)·MSE + w·(1-MS-SSIM), w = ssim_weight
    ssim_weight: float = 0.84
    # train.matmul_precision; mapped to the kernel mode by
    # ops.sine_mlp.precision_from_config (tensorfloat32/float32 -> fp32)
    matmul_precision: Optional[str] = "tensorfloat32"

    @property
    def precision(self) -> str:
        return precision_from_config(self.matmul_precision)


@dataclass(frozen=True)
class OptimConfig:
    """The Adam fields of the JAX OptimConfig (conf/optim/adam.yaml);
    StepLR(lr_step_size, lr_gamma), or warmup + cosine with
    lr_schedule="cosine"."""

    name: str = "adam"
    lr: float = 3e-4
    lr_step_size: int = 2000
    lr_gamma: float = 0.5
    lr_schedule: str = "step"
    lr_warmup: int = 0


class FitResult(NamedTuple):
    params: Any
    opt_state: Any
    metrics: Dict[str, np.ndarray]
    wall_seconds: float
    mask_state: Optional[MaskState] = None  # None for a dense fit


def synchronize(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def set_trainable_(params, on: bool) -> None:
    """requires_grad on (or off) for every trainable leaf (a key of
    TRAINABLE_KEYS); frozen leaves never take a gradient."""
    for layer in params:
        for key, v in layer.items():
            if key in TRAINABLE_KEYS:
                v.requires_grad_(on)


def make_loss_fn(mdef: ModelDef, mcfg, coords, target_flat, precision: str,
                 grid_hw=None, loss_name: str = "mse", ssim_weight: float = 0.84):
    """loss(params): MSE of the flat forward against the flat target, or
    with loss_name="ms-ssim" (needs the (H, W) grid) the mix
    (1-w)·MSE + w·(1-MS-SSIM) at as many scales (up to 5) as the grid holds
    with an 11-pixel window. With grid_hw a separable model runs its grid
    forward on coords reshaped to (H, W, in)."""
    if loss_name == "mse":
        def distortion(pred_flat):
            return mse(pred_flat, target_flat)
    elif loss_name == "ms-ssim":
        if grid_hw is None:
            raise ValueError("loss='ms-ssim' needs the (H, W) grid geometry")
        from implicit_image_tpu_torch.ops.ssim import ms_ssim

        gh, gw = grid_hw
        win = 11
        levels = 1
        while levels < 5 and min(gh, gw) >= win * 2**levels:
            levels += 1
        target_img = target_flat.reshape(gh, gw, -1)
        w_mix = float(ssim_weight)

        def distortion(pred_flat):
            ms = ms_ssim(pred_flat.reshape(target_img.shape), target_img,
                         levels=levels, win_size=win)
            return (1.0 - w_mix) * mse(pred_flat, target_flat) + w_mix * (1.0 - ms)
    else:
        raise ValueError(f"train.loss must be 'mse' or 'ms-ssim', got {loss_name!r}")

    def loss_fn(params):
        return distortion(forward_flat(mdef, mcfg, params, coords, grid_hw, precision))

    return loss_fn


def forward_flat(mdef: ModelDef, mcfg, params, coords, grid_hw, precision: str):
    """(N, out) forward over flat coords: through `mdef.apply` on the
    (H, W) grid for a separable model when grid_hw is given, else
    `mdef.apply_flat`."""
    if grid_hw is not None and mdef.separable:
        h, w = grid_hw
        pred = mdef.apply(params, coords.reshape(h, w, coords.shape[-1]), mcfg, precision)
        return pred.reshape(h * w, -1)
    return mdef.apply_flat(params, coords, mcfg, precision)


def make_grad_fn(mdef: ModelDef, mcfg, coords, target_flat, precision: str,
                 pixel_chunks: int = 1, transform=None, grid_hw=None,
                 loss_name: str = "mse", ssim_weight: float = 0.84):
    """grad_fn(state) -> (loss, grads): the loss of the params
    `transform(state)` (state itself when transform is None), with grads
    for every trainable tensor of `state` (keys of TRAINABLE_KEYS; the
    grads hold no entry for a frozen leaf); chunk-accumulated when
    pixel_chunks > 1 (MSE only: SSIM windows straddle the chunks; a
    separable model keeps its grid forward when the chunks are whole row
    blocks; a full-grid model takes no chunks)."""
    n = coords.shape[0]
    k = int(pixel_chunks)
    if k > 1 and mdef.full_grid:
        raise ValueError(
            f"model {mdef.name!r} renders its full grid only; pixel_chunks={k} needs 1")
    if k > 1 and n % k:
        raise ValueError(f"pixel_chunks={k} must divide pixel count {n}")
    if k > 1 and loss_name == "ms-ssim":
        raise ValueError("loss='ms-ssim' requires pixel_chunks=1")
    chunk_hw = grid_hw
    if k > 1:
        rows_split = grid_hw is not None and mdef.separable and grid_hw[0] % k == 0
        chunk_hw = (grid_hw[0] // k, grid_hw[1]) if rows_split else None
    chunks = [
        make_loss_fn(mdef, mcfg, c, t, precision, chunk_hw, loss_name, ssim_weight)
        for c, t in zip(coords.chunk(k), target_flat.chunk(k))
    ]

    def grad_fn(params):
        keys = [[key for key in layer if key in TRAINABLE_KEYS] for layer in params]
        leaves = [layer[key] for layer, ks in zip(params, keys) for key in ks]
        loss_sum, grad_sum = None, None
        model_params = transform(params) if transform is not None else params
        for loss_fn in chunks:
            loss = loss_fn(model_params)
            g = torch.autograd.grad(loss, leaves)
            if grad_sum is None:
                loss_sum, grad_sum = loss.detach(), list(g)
            else:
                loss_sum = loss_sum + loss.detach()
                grad_sum = [a + b for a, b in zip(grad_sum, g)]
        if k > 1:
            loss_sum = loss_sum * (1.0 / k)
            grad_sum = [g * (1.0 / k) for g in grad_sum]
        it = iter(grad_sum)
        return loss_sum, tuple({key: next(it) for key in ks} for ks in keys)

    return grad_fn


def _schedule(optim_cfg: OptimConfig, num_steps: int):
    if optim_cfg.lr_schedule == "cosine":
        return cosine_lr(optim_cfg.lr, num_steps, warmup=int(optim_cfg.lr_warmup))
    return step_lr(optim_cfg.lr, optim_cfg.lr_step_size, optim_cfg.lr_gamma)


def _host_array(values) -> np.ndarray:
    """Per-step scalars (numpy floats or 0-d tensors) -> a float32 array."""
    if values and isinstance(values[0], torch.Tensor):
        return torch.stack(values).cpu().numpy().astype(np.float32)
    return np.asarray(values, np.float32)


def fit(
    generator: torch.Generator,
    mdef: ModelDef,
    mcfg,
    grid: torch.Tensor,
    img,
    train_cfg: TrainConfig,
    optim_cfg: OptimConfig,
    masking_cfg: Optional[MaskingConfig] = None,
    init_params=None,
    device=None,
) -> FitResult:
    """Run one fit on `device` (default: the grid's); returns the final
    params, per-step metric arrays and, for a sparse masking config, the
    final MaskState. `generator` (CPU) draws the init weights, then the
    initial masks and any random growth."""
    device = torch.device(device) if device is not None else grid.device
    precision = train_cfg.precision
    h, w, c = grid.shape
    coords = grid.to(device).reshape(h * w, c)
    target = torch.as_tensor(np.asarray(img), dtype=torch.float32).to(device)
    target_flat = target.reshape(h * w, -1)

    if init_params is not None:
        params = tuple({k: v.detach().to(device).clone() for k, v in layer.items()}
                       for layer in init_params)
    else:
        params = mdef.init(generator, mcfg, device)
    set_trainable_(params, True)
    opt_state = opt_init(params, optim_cfg)
    grad_fn = make_grad_fn(mdef, mcfg, coords, target_flat, precision,
                           train_cfg.pixel_chunks, grid_hw=(h, w),
                           loss_name=train_cfg.loss, ssim_weight=train_cfg.ssim_weight)
    schedule = _schedule(optim_cfg, train_cfg.num_steps)

    sparse = masking_cfg is not None and not masking_cfg.dense
    mask_state = None
    if sparse:
        lottery = load_lottery_masks(masking_cfg.mask_path) if masking_cfg.mask_path else None
        mask_state = create_mask_state(generator, params, masking_cfg, lottery_masks=lottery)
        apply_masks_(params, mask_state.masks)
        decay_fn = build_decay(masking_cfg)
        needs_momentum = "momentum" in (masking_cfg.growth_mode,
                                        masking_cfg.redistribution_mode)
        density = total_density(mask_state)
        sparsity = 1.0 - density

    n = train_cfg.num_steps
    losses, densities, rates = [], [], []
    evals = {}
    synchronize(device)
    t0 = time.perf_counter()
    for step in range(n):
        loss, grads = grad_fn(params)
        if sparse and not masking_cfg.dense_gradients:
            mask_grads(grads, mask_state.masks)
        params, opt_state = opt_update(grads, opt_state, params, schedule(step), optim_cfg)
        losses.append(loss)
        if sparse:
            apply_masks_(params, mask_state.masks)
            if not masking_cfg.dense_gradients:
                mask_momentum(opt_state, mask_state.masks)
            rate = decay_fn(step, sparsity)
            if (step + 1) % masking_cfg.interval == 0 and step <= masking_cfg.end_when:
                momenta = [adam_momentum(opt_state, i) if needs_momentum and m is not None
                           else None for i, m in enumerate(mask_state.masks)]
                params, mask_state = update_connections(
                    params, grads, momenta, mask_state, rate, generator, masking_cfg)
                density = total_density(mask_state)
                sparsity = 1.0 - density
            rates.append(rate)
            densities.append(density)
        if (step + 1) % train_cfg.log_steps == 0 or step == n - 1:
            with torch.no_grad():
                pred = forward_flat(mdef, mcfg, params, coords, (h, w), precision)
                test_loss = mse(pred, target_flat)
                evals[step] = torch.stack(
                    [test_loss, 10.0 * torch.log10(1.0 / test_loss),
                     psnr_8bit(pred, target_flat)]
                )
    synchronize(device)
    wall = time.perf_counter() - t0

    metrics = {k: np.full(n, np.nan, np.float32)
               for k in ("test_loss", "psnr", "psnr_8bit")}
    metrics["loss"] = (torch.stack(losses).cpu().numpy() if losses
                       else np.zeros(0, np.float32))
    metrics["density"] = _host_array(densities) if sparse else np.ones(n, np.float32)
    metrics["prune_rate"] = _host_array(rates) if sparse else np.zeros(n, np.float32)
    for step, vals in evals.items():
        tl, p, p8 = vals.cpu().numpy()
        metrics["test_loss"][step], metrics["psnr"][step], metrics["psnr_8bit"][step] = tl, p, p8
    set_trainable_(params, False)
    return FitResult(params=params, opt_state=opt_state, metrics=metrics,
                     wall_seconds=wall, mask_state=mask_state)
