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
in the step reads a device value on the host. The init (`init_fit_state`)
and the step after the gradients (`optimizer_step` with `SparseFit`) are
written once, for this loop and for the member-axis loop of the batched
fit and the density ladder (parallel/batched.py).

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
scaffolding (`program_cache`, `use_pallas`, `remat`, `estimate_step_flops`,
the split of a fit into device executions) has no counterpart here.

The precision schedule (train.matmul_precision_early, _switch): steps
before the switch step round(n · switch) — an exact step, as in the JAX
package's `plan_precision_schedule` — run their forward, backward and
in-loop eval in the early mode, the rest in train.matmul_precision's, on
the same kernels. A switch that leaves no step at matmul_precision raises
(the JAX package silently drops the precise tail there).

Boundaries: the JAX package runs a fit as device executions of
`segment_steps` steps (split at the switch step) and does its host-side
work between them. The port keeps that cadence (`segment_boundaries`, from
the first executed step) for exactly that work: the checkpoint
(`checkpoint_path`), the `watch(params, opt_state, step)` callback and the
early-stop check (`stop_psnr`: an eval PSNR at the precision JAX's
`eval_psnr` uses — its forward runs under no `default_matmul_precision`,
so one bf16 pass, "bf16", with the fit's mixed precision — that stops the
fit once it reaches the target). `resume_from` continues from a
checkpoint of either package (training/checkpoint.py); the metric arrays
then cover the executed steps [start, end) only. Checkpoints carry Adam's
state and, under EKFAC, the preconditioner's; a Shampoo fit takes no
checkpoint and no resume (ValueError), as in the JAX package.

The optimizer is Adam or Shampoo (optim.name). optim.preconditioner=ekfac
(optim/ekfac.py) preconditions the gradients after their masking and
before the optimizer step, where the JAX package does; the topology
update then reads the preconditioned gradients, as JAX's does. Every step
captures each linear layer's inputs and pre-activation gradients through
a plain fp32 chain (chunk by chunk when pixel_chunks > 1) and updates the
KFE moments; the eigenbases are recomputed when step % precond_interval
== 0, a test on the Python step. Feathermap (no per-layer weights) and
wavelet_siren with pixel_chunks > 1 (no per-pixel chunks) raise.

A pixel group (`pixel_group`, the "pixel" axis of a mesh:
parallel/mesh.py) splits the fit's rows over its ranks: rank r of n takes
rows [r·H/n, (r+1)·H/n) and, with train.pixel_chunks = k, runs chunks
r·k .. r·k + k - 1 of the single fit's n·k. Every sum over pixels goes
through the group's ordered sum (parallel/collectives.AxisGroup): the
chunk losses and gradients (so every rank steps with the single fit's
chunk sum: the sharded fit on n ranks has the bits of the single fit with
pixel_chunks = n·k wherever each chunk's forward and backward have them),
EKFAC's factors, the eval's squared-error sums and the stop check's.
Every decision then reads values that are the same on every rank (the
mask updates read the summed gradients; the generator draws the same
growth on every rank), so the ranks never part. Under train.loss=ms-ssim
(whose windows straddle the rows) each rank gathers the rows' predictions
(N x C, not the activations) and evaluates the whole image's loss; its
gradient with respect to a rank's rows is that rank's slice, and the
parameter gradients are added over the ranks in rank order: the single
fit's values up to the order of that sum. A full-grid model needs the
whole lattice on every rank and raises on a group of more than one rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.ops.metrics import mse, psnr_8bit
from implicit_image_tpu_torch.ops.sine_mlp import precision_from_config
from implicit_image_tpu_torch.optim import adam_momentum, cosine_lr, opt_init, opt_update, step_lr
from implicit_image_tpu_torch.optim.adam import TRAINABLE_KEYS
from implicit_image_tpu_torch.optim.ekfac import (
    capture_layer_stats,
    ekfac_init,
    ekfac_precondition,
    ekfac_update_stats,
    ekfac_update_stats_chunked,
    model_skip_indices,
)
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
from implicit_image_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

__all__ = [
    "TrainConfig",
    "OptimConfig",
    "FitResult",
    "plan_precision_schedule",
    "segment_boundaries",
    "make_loss_fn",
    "make_grad_fn",
    "forward_flat",
    "forward_members",
    "fit",
    "init_fit_state",
    "SparseFit",
    "optimizer_step",
    "EkfacFit",
    "check_optim",
    "synchronize",
    "set_trainable_",
    "check_pixel_group",
    "pixel_rows",
    "eval_scores",
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
    # the precision schedule: steps before round(num_steps * switch) run at
    # matmul_precision_early (None: no schedule)
    matmul_precision_early: Optional[str] = None
    matmul_precision_switch: float = 0.75
    # train.mixed_precision: the JAX package's compute_dtype=bfloat16
    mixed_precision: bool = False
    # the cadence of the boundary work (checkpoint, watch, stop check)
    segment_steps: int = 2000

    @property
    def precision(self) -> str:
        return precision_from_config(self.matmul_precision, self.mixed_precision)


@dataclass(frozen=True)
class OptimConfig:
    """The JAX OptimConfig's fields (conf/optim/*.yaml). Every optimizer
    reads lr, the schedule (StepLR(lr_step_size, lr_gamma), or warmup +
    cosine with lr_schedule="cosine") and grad_clip (global-norm clipping,
    0 = off); Shampoo (name="shampoo") reads momentum, weight_decay,
    epsilon, update_freq and graft_norm, which Adam ignores in both
    packages (its eps is 1e-8); preconditioner="ekfac" reads precond_eps
    and precond_interval."""

    name: str = "adam"
    lr: float = 3e-4
    momentum: float = 0.9
    weight_decay: float = 0.0
    epsilon: float = 1e-4
    update_freq: int = 1
    preconditioner: Optional[str] = None
    precond_eps: float = 0.1
    precond_interval: int = 10
    graft_norm: bool = True
    lr_step_size: int = 2000
    lr_gamma: float = 0.5
    lr_schedule: str = "step"
    lr_warmup: int = 0
    grad_clip: float = 0.0


class FitResult(NamedTuple):
    params: Any
    opt_state: Any
    metrics: Dict[str, np.ndarray]
    wall_seconds: float
    mask_state: Optional[MaskState] = None  # None for a dense fit
    # early stop (stop_psnr): the step the fit stopped at (a boundary) and
    # the check's PSNR there; None when the budget ran out
    stopped_at: Optional[int] = None
    stop_psnr_db: Optional[float] = None


def plan_precision_schedule(train_cfg: TrainConfig, n: int):
    """(early precision or None, switch step) of a fit of n steps: steps
    [0, switch) run at the early precision, the rest at train_cfg.precision.
    The switch is round(n · matmul_precision_switch), clamped to [0, n], as
    the JAX package's plan_precision_schedule computes it; 0 means no
    schedule. Raises ValueError when it would leave no step at
    matmul_precision (switch >= 1, or n · switch rounding to n)."""
    early = train_cfg.matmul_precision_early
    if not early:
        return None, 0
    frac = float(train_cfg.matmul_precision_switch)
    switch = max(0, min(n, int(round(n * frac))))
    if switch == 0:
        return None, 0
    if switch >= n:
        raise ValueError(
            f"train.matmul_precision_switch={frac} puts the switch at step {switch} of {n}: "
            f"no step would run at train.matmul_precision={train_cfg.matmul_precision!r}; "
            "use a switch below 1 (or drop train.matmul_precision_early)")
    return precision_from_config(early, train_cfg.mixed_precision), switch


def segment_boundaries(n: int, seg: int, switch: int = 0, start: int = 0):
    """The JAX package's segment boundaries of a fit of n steps from `start`:
    segments of at most `seg` steps, none straddling the switch step (when
    switch > 0). Returns the step after each segment, ending with n."""
    out = []
    s = start
    seg = max(1, int(seg))
    while s < n:
        limit = switch if 0 < switch and s < switch else n
        s += min(seg, limit - s)
        out.append(s)
    return out


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
                 grid_hw=None, loss_name: str = "mse", ssim_weight: float = 0.84,
                 members: bool = False, pixel_group=None):
    """loss(params): MSE of the flat forward against the flat target, or
    with loss_name="ms-ssim" (needs the (H, W) grid) the mix
    (1-w)·MSE + w·(1-MS-SSIM) at as many scales (up to 5) as the grid holds
    with an 11-pixel window. With grid_hw a separable model runs its grid
    forward on coords reshaped to (H, W, in).

    `members`: params whose leaves carry a leading member axis (M fits) and
    target_flat (M, N, out), one target per member, or (N, out) shared;
    loss(params) then runs the member-axis forward once (forward_members)
    and returns two (M,) vectors of the members' losses, each the single
    fit's loss of its member's output against its own target: the one to
    differentiate and the values, with the single fit's bits. The MSE is
    differentiated as one reduction over the stacked squares (its gradient
    has the single fit's bits, elementwise; its sums may add in another
    order on the card), and valued member by member over the same squares;
    the MS-SSIM mix runs member by member, one vector serving both.

    `pixel_group` (ms-ssim only): coords, target_flat and grid_hw are this
    rank's rows; the loss is the whole image's, on its gathered predictions
    (module note)."""
    gather = loss_name == "ms-ssim" and pixel_group is not None
    if loss_name == "mse":
        def distortion(pred_flat, tgt):
            return mse(pred_flat, tgt)
    elif loss_name == "ms-ssim":
        if grid_hw is None:
            raise ValueError("loss='ms-ssim' needs the (H, W) grid geometry")
        from implicit_image_tpu_torch.ops.ssim import ms_ssim

        gh, gw = grid_hw
        if gather:
            gh *= pixel_group.size
            target_flat = pixel_group.cat(target_flat, dim=-2)
        win = 11
        levels = 1
        while levels < 5 and min(gh, gw) >= win * 2**levels:
            levels += 1
        w_mix = float(ssim_weight)

        def distortion(pred_flat, tgt):
            target_img = tgt.reshape(gh, gw, -1)
            ms = ms_ssim(pred_flat.reshape(target_img.shape), target_img,
                         levels=levels, win_size=win)
            return (1.0 - w_mix) * mse(pred_flat, tgt) + w_mix * (1.0 - ms)
    else:
        raise ValueError(f"train.loss must be 'mse' or 'ms-ssim', got {loss_name!r}")

    if members:
        def loss_fn(params):
            pred = forward_members(mdef, mcfg, params, coords, grid_hw, precision)
            if gather:
                pred = _GatherRows.apply(pred, pixel_group)
            if loss_name == "mse":
                diff = pred.float() - target_flat.float()
                sq = diff * diff
                values = torch.stack([torch.mean(m) for m in sq.detach().unbind(0)])
                return torch.mean(sq, dim=(1, 2)), values
            targets = target_flat if target_flat.dim() == 3 else [target_flat] * pred.shape[0]
            loss = torch.stack([distortion(p, t) for p, t in zip(pred.unbind(0), targets)])
            return loss, loss.detach()

        return loss_fn

    def loss_fn(params):
        pred = forward_flat(mdef, mcfg, params, coords, grid_hw, precision)
        return distortion(_GatherRows.apply(pred, pixel_group) if gather else pred, target_flat)

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


def forward_members(mdef: ModelDef, mcfg, params, coords, grid_hw, precision: str):
    """forward_flat over a member axis: params whose leaves carry a leading
    member axis -> (M, N, out), through `mdef.apply_members` on the grid for
    a separable model, else `mdef.apply_flat_members`."""
    if grid_hw is not None and mdef.separable:
        h, w = grid_hw
        pred = mdef.apply_members(params, coords.reshape(h, w, coords.shape[-1]), mcfg,
                                  precision)
        return pred.reshape(pred.shape[0], h * w, -1)
    return mdef.apply_flat_members(params, coords, mcfg, precision)


def check_pixel_group(mdef: ModelDef, pixel_group, height: int) -> None:
    """Raise ValueError, before any work, for what a fit over a pixel group
    does not run: rows that do not split evenly, or a full-grid model on
    more than one rank (it needs the whole lattice on every rank)."""
    pixel_rows(height, pixel_group)
    n = pixel_group.size
    if n > 1 and mdef.full_grid:
        raise ValueError(f"model {mdef.name!r} renders its full grid only (its sub-SIRENs run "
                         f"on the whole DWT lattice); a pixel axis of {n} needs 1")


class _GatherRows(torch.autograd.Function):
    """Every rank's rows (dim -2) of a pixel group, in rank order; the
    gradient of a loss that every rank evaluates alike on the result is, on
    each rank, its own rows' slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[-2]
        return group.cat(x, dim=-2)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-2, ctx.group.rank * ctx.rows, ctx.rows).contiguous(), None


def pixel_rows(height: int, pixel_group) -> slice:
    """This rank's rows of a `height`-row lattice split over `pixel_group`
    (None: every row)."""
    if pixel_group is None:
        return slice(0, height)
    if height % pixel_group.size:
        raise ValueError(f"H={height} not divisible by pixel axis {pixel_group.size}")
    rows = height // pixel_group.size
    return slice(pixel_group.rank * rows, (pixel_group.rank + 1) * rows)


def eval_scores(preds, targets, pixel_group=None) -> torch.Tensor:
    """(M, 3) rows [test_loss, psnr, psnr_8bit] of M flat predictions against
    their targets. With a pixel group they are this rank's rows: the squared
    errors are summed in float64, added over the group in rank order and
    divided by the whole image's count, so every rank reads the same
    values (a group of one rank reads its values as without one)."""
    if pixel_group is None or pixel_group.size == 1:
        rows = []
        for pred, t in zip(preds, targets):
            test_loss = mse(pred, t)
            rows.append(torch.stack([test_loss, 10.0 * torch.log10(1.0 / test_loss),
                                     psnr_8bit(pred, t)]))
        return torch.stack(rows)
    sums = []
    for pred, t in zip(preds, targets):
        diff = pred.float() - t.float()
        diff8 = ((t * 255.0).to(torch.int32) - (pred * 255.0).to(torch.int32)).float()
        sums.append(torch.stack([torch.sum((diff * diff).double()),
                                 torch.sum((diff8 * diff8).double())]))
    (total,) = pixel_group.sum([torch.stack(sums)])
    count = preds[0].numel() * pixel_group.size
    mse_, mse8 = (total / count).float().unbind(1)
    return torch.stack([mse_, 10.0 * torch.log10(1.0 / mse_),
                        10.0 * torch.log10(255.0**2 / mse8)], dim=1)


def make_grad_fn(mdef: ModelDef, mcfg, coords, target_flat, precision: str,
                 pixel_chunks: int = 1, transform=None, grid_hw=None,
                 loss_name: str = "mse", ssim_weight: float = 0.84, members: bool = False,
                 pixel_group=None):
    """grad_fn(state) -> (loss, grads): the loss of the params
    `transform(state)` (state itself when transform is None), with grads
    for every trainable tensor of `state` (keys of TRAINABLE_KEYS; the
    grads hold no entry for a frozen leaf); chunk-accumulated when
    pixel_chunks > 1 (MSE only: SSIM windows straddle the chunks; a
    separable model keeps its grid forward when the chunks are whole row
    blocks; a full-grid model takes no chunks).

    `members` (make_loss_fn's): state's leaves carry a leading member axis
    and target_flat is (M, N, out) or (N, out), shared. Each chunk then runs
    one member-axis forward and backward; the members' losses are summed
    and differentiated once (each member's loss reaches its own slices
    only, with the weight 1), so each member's gradient, its chunk sum and
    the 1/k scale have its single fit's bits. The loss is then the (M,)
    vector of the members' losses, each with its single fit's bits.

    `pixel_group` (the module note): coords, target_flat and grid_hw are this
    rank's rows, split in k chunks; the chunk losses and gradients of all
    ranks are added in chunk order over the group, then scaled by
    1/(k · size), so every rank returns the single fit's values with
    pixel_chunks = k · size. Under ms-ssim (k = 1) each rank's loss is the
    whole image's and only the gradients are added over the group."""
    n = coords.shape[0]
    k = int(pixel_chunks)
    total = k * (pixel_group.size if pixel_group is not None else 1)
    if total > 1 and mdef.full_grid:
        raise ValueError(
            f"model {mdef.name!r} renders its full grid only; pixel_chunks={total} needs 1")
    if k > 1 and n % k:
        raise ValueError(f"pixel_chunks={k} must divide pixel count {n}")
    if k > 1 and loss_name == "ms-ssim":
        raise ValueError("loss='ms-ssim' requires pixel_chunks=1")
    whole = loss_name == "ms-ssim" and pixel_group is not None
    chunk_hw = grid_hw
    if k > 1:
        rows_split = grid_hw is not None and mdef.separable and grid_hw[0] % k == 0
        chunk_hw = (grid_hw[0] // k, grid_hw[1]) if rows_split else None
    per_chunk = target_flat.chunk(k, dim=-2)
    chunks = [
        make_loss_fn(mdef, mcfg, c, t, precision, chunk_hw, loss_name, ssim_weight, members,
                     pixel_group if whole else None)
        for c, t in zip(coords.chunk(k), per_chunk)
    ]

    def grad_fn(params):
        keys = [[key for key in layer if key in TRAINABLE_KEYS] for layer in params]
        leaves = [layer[key] for layer, ks in zip(params, keys) for key in ks]
        loss_sum, grad_sum, parts = None, None, []
        for loss_fn in chunks:
            # the transform runs per chunk (as JAX's chunk loss does): each
            # chunk's backward frees its own graph
            loss = loss_fn(transform(params) if transform is not None else params)
            if members:
                differentiated, loss = loss
                g = torch.autograd.grad(differentiated.sum(), leaves)
            else:
                g = torch.autograd.grad(loss, leaves)
            if pixel_group is not None:
                parts.append([loss.detach().reshape(-1), *g])
            elif grad_sum is None:
                loss_sum, grad_sum = loss.detach(), list(g)
            else:
                loss_sum = loss_sum + loss.detach()
                grad_sum = [a + b for a, b in zip(grad_sum, g)]
        if whole:  # every rank's loss is the whole image's: add the gradients only
            loss_sum, grad_sum = loss.detach(), pixel_group.sum(parts[0][1:])
        elif pixel_group is not None:
            loss_sum, *grad_sum = pixel_group.chunk_sum(parts)
            loss_sum = loss_sum.reshape(loss.shape)
        if total > 1 and not whole:
            loss_sum = loss_sum * (1.0 / total)
            grad_sum = [g * (1.0 / total) for g in grad_sum]
        it = iter(grad_sum)
        return loss_sum, tuple({key: next(it) for key in ks} for ks in keys)

    return grad_fn


def _schedule(optim_cfg: OptimConfig, num_steps: int):
    if optim_cfg.lr_schedule == "cosine":
        return cosine_lr(optim_cfg.lr, num_steps, warmup=int(optim_cfg.lr_warmup))
    return step_lr(optim_cfg.lr, optim_cfg.lr_step_size, optim_cfg.lr_gamma)


def init_fit_state(generator: Optional[torch.Generator], mdef: ModelDef, mcfg,
                   optim_cfg: OptimConfig, masking_cfg: Optional[MaskingConfig] = None,
                   init_params=None, device="cpu"):
    """(params, Adam state, MaskState or None) of a fit at step 0: the params
    copied from `init_params` or drawn from `generator`, then for a sparse
    config the initial masks (masking.mask_path's lottery masks, or drawn
    from `generator`) applied to them. The params take no gradient yet
    (set_trainable_)."""
    if init_params is not None:
        params = tuple({k: v.detach().to(device).clone() for k, v in layer.items()}
                       for layer in init_params)
    else:
        params = mdef.init(generator, mcfg, device)
    opt_state = opt_init(params, optim_cfg)
    mask_state = None
    if masking_cfg is not None and not masking_cfg.dense:
        lottery = (load_lottery_masks(masking_cfg.mask_path) if masking_cfg.mask_path
                   else None)
        mask_state = create_mask_state(generator, params, masking_cfg, lottery_masks=lottery)
        apply_masks_(params, mask_state.masks)
    return params, opt_state, mask_state


def _at(tree, m: Optional[int]):
    """Member m of a params-like tree whose leaves carry a leading member axis
    (views); the tree itself when m is None."""
    if m is None:
        return tree
    return tuple({k: v[m] for k, v in layer.items()} for layer in tree)


class SparseFit:
    """The sparse masks of the fit loop: one fit's (`batched` false), or
    those of M fits whose params carry a leading member axis, one MaskState,
    prune-rate schedule, masking config and generator per member. `masks`
    holds what the step multiplies the (stacked) tensors by: the member's
    masks, or each layer's members' masks stacked."""

    def __init__(self, cfgs, states, generators, batched: bool):
        self.cfgs, self.states, self.generators = list(cfgs), list(states), list(generators)
        self.cfg = self.cfgs[0]  # the cadence and the modes, shared by the members
        self.decays = [build_decay(c) for c in self.cfgs]
        self.batched = batched
        self.needs_momentum = "momentum" in (self.cfg.growth_mode,
                                             self.cfg.redistribution_mode)
        self.densities = [total_density(st) for st in self.states]
        self.sparsities = [1.0 - d for d in self.densities]
        self._stack()

    def _stack(self):
        if not self.batched:
            self.masks = self.states[0].masks
            return
        self.masks = tuple(None if ms[0] is None else torch.stack(ms)
                           for ms in zip(*(st.masks for st in self.states)))

    def after_adam_(self, step: int, params, grads, opt_state):
        """Weights re-masked; Adam's moments masked (dense_gradients false);
        each member's decayed prune rate; on the cadence ((step + 1) %
        interval == 0 and step <= end_when) each member's topology update,
        reading this step's grads. Returns the rates, one per member."""
        cfg = self.cfg
        apply_masks_(params, self.masks)
        if not cfg.dense_gradients:
            mask_momentum(opt_state, self.masks)
        rates = [decay(step, s) for decay, s in zip(self.decays, self.sparsities)]
        if (step + 1) % cfg.interval == 0 and step <= cfg.end_when:
            momenta = [adam_momentum(opt_state, i) if self.needs_momentum and mk is not None
                       else None for i, mk in enumerate(self.masks)]
            for m, st in enumerate(self.states):
                at = m if self.batched else None
                mom = momenta if at is None else [None if t is None else t[at] for t in momenta]
                _, st = update_connections(_at(params, at), _at(grads, at), mom, st, rates[m],
                                           self.generators[m], self.cfgs[m])
                self.states[m] = st
                self.densities[m] = total_density(st)
                self.sparsities[m] = 1.0 - self.densities[m]
            self._stack()
        return rates


class EkfacFit:
    """The EKFAC preconditioner of one fit (optim.preconditioner=ekfac):
    its state and `precondition(step, params, grads)`, which captures this
    step's statistics on `params` (before the optimizer moves them),
    updates the moments (the bases too when step % precond_interval == 0)
    and returns the preconditioned grads.

    Over a member axis (`members`: the batched fit's M fits, params and
    grads whose leaves carry a leading member axis, `target_flat` one
    target per member and `state` one EkfacState per member) each member's
    capture runs on its own params and image, and its bases, moments and
    preconditioning are its own: member m has its single fit's bits. With a
    `pixel_group`, coords and targets are this rank's rows and the capture's
    sums run over the group (optim.ekfac.ekfac_update_stats_chunked), so
    every rank holds the same state."""

    def __init__(self, mdef: ModelDef, mcfg, coords, target_flat, optim_cfg: OptimConfig,
                 pixel_chunks: int, state, members: bool = False, pixel_group=None):
        self.mdef, self.mcfg, self.coords, self.target = mdef, mcfg, coords, target_flat
        self.interval = int(optim_cfg.precond_interval)
        self.eps = float(optim_cfg.precond_eps)
        self.chunks = int(pixel_chunks)
        self.state = state
        self.members = members
        self.group = pixel_group

    def precondition(self, step: int, params, grads):
        if not self.members:
            self.state, out = self._one(step, params, grads, self.state, self.target)
            return out
        outs = []
        for m, target in enumerate(self.target):
            self.state[m], out = self._one(step, _at(params, m), _at(grads, m), self.state[m],
                                           target)
            outs.append(out)
        return tuple({k: torch.stack([o[i][k] for o in outs]) for k in layer}
                     for i, layer in enumerate(outs[0]))

    def _one(self, step: int, params, grads, state, target):
        recompute = step % self.interval == 0
        if self.chunks * (self.group.size if self.group is not None else 1) > 1:
            state = ekfac_update_stats_chunked(state, self.mdef, self.mcfg, params, self.coords,
                                               target, self.chunks, recompute_eigs=recompute,
                                               pixel_group=self.group)
        else:
            acts, pgrads = capture_layer_stats(self.mdef, self.mcfg, params, self.coords, target)
            state = ekfac_update_stats(state, acts, pgrads, recompute_eigs=recompute)
            del acts, pgrads
        return state, ekfac_precondition(state, grads, eps=self.eps,
                                         skip=model_skip_indices(self.mdef.name, params))


def check_optim(mdef: ModelDef, train_cfg: TrainConfig, optim_cfg: OptimConfig,
                checkpointing: bool = False) -> bool:
    """Raise ValueError for what the fit does not run with these optimizer
    options (the JAX package's guards); returns whether EKFAC is on."""
    pre = optim_cfg.preconditioner
    if pre not in (None, "", "ekfac"):
        raise ValueError(f"optim.preconditioner must be ekfac or unset, got {pre!r}")
    use_ekfac = pre == "ekfac"
    if use_ekfac and int(train_cfg.pixel_chunks) > 1 and mdef.full_grid:
        raise ValueError("preconditioner='ekfac' with pixel_chunks>1 is undefined for "
                         f"full-grid models ({mdef.name})")
    if use_ekfac and mdef.name.startswith("feather"):
        raise ValueError("preconditioner='ekfac' does not support Feathermap models")
    if checkpointing and optim_cfg.name != "adam":
        raise ValueError("checkpoint/resume supports adam fits (plain or ekfac)")
    return use_ekfac


def optimizer_step(step: int, params, grads, opt_state, lr, optim_cfg: OptimConfig,
                   sparse: Optional[SparseFit] = None, stats: Optional[dict] = None,
                   ekfac: Optional[EkfacFit] = None, members: bool = False):
    """The fit loop's step after the gradients, in the JAX package's order,
    for one fit or (`members`) for M fits over a member axis (the batched
    fit and the density ladder): grads masked when dense_gradients is
    false; EKFAC's preconditioning when `ekfac` is given; the optimizer (in
    place; each member keeps its own bits: Adam is elementwise, the clip and
    Shampoo act per member, optim.opt_update); then `SparseFit.after_adam_`.
    Returns (params, opt_state, the members' prune rates or None for a
    dense fit)."""
    if sparse is not None and not sparse.cfg.dense_gradients:
        mask_grads(grads, sparse.masks)
    if ekfac is not None:
        grads = ekfac.precondition(step, params, grads)
    params, opt_state = opt_update(grads, opt_state, params, lr, optim_cfg, stats=stats,
                                   members=members)
    rates = sparse.after_adam_(step, params, grads, opt_state) if sparse is not None else None
    return params, opt_state, rates


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
    checkpoint_path=None,
    resume_from=None,
    watch: Optional[Callable] = None,
    stop_psnr: Optional[float] = None,
    pixel_group=None,
) -> FitResult:
    """Run one fit on `device` (default: the grid's); returns the final
    params, per-step metric arrays and, for a sparse masking config, the
    final MaskState. `generator` (CPU) draws the init weights, then the
    initial masks and any random growth; a resumed fit takes the
    generator's state from a port checkpoint. `checkpoint_path`, `watch`
    and `stop_psnr` act at the boundaries (module note); `resume_from`
    continues from a checkpoint. `pixel_group` (module note): grid and img
    are the whole lattice, this rank fits its rows, every rank returns the
    same result and only the group's rank 0 writes the checkpoint."""
    device = torch.device(device) if device is not None else grid.device
    n = train_cfg.num_steps
    precision = train_cfg.precision
    early, switch = plan_precision_schedule(train_cfg, n)
    if pixel_group is not None:
        check_pixel_group(mdef, pixel_group, grid.shape[0])
        rows = pixel_rows(grid.shape[0], pixel_group)
        grid, img = grid[rows], np.asarray(img)[rows]
    h, w, c = grid.shape
    coords = grid.to(device).reshape(h * w, c)
    target = torch.as_tensor(np.asarray(img), dtype=torch.float32).to(device)
    target_flat = target.reshape(h * w, -1)
    sparse = masking_cfg is not None and not masking_cfg.dense
    use_ekfac = check_optim(mdef, train_cfg, optim_cfg,
                            checkpointing=checkpoint_path is not None or resume_from is not None)

    start = 0
    mask_state = None
    ekfac_state = None
    if resume_from is not None:
        ck = load_checkpoint(resume_from, device)
        start = ck["step"]
        if start >= n:
            raise ValueError(f"checkpoint is at step {start} >= num_steps {n}; nothing to resume")
        if "opt_state" not in ck:
            raise ValueError(f"{resume_from} holds no Adam state to resume from")
        params = tuple({k: v.clone() for k, v in layer.items()} for layer in ck["params"])
        opt_state = ck["opt_state"]
        if sparse:
            if "mask_state" not in ck:
                raise ValueError(f"{resume_from} holds no mask state to resume a sparse fit from")
            mask_state = ck["mask_state"]
            if bool(torch.isnan(mask_state.final_sparsity)):
                mask_state = mask_state._replace(final_sparsity=torch.tensor(
                    1.0 - masking_cfg.final_density, dtype=torch.float32, device=device))
        if "generator_state" in ck:
            generator.set_state(ck["generator_state"])
        if use_ekfac:
            if "ekfac_state" not in ck:
                raise ValueError("resume with preconditioner='ekfac' needs a checkpoint written "
                                 f"by an ekfac fit (no EKFAC state found in {resume_from})")
            ekfac_state = ck["ekfac_state"]
    else:
        params, opt_state, mask_state = init_fit_state(generator, mdef, mcfg, optim_cfg,
                                                       masking_cfg, init_params, device)
        if use_ekfac:
            ekfac_state = ekfac_init(params, model_skip_indices(mdef.name, params))
    ekfac = (EkfacFit(mdef, mcfg, coords, target_flat, optim_cfg, train_cfg.pixel_chunks,
                      ekfac_state, pixel_group=pixel_group) if use_ekfac else None)
    set_trainable_(params, True)
    grad_fns = {}

    def grad_fn(prec):
        if prec not in grad_fns:
            grad_fns[prec] = make_grad_fn(
                mdef, mcfg, coords, target_flat, prec, train_cfg.pixel_chunks, grid_hw=(h, w),
                loss_name=train_cfg.loss, ssim_weight=train_cfg.ssim_weight,
                pixel_group=pixel_group)
        return grad_fns[prec]

    schedule = _schedule(optim_cfg, n)

    sparse_fit = SparseFit([masking_cfg], [mask_state], [generator], False) if sparse else None

    boundaries = set()
    if checkpoint_path is not None or watch is not None or stop_psnr is not None:
        boundaries = set(segment_boundaries(n, train_cfg.segment_steps, switch, start))
    # the stop check's precision: JAX's eval_psnr runs under no
    # default_matmul_precision (one bf16 pass), with the fit's compute dtype
    stop_prec = precision_from_config(None, train_cfg.mixed_precision)
    stopped_at = stop_db = None
    clip_stats = {} if float(optim_cfg.grad_clip or 0.0) > 0 else None

    losses, densities, rates, clip_scales = [], [], [], []
    evals = {}
    synchronize(device)
    t0 = time.perf_counter()
    end = n
    for step in range(start, n):
        prec = early if early is not None and step < switch else precision
        loss, grads = grad_fn(prec)(params)
        params, opt_state, rate = optimizer_step(step, params, grads, opt_state, schedule(step),
                                                 optim_cfg, sparse_fit, stats=clip_stats,
                                                 ekfac=ekfac)
        losses.append(loss)
        if clip_stats is not None:
            clip_scales.append(clip_stats["clip_scale"])
        if sparse:
            rates.append(rate[0])
            densities.append(sparse_fit.densities[0])
        if (step + 1) % train_cfg.log_steps == 0 or step == n - 1:
            with torch.no_grad():
                pred = forward_flat(mdef, mcfg, params, coords, (h, w), prec)
                evals[step] = eval_scores([pred], [target_flat], pixel_group)[0]
        if step + 1 in boundaries:
            if checkpoint_path is not None and (pixel_group is None or pixel_group.rank == 0):
                save_checkpoint(checkpoint_path, params, opt_state,
                                sparse_fit.states[0] if sparse else None, generator, step + 1,
                                ekfac_state=ekfac.state if ekfac is not None else None)
            if watch is not None:
                watch(params, opt_state, step + 1)
            if stop_psnr is not None:
                with torch.no_grad():
                    pred = forward_flat(mdef, mcfg, params, coords, (h, w), stop_prec)
                    val = float(eval_scores([pred], [target_flat], pixel_group)[0, 1])
                if val >= stop_psnr:
                    stopped_at, stop_db, end = step + 1, val, step + 1
                    break
    synchronize(device)
    wall = time.perf_counter() - t0

    executed = end - start
    metrics = {k: np.full(executed, np.nan, np.float32)
               for k in ("test_loss", "psnr", "psnr_8bit")}
    metrics["loss"] = (torch.stack(losses).cpu().numpy() if losses
                       else np.zeros(0, np.float32))
    metrics["density"] = _host_array(densities) if sparse else np.ones(executed, np.float32)
    metrics["prune_rate"] = _host_array(rates) if sparse else np.zeros(executed, np.float32)
    if clip_stats is not None:
        metrics["clip_scale"] = _host_array(clip_scales)
    for step, vals in evals.items():
        tl, p, p8 = vals.cpu().numpy()
        i = step - start
        metrics["test_loss"][i], metrics["psnr"][i], metrics["psnr_8bit"][i] = tl, p, p8
    set_trainable_(params, False)
    return FitResult(params=params, opt_state=opt_state, metrics=metrics,
                     wall_seconds=wall, mask_state=sparse_fit.states[0] if sparse else None,
                     stopped_at=stopped_at, stop_psnr_db=stop_db)
