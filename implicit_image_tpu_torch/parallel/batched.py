"""Batched fits over a member axis on one device (counterpart of
implicit_image_tpu/parallel/batched.py).

The JAX package vmaps the whole fit over a batch of (key, image) pairs and
compiles it once. Here M fits of one SIREN shape run in one Python loop
whose leaves carry a leading member axis: each step makes one forward and
one backward launch for all members (`sine_mlp_fwd_batched`,
`sine_mlp_bwd_batched`, the member-axis K1 and K2), with the coordinates
shared and a target per member. Adam runs on the stacked leaves; it is
elementwise, so each member keeps its own bits. Masks, the prune rate and
the topology update apply member by member (training.fit.SparseFit), every
`interval` steps. The step after the gradients is the single fit's own
(training.fit.optimizer_step), and so is each member's init
(training.fit.init_fit_state): member m of a batched fit has the bits of
`fit(member_generators(g, M)[m], ...)` on its image.

The precision schedule rides as in the single fit (both kernel modes have a
member-axis instantiation). Not in this slice, and raising ValueError: model
families other than SIREN with the polynomial sine (CoordX, hashgrid,
wavelet-SIREN, Fourier, Feathermap: the next part of M14a, ROADMAP.md),
train.pixel_chunks > 1, train.loss=ms-ssim, train.mixed_precision (no
member-axis kernel), optim.grad_clip, optim=shampoo and
optim.preconditioner (M14a too). The JAX package's segment split,
`estimate_step_flops` and the mesh are TPU scaffolding and have no
counterpart.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.ops.metrics import mse, psnr_8bit
from implicit_image_tpu_torch.ops.sine_mlp import siren_apply_flat_batched_fused, stack_members
from implicit_image_tpu_torch.optim import opt_init
from implicit_image_tpu_torch.optim.adam import TRAINABLE_KEYS
from implicit_image_tpu_torch.sparsity import MaskingConfig, MaskState
from implicit_image_tpu_torch.training.fit import (
    FitResult,
    OptimConfig,
    SparseFit,
    TrainConfig,
    _host_array,
    _schedule,
    init_fit_state,
    optimizer_step,
    plan_precision_schedule,
    set_trainable_,
    synchronize,
)

__all__ = ["member_generators", "check_member_axis", "fit_members", "make_batched_fit_fn",
           "batched_fit"]


def member_generators(generator: torch.Generator, b: int):
    """b CPU generators, one per member: the counterpart of
    jax.random.split(key, b). Member i's is seeded with the i-th of b
    integers in [0, 2^62) drawn one at a time from `generator` (which
    advances), so the first k of b members get the generators that
    member_generators of a generator in the same state gives for k."""
    seeds = [int(torch.randint(0, 2**62, (1,), generator=generator)) for _ in range(b)]
    return [torch.Generator().manual_seed(s) for s in seeds]


def check_member_axis(mdef: ModelDef, mcfg, train_cfg: TrainConfig,
                      optim_cfg: OptimConfig) -> None:
    """Raise ValueError for what a fit over a member axis does not run in
    this slice (module note)."""
    if mdef.name != "siren" or not getattr(mcfg, "fast_sine", True):
        what = f"mlp={mdef.name}" if mdef.name != "siren" else "mlp.fast_sine=false"
        raise ValueError(
            f"a fit over a member axis runs the fused SIREN only; {what} is the next part of "
            "M14a (ROADMAP.md Queue 1): fit it with compress.main, one run at a time")
    if int(train_cfg.pixel_chunks) > 1:
        raise ValueError(f"train.pixel_chunks={train_cfg.pixel_chunks}: a fit over a member "
                         "axis takes the whole grid (pixel_chunks=1) in this slice")
    if train_cfg.loss != "mse":
        raise ValueError(f"train.loss={train_cfg.loss!r}: a fit over a member axis takes "
                         "loss=mse in this slice")
    if train_cfg.mixed_precision:
        raise ValueError("train.mixed_precision: the member-axis kernels have no "
                         "'+mixed' instantiation")
    if float(optim_cfg.grad_clip or 0.0) > 0:
        raise ValueError("optim.grad_clip: a fit over a member axis does not clip yet")
    # Shampoo would matricize the stacked (M, in, out) leaves as 3-D tensors
    # and mix the members; EKFAC's capture is per fit
    if optim_cfg.name != "adam":
        raise ValueError(f"optim={optim_cfg.name}: a fit over a member axis runs Adam only; "
                         "Shampoo there is part of M14a (ROADMAP.md Queue 1): fit it with "
                         "compress.main, one run at a time")
    if optim_cfg.preconditioner:
        raise ValueError(f"optim.preconditioner={optim_cfg.preconditioner}: a fit over a member "
                         "axis takes no preconditioner; EKFAC there is part of M14a "
                         "(ROADMAP.md Queue 1): fit it with compress.main, one run at a time")


def fit_members(generators: Sequence[torch.Generator], mdef: ModelDef, mcfg,
                grid: torch.Tensor, targets, train_cfg: TrainConfig, optim_cfg: OptimConfig,
                masking_cfgs: Optional[Sequence[MaskingConfig]] = None, init_params=None,
                device="cuda") -> FitResult:
    """The member-axis fit loop of `batched_fit`, the density ladder and
    meta-training's inner loop: M = len(generators) fits of one SIREN shape
    on `device` (the grid moves there; "cpu" runs the plain versions).
    targets: (M, H, W, C), one image per member, or (H, W, C), shared; numpy
    or a tensor on any device. masking_cfgs: None for dense fits, else one
    config per member (members may differ in density and final_density
    only: the cadence and the modes are member 0's). Member m starts from
    `init_fit_state(generators[m], ..., masking_cfgs[m], init_params)` (a
    warm dense fit draws nothing: its generators may be None). Returns a FitResult
    whose params, Adam moments, masks, mask scalars and metric arrays carry
    a leading member axis."""
    check_member_axis(mdef, mcfg, train_cfg, optim_cfg)
    device = torch.device(device)
    b = len(generators)
    if b == 0:
        raise ValueError("no members")
    n = train_cfg.num_steps
    precision = train_cfg.precision
    early, switch = plan_precision_schedule(train_cfg, n)
    h, w, c = grid.shape
    coords = grid.to(device).reshape(h * w, c)
    target = torch.as_tensor(targets if isinstance(targets, torch.Tensor) else np.asarray(targets),
                             dtype=torch.float32, device=device)
    if target.dim() == 3:
        target_flat = [target.reshape(h * w, -1)] * b
    elif target.shape[0] == b:
        target_flat = [t.reshape(h * w, -1) for t in target]
    else:
        raise ValueError(f"{target.shape[0]} targets for {b} members")
    sparse = masking_cfgs is not None and not masking_cfgs[0].dense
    if masking_cfgs is not None and len(masking_cfgs) != b:
        raise ValueError(f"{len(masking_cfgs)} masking configs for {b} members")

    inits = [init_fit_state(gen, mdef, mcfg, optim_cfg, masking_cfgs[m] if sparse else None,
                            init_params, device) for m, gen in enumerate(generators)]
    params = stack_members([p for p, _, _ in inits])
    set_trainable_(params, True)
    opt_state = opt_init(params, optim_cfg)
    sparse_fit = (SparseFit(masking_cfgs, [ms for _, _, ms in inits], generators, True)
                  if sparse else None)
    schedule = _schedule(optim_cfg, n)
    keys = [[k for k in layer if k in TRAINABLE_KEYS] for layer in params]

    def grads_of(prec):
        # each member's loss on its own output slice, as a single fit's; the
        # sum's gradient reaches every member's loss as 1
        leaves = [layer[k] for layer, ks in zip(params, keys) for k in ks]
        preds = siren_apply_flat_batched_fused(params, coords, mcfg, prec).unbind(0)
        losses = [mse(p, t) for p, t in zip(preds, target_flat)]
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        it = iter(torch.autograd.grad(total, leaves))
        grads = tuple({k: next(it) for k in ks} for ks in keys)
        return torch.stack([loss.detach() for loss in losses]), grads

    losses, densities, rates, evals = [], [], [], {}
    synchronize(device)
    t0 = time.perf_counter()
    for step in range(n):
        prec = early if early is not None and step < switch else precision
        loss, grads = grads_of(prec)
        params, opt_state, rate = optimizer_step(step, params, grads, opt_state, schedule(step),
                                                 optim_cfg, sparse_fit)
        losses.append(loss)
        if sparse:
            rates.append(rate)
            densities.append(list(sparse_fit.densities))
        if (step + 1) % train_cfg.log_steps == 0 or step == n - 1:
            with torch.no_grad():
                preds = siren_apply_flat_batched_fused(params, coords, mcfg, prec).unbind(0)
                rows = []
                for pred, t in zip(preds, target_flat):
                    test_loss = mse(pred, t)
                    rows.append(torch.stack([test_loss, 10.0 * torch.log10(1.0 / test_loss),
                                             psnr_8bit(pred, t)]))
                evals[step] = torch.stack(rows)
    synchronize(device)
    wall = time.perf_counter() - t0

    metrics = {k: np.full((b, n), np.nan, np.float32) for k in ("test_loss", "psnr", "psnr_8bit")}
    metrics["loss"] = (torch.stack(losses).T.cpu().numpy() if losses
                       else np.zeros((b, 0), np.float32))
    if sparse:
        metrics["density"] = np.stack([_host_array([d[m] for d in densities])
                                       for m in range(b)])
        metrics["prune_rate"] = np.stack([_host_array([r[m] for r in rates]) for m in range(b)])
    else:
        metrics["density"] = np.ones((b, n), np.float32)
        metrics["prune_rate"] = np.zeros((b, n), np.float32)
    for step, vals in evals.items():
        for k, col in zip(("test_loss", "psnr", "psnr_8bit"), vals.cpu().numpy().T):
            metrics[k][:, step] = col
    set_trainable_(params, False)
    return FitResult(params=params, opt_state=opt_state, metrics=metrics, wall_seconds=wall,
                     mask_state=MaskState(sparse_fit.masks, *[
                         torch.stack(v) for v in list(zip(*sparse_fit.states))[1:]])
                     if sparse else None)


def make_batched_fit_fn(mdef: ModelDef, mcfg, grid: torch.Tensor, train_cfg: TrainConfig,
                        optim_cfg: OptimConfig, masking_cfg: Optional[MaskingConfig] = None,
                        init_params=None, device="cuda"):
    """fit(generators (B,), imgs (B, H, W, C)) -> a FitResult whose leaves
    carry a leading member axis: B fits of one configuration, one image and
    one generator each, over the member axis, on `device`. `init_params` (unbatched)
    warm-starts every member from the same meta-init (training/metainit.py).
    What the member axis does not run raises here (check_member_axis)."""
    check_member_axis(mdef, mcfg, train_cfg, optim_cfg)

    def fit_fn(generators, imgs):
        cfgs = None if masking_cfg is None else [masking_cfg] * len(generators)
        return fit_members(generators, mdef, mcfg, grid, imgs, train_cfg, optim_cfg, cfgs,
                           init_params, device)

    return fit_fn


def batched_fit(generator: torch.Generator, mdef: ModelDef, mcfg, grid: torch.Tensor, imgs,
                train_cfg: TrainConfig, optim_cfg: OptimConfig,
                masking_cfg: Optional[MaskingConfig] = None, init_params=None,
                device="cuda") -> FitResult:
    """Fit a batch of images (B, H, W, C) together on `device` (the grid
    moves there; "cpu" runs the plain versions): member i draws from member_generators(generator, B)[i]."""
    imgs = np.asarray(imgs)
    fit_fn = make_batched_fit_fn(mdef, mcfg, grid, train_cfg, optim_cfg, masking_cfg,
                                 init_params, device)
    return fit_fn(member_generators(generator, imgs.shape[0]), imgs)
