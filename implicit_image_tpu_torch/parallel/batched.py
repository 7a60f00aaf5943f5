"""Batched fits over a member axis on one device (counterpart of
implicit_image_tpu/parallel/batched.py).

The JAX package vmaps the whole fit, `make_fit_fn`, over a batch of (key,
image) pairs and compiles it once. Here M fits of one model shape run in
one Python loop whose leaves carry a leading member axis: each step makes
one member-axis forward and backward for all members, with the coordinates
shared and a target per member (training.fit.make_grad_fn with `members`:
the single fit's loss and gradient in their member-axis form). For SIREN
with the polynomial sine that is one `sine_mlp_fwd_batched` and one
`sine_mlp_bwd_batched` launch per step and pixel chunk (the member-axis K1
and K2, in every precision mode, "+mixed" too); wavelet-SIREN launches them
once per sub-SIREN; every other family (CoordX, Fourier, hashgrid, SIREN
with the exact sine, Feathermap over any of them) runs its forward under
torch.func.vmap (models.ModelDef.apply_members).

Every fit option of the single fit's step rides the member axis as JAX's
vmap carries it: train.pixel_chunks (each member's gradient summed in the
single fit's chunk order), train.loss=ms-ssim (each member on its own
image), train.mixed_precision, the precision schedule, optim.grad_clip (a
global norm per member), optim=shampoo (one factor stack per member) and
optim.preconditioner=ekfac (each member's capture, bases and moments its
own: training.fit.EkfacFit). Masks, the prune rate and the topology update
apply member by member (training.fit.SparseFit), every `interval` steps.
The step after the gradients is the single fit's own
(training.fit.optimizer_step), and so is each member's init
(training.fit.init_fit_state): member m of a batched fit has the bits of
`fit(member_generators(g, M)[m], ...)` on its image wherever it runs the
single fit's own ops (the fused SIREN on the CPU and the card; the vmapped
families agree to the last few bits: a batched product may sum in another
order).

What raises (check_member_axis) is what the single fit refuses too:
ms-ssim with pixel_chunks > 1, pixel chunks of a full-grid model, EKFAC
on a Feathermap model or with chunks of a full-grid model. The JAX
package's segment split and `estimate_step_flops` are TPU scaffolding and
have no counterpart; its batched fit takes no checkpoint, watch or early
stop, and neither does this one.

On a mesh (`mesh`, parallel/mesh.py) the members split over the "image"
ranks, contiguously (B must divide by the axis), each member keeping the
generator it has without the mesh, and each member's rows split over the
"pixel" ranks (training.fit's pixel group: with train.pixel_chunks = k,
each member's gradient is its single fit's with k · pixel chunks). The
results are gathered over the image ranks in member order, so every rank
returns the FitResult of the same fit without the mesh at pixel_chunks =
k · pixel: the same bits wherever each member's forward and backward have
their single launch's (the fused SIREN).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.ops.sine_mlp import stack_members
from implicit_image_tpu_torch.optim import opt_init
from implicit_image_tpu_torch.optim.ekfac import ekfac_init, model_skip_indices
from implicit_image_tpu_torch.parallel.collectives import gather_members
from implicit_image_tpu_torch.sparsity import MaskingConfig, MaskState
from implicit_image_tpu_torch.training.fit import (
    EkfacFit,
    FitResult,
    OptimConfig,
    SparseFit,
    TrainConfig,
    _host_array,
    _schedule,
    check_optim,
    check_pixel_group,
    eval_scores,
    forward_members,
    init_fit_state,
    make_grad_fn,
    optimizer_step,
    pixel_rows,
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
                      optim_cfg: OptimConfig) -> bool:
    """Raise ValueError, before anything runs, for what a fit over a member
    axis does not run: only what the JAX package refuses in its fit too
    (each message names the reason). Returns whether EKFAC is on."""
    k = int(train_cfg.pixel_chunks)
    if train_cfg.loss not in ("mse", "ms-ssim"):
        raise ValueError(f"train.loss must be 'mse' or 'ms-ssim', got {train_cfg.loss!r}")
    if k > 1 and train_cfg.loss == "ms-ssim":
        # the SSIM windows straddle the chunks, as in the JAX package
        raise ValueError("loss='ms-ssim' requires pixel_chunks=1")
    if k > 1 and mdef.full_grid:
        raise ValueError(
            f"model {mdef.name!r} renders its full grid only; pixel_chunks={k} needs 1")
    return check_optim(mdef, train_cfg, optim_cfg)


def member_share(b: int, mesh) -> slice:
    """The members of this rank's image coordinate: a contiguous 1/image of
    b (ValueError unless the image axis divides b)."""
    n = mesh.shape["image"]
    if b % n:
        raise ValueError(f"{b} members do not split over image axis {n}")
    return slice(mesh.image.rank * (b // n), (mesh.image.rank + 1) * (b // n))


def fit_members(generators: Sequence[torch.Generator], mdef: ModelDef, mcfg,
                grid: torch.Tensor, targets, train_cfg: TrainConfig, optim_cfg: OptimConfig,
                masking_cfgs: Optional[Sequence[MaskingConfig]] = None, init_params=None,
                device="cuda", mesh=None, pixel_group=None) -> FitResult:
    """The member-axis fit loop of `batched_fit`, the density ladder and
    meta-training's inner loop: M = len(generators) fits of one model shape
    on `device` (the grid moves there; "cpu" runs the plain versions).
    targets: (M, H, W, C), one image per member, or (H, W, C), shared; numpy
    or a tensor on any device. masking_cfgs: None for dense fits, else one
    config per member (members may differ in density and final_density
    only: the cadence and the modes are member 0's). Member m starts from
    `init_fit_state(generators[m], ..., masking_cfgs[m], init_params)` (a
    warm dense fit draws nothing: its generators may be None). Returns a FitResult
    whose params, optimizer state, masks, mask scalars and metric arrays
    carry a leading member axis (with grad_clip, metrics["clip_scale"] too).
    On a `mesh` (module note) the fit runs on mesh.device and every rank
    returns every member; `pixel_group` alone splits each member's rows
    (training.fit's module note)."""
    use_ekfac = check_member_axis(mdef, mcfg, train_cfg, optim_cfg)
    b = len(generators)
    if b == 0:
        raise ValueError("no members")
    if mesh is not None:
        share = member_share(b, mesh)
        if np.ndim(targets) == 4:
            targets = targets[share]
        res = fit_members(list(generators)[share], mdef, mcfg, grid, targets, train_cfg,
                          optim_cfg, None if masking_cfgs is None else list(masking_cfgs)[share],
                          init_params, mesh.device, pixel_group=mesh.pixel)
        return gather_members(res, mesh.image)
    device = torch.device(device)
    if pixel_group is not None:
        check_pixel_group(mdef, pixel_group, grid.shape[0])
        rows = pixel_rows(grid.shape[0], pixel_group)
        grid = grid[rows]
        targets = targets[rows] if np.ndim(targets) == 3 else targets[:, rows]
    n = train_cfg.num_steps
    precision = train_cfg.precision
    early, switch = plan_precision_schedule(train_cfg, n)
    h, w, c = grid.shape
    coords = grid.to(device).reshape(h * w, c)
    target = torch.as_tensor(targets if isinstance(targets, torch.Tensor) else np.asarray(targets),
                             dtype=torch.float32, device=device)
    if target.dim() == 3:  # one image shared by the members
        target_flat = target.reshape(h * w, -1)
        member_targets = [target_flat] * b
    elif target.shape[0] == b:
        target_flat = target.reshape(b, h * w, -1)
        member_targets = list(target_flat)
    else:
        raise ValueError(f"{target.shape[0]} targets for {b} members")
    sparse = masking_cfgs is not None and not masking_cfgs[0].dense
    if masking_cfgs is not None and len(masking_cfgs) != b:
        raise ValueError(f"{len(masking_cfgs)} masking configs for {b} members")

    inits = [init_fit_state(gen, mdef, mcfg, optim_cfg, masking_cfgs[m] if sparse else None,
                            init_params, device) for m, gen in enumerate(generators)]
    params = stack_members([p for p, _, _ in inits])
    set_trainable_(params, True)
    opt_state = opt_init(params, optim_cfg, members=True)
    ekfac = None
    if use_ekfac:
        skip = model_skip_indices(mdef.name, inits[0][0])
        ekfac = EkfacFit(mdef, mcfg, coords, member_targets, optim_cfg, train_cfg.pixel_chunks,
                         [ekfac_init(p, skip) for p, _, _ in inits], members=True,
                         pixel_group=pixel_group)
    sparse_fit = (SparseFit(masking_cfgs, [ms for _, _, ms in inits], generators, True)
                  if sparse else None)
    del inits
    schedule = _schedule(optim_cfg, n)
    grad_fns = {}

    def grad_fn(prec):
        if prec not in grad_fns:
            grad_fns[prec] = make_grad_fn(
                mdef, mcfg, coords, target_flat, prec, train_cfg.pixel_chunks, grid_hw=(h, w),
                loss_name=train_cfg.loss, ssim_weight=train_cfg.ssim_weight, members=True,
                pixel_group=pixel_group)
        return grad_fns[prec]

    clip_stats = {} if float(optim_cfg.grad_clip or 0.0) > 0 else None
    losses, densities, rates, evals, clip_scales = [], [], [], {}, []
    synchronize(device)
    t0 = time.perf_counter()
    for step in range(n):
        prec = early if early is not None and step < switch else precision
        loss, grads = grad_fn(prec)(params)
        params, opt_state, rate = optimizer_step(step, params, grads, opt_state, schedule(step),
                                                 optim_cfg, sparse_fit, stats=clip_stats,
                                                 ekfac=ekfac, members=True)
        losses.append(loss)
        if clip_stats is not None:
            clip_scales.append(clip_stats["clip_scale"])
        if sparse:
            rates.append(rate)
            densities.append(list(sparse_fit.densities))
        if (step + 1) % train_cfg.log_steps == 0 or step == n - 1:
            with torch.no_grad():
                preds = forward_members(mdef, mcfg, params, coords, (h, w), prec).unbind(0)
                evals[step] = eval_scores(preds, member_targets, pixel_group)
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
    if clip_stats is not None:
        metrics["clip_scale"] = (torch.stack(clip_scales).T.cpu().numpy() if clip_scales
                                 else np.zeros((b, 0), np.float32))
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
                        init_params=None, device="cuda", mesh=None):
    """fit(generators (B,), imgs (B, H, W, C)) -> a FitResult whose leaves
    carry a leading member axis: B fits of one configuration, one image and
    one generator each, over the member axis, on `device`. `init_params` (unbatched)
    warm-starts every member from the same meta-init (training/metainit.py).
    With a `mesh` the members split over its image ranks and their rows over
    its pixel ranks, on mesh.device (module note). What the fit refuses
    raises here (check_member_axis; check_pixel_group on a mesh)."""
    check_member_axis(mdef, mcfg, train_cfg, optim_cfg)
    if mesh is not None:
        check_pixel_group(mdef, mesh.pixel, grid.shape[0])

    def fit_fn(generators, imgs):
        cfgs = None if masking_cfg is None else [masking_cfg] * len(generators)
        return fit_members(generators, mdef, mcfg, grid, imgs, train_cfg, optim_cfg, cfgs,
                           init_params, device, mesh=mesh)

    return fit_fn


def batched_fit(generator: torch.Generator, mdef: ModelDef, mcfg, grid: torch.Tensor, imgs,
                train_cfg: TrainConfig, optim_cfg: OptimConfig,
                masking_cfg: Optional[MaskingConfig] = None, init_params=None,
                device="cuda", mesh=None) -> FitResult:
    """Fit a batch of images (B, H, W, C) together on `device` (the grid
    moves there; "cpu" runs the plain versions): member i draws from
    member_generators(generator, B)[i]. With a `mesh`, on its image and
    pixel ranks (module note); every rank returns the whole batch."""
    imgs = np.asarray(imgs)
    fit_fn = make_batched_fit_fn(mdef, mcfg, grid, train_cfg, optim_cfg, masking_cfg,
                                 init_params, device, mesh)
    return fit_fn(member_generators(generator, imgs.shape[0]), imgs)
