"""The quantization finetune (counterpart of
implicit_image_tpu/training/quant_phase.py): k-means codebooks or QAT.

KMeans: the quantized layers are clustered once (quantize_weight, then
ecvq_refine when quant.ecvq_lambda > 0); their labels are frozen and the
finetune trains the per-layer centroids — gradients flow through the
`centroids[labels]` gather, so each centroid's gradient is the sum over its
cluster (quant.kmeans.gather_centroids, the same bits on every run) —
together with the unquantized layers and all biases. The 0-centroid's
gradient is zeroed every step so it stays exactly 0. A fresh Adam runs
under StepLR(1000, 0.5) from quant.lr (or the fit's lr).

With the sparse fit's `masks`, the reconstructed weights are masked before
every forward, as in JAX, so pruned weights stay exactly 0.

Delta mode (quant.delta, `offset_params`: the meta-init artifact the fit
started from, shared with the decoder): the quantized layers cluster the
residual w - offset, and the weight is reconstructed as
(offset + centroids[labels]) * (labels != 0) wherever the finetune runs
its forward.

QAT (quant=qat): the straight-through estimator on the latent weights, as
the JAX package's. Every step snaps them (quantize_params: per channel or
per tensor), forwards snapped.detach() + w - w.detach() (the value is the
snapped weight, up to the last bit of that sum, as in JAX; the gradient
goes to w), masked, through the same chain as the fit (K1/K2 for SIREN on
the card: K2 differentiates with respect to the weights it is given, and
the identity routes that to the latent). The grads are masked, the
optimizer steps, and the latent is re-masked; at the end `convert`
freezes the codes and the snapped params are masked once more, so pruned
weights stay exactly 0.

Either mode's optimizer is the fit's (optim_cfg: Adam, or Shampoo under
optim=shampoo), fresh, under StepLR(1000, 0.5) from quant.lr (or the fit's
lr); EKFAC does not act here, as in the JAX package.

A separable model (CoordX) runs its grid forward, also on the row-strided
target grid (every s-th row of a tensor-product grid is one too).

`quant_finetune_members` is the same finetune, in the same code, over a
member axis (the JAX package's jax.vmap of make_quant_fit_fn in its
batched pipeline and ladder): the members' params stacked, k-means (and ECVQ) or the QAT snap
per member on its own weights, then one member-axis forward and backward
per step for all members (training.fit.make_grad_fn with `members`: on the
card one K1 and one K2 launch over the member axis for a SIREN), the
optimizer on the stacked state (Shampoo per member), each member against
its own target and with its own masks. Each member's codebooks, labels and
finetuned params have the bits of its own `quant_finetune` wherever the
member-axis forward has the single forward's bits (the fused SIREN).

Either takes a pixel group (`pixel_group`, the mesh's "pixel" axis: the
JAX package's finetune with its target row-sharded): the target's rows
(after quant.row_stride) split over the ranks, the chunk losses, gradients
and the final scores summed over the group in rank order
(training.fit.make_grad_fn, eval_scores), so every rank finetunes the same
codebooks with the bits of the single finetune at pixel_chunks · size
chunks. A full-grid model's DWT lattices split instead (training.fit's
`lattice_split`): every rank holds the whole target and takes the whole
image's loss, and the gradients are added over the group.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.ops.metrics import mse, psnr_8bit
from implicit_image_tpu_torch.optim import opt_init, opt_update, step_lr
from implicit_image_tpu_torch.quant import (
    LayerCodebook,
    QuantConfig,
    convert,
    ecvq_refine,
    quantize_params,
    quantize_weight,
    quantized_layer_indices,
)
from implicit_image_tpu_torch.quant.kmeans import gather_centroids
from implicit_image_tpu_torch.sparsity import apply_masks, apply_masks_, mask_grads
from implicit_image_tpu_torch.ops.sine_mlp import stack_members
from implicit_image_tpu_torch.training.fit import (
    OptimConfig,
    _at,
    eval_group,
    eval_scores,
    forward_flat,
    forward_members,
    local_rows,
    make_grad_fn,
    set_trainable_,
    synchronize,
)

__all__ = ["QuantResult", "quant_finetune", "quant_finetune_members"]


class QuantResult(NamedTuple):
    params: Any  # snapped params (weights == centroids[labels], or codes * scales)
    codebooks: Any  # per-layer LayerCodebook, PerChannelCodebook or None
    metrics: Dict[str, Any]
    wall_seconds: float


def _reconstruct(state, labels, offsets, masks=None, members: bool = False):
    """Params with w = centroids[labels] for the quantized layers (delta:
    (offset + centroids[labels]) * (labels != 0)), then masked when masks
    are given. `members`: state, labels and masks carry a leading member
    axis (each member gathers from its own centroids)."""
    out = []
    for layer, lab, off in zip(state, labels, offsets):
        if lab is None:
            out.append(layer)
            continue
        rest = {k: v for k, v in layer.items() if k != "centroids"}
        if members:
            w = torch.stack([gather_centroids(c, lm) for c, lm in
                             zip(layer["centroids"].unbind(0), lab.unbind(0))])
        else:
            w = gather_centroids(layer["centroids"], lab)
        if off is not None:
            w = (w + off) * (lab != 0)
        out.append(rest | {"w": w})
    if masks is not None and any(m is not None for m in masks):
        return apply_masks(tuple(out), masks)
    return tuple(out)


def _ste(latent, cfg: QuantConfig, masks, members: int = 0):
    """The QAT forward's params: snapped.detach() + w - w.detach() for each
    quantized weight (the JAX package's stop_gradient form; on the other
    leaves it is w exactly, so they pass as they are), then masked.
    `members` > 0: latent's leaves carry a leading axis of that many
    members, each snapped on its own."""
    detached = tuple({k: v.detach() for k, v in layer.items()} for layer in latent)
    if members:
        snapped = stack_members([quantize_params(_at(detached, m), cfg) for m in range(members)])
        qidx = set(quantized_layer_indices(_at(latent, 0), cfg))
    else:
        snapped = quantize_params(detached, cfg)
        qidx = set(quantized_layer_indices(latent, cfg))
    out = tuple({**layer, "w": snapped[i]["w"] + layer["w"] - layer["w"].detach()}
                if i in qidx else layer for i, layer in enumerate(latent))
    if masks is not None and any(m is not None for m in masks):
        return apply_masks(out, masks)
    return out


def quant_finetune(
    params,
    img,
    mdef: ModelDef,
    mcfg,
    grid: torch.Tensor,
    quant_cfg: QuantConfig,
    optim_cfg: OptimConfig,
    precision: str = "fp32",
    pixel_chunks: int = 1,
    masks=None,
    offset_params=None,
    pixel_group=None,
) -> QuantResult:
    """KMeans: cluster, finetune the codebooks for quant_cfg.num_steps,
    freeze; QAT: the STE finetune, then convert. Runs on the device of
    `params`. quant.row_stride > 1 finetunes against
    every s-th image row (the returned metrics are then those of that
    grid). `masks`: the sparse fit's per-layer masks (None entries for
    unmasked layers), or None. `offset_params`: a params-like tuple whose
    weights are the delta offsets (quant.delta), or None. `pixel_group`
    (module note): img and grid are the whole lattice, this rank finetunes
    on its rows."""
    return _finetune(params, [img], mdef, mcfg, grid, quant_cfg, optim_cfg, precision,
                     pixel_chunks, masks, offset_params, members=0, pixel_group=pixel_group)[0]


def quant_finetune_members(params, imgs, mdef: ModelDef, mcfg, grid: torch.Tensor,
                           quant_cfg: QuantConfig, optim_cfg: OptimConfig,
                           precision: str = "fp32", masks=None, offset_params=None,
                           pixel_group=None):
    """`quant_finetune` of M members over a member axis (module note):
    `params` whose leaves carry a leading member axis, `imgs` one image per
    member (M, H, W, C), `masks` per-layer stacked masks (None entries for
    unmasked layers) or None; `offset_params` (delta) is shared. Returns one
    QuantResult per member (its own params and codebooks; the wall is the
    finetune's, shared)."""
    b = next(layer["w"] for layer in params if "w" in layer).shape[0]
    if len(imgs) != b:
        raise ValueError(f"{len(imgs)} images for {b} members")
    return _finetune(params, imgs, mdef, mcfg, grid, quant_cfg, optim_cfg, precision, 1,
                     masks, offset_params, members=b, pixel_group=pixel_group)


def _finetune(params, imgs, mdef, mcfg, grid, quant_cfg, optim_cfg, precision, pixel_chunks,
              masks, offset_params, members: int, pixel_group=None) -> list:
    """The finetune of one fit (members=0) or of `members` fits whose leaves
    carry a leading member axis, one image each; one QuantResult per fit."""
    device = next(layer["w"] for layer in params if "w" in layer).device
    stride = int(quant_cfg.row_stride)
    grid = grid.to(device)[::stride]
    rows = local_rows(mdef, grid.shape[0], pixel_group)
    grid = grid[rows]
    h, w, c = grid.shape
    coords = grid.reshape(h * w, c)
    targets = [torch.as_tensor(np.asarray(img), dtype=torch.float32).to(device)[::stride][rows]
               .reshape(h * w, -1) for img in imgs]
    schedule = step_lr(optim_cfg.lr if quant_cfg.lr is None else float(quant_cfg.lr),
                       1000, 0.5)
    kmeans = quant_cfg.name == "KMeans"
    if not kmeans and offset_params is not None:
        raise ValueError("delta (offset_params) is KMeans-only")
    masked = masks is not None and any(m is not None for m in masks)
    fits = list(range(members)) if members else [None]

    synchronize(device)
    t0 = time.perf_counter()
    if kmeans:
        qset = set(quantized_layer_indices(_at(params, fits[0]), quant_cfg))
        offsets = [None] * len(params)
        if offset_params is not None:
            offsets = [layer["w"].to(device) if i in qset else None
                       for i, layer in enumerate(offset_params)]
        labels, state = [], []
        with torch.no_grad():
            for i, layer in enumerate(params):
                if i not in qset:
                    labels.append(None)
                    state.append({k: v.detach().clone() for k, v in layer.items()})
                    continue
                books = []
                for m in fits:
                    wm = layer["w"] if m is None else layer["w"][m]
                    _, book = quantize_weight(wm, quant_cfg.layer_bits(i), quant_cfg.lloyd_iters,
                                              offset=offsets[i])
                    if quant_cfg.ecvq_lambda > 0.0:
                        book = ecvq_refine(wm, book, quant_cfg.ecvq_lambda,
                                           quant_cfg.ecvq_iters, offset=offsets[i])
                    books.append(book)
                lab = [bk.labels.long() for bk in books]
                cen = [bk.centroids.clone() for bk in books]
                labels.append(torch.stack(lab) if members else lab[0])
                state.append({k: v.detach().clone() for k, v in layer.items() if k != "w"}
                             | {"centroids": torch.stack(cen) if members else cen[0]})
        state = tuple(state)

        def transform(st):
            return _reconstruct(st, labels, offsets, masks, members=bool(members))
    else:
        state = tuple({k: v.detach().clone() for k, v in layer.items()} for layer in params)

        def transform(st):
            return _ste(st, quant_cfg, masks, members=members)
    set_trainable_(state, True)
    opt_state = opt_init(state, optim_cfg, members=bool(members))
    grad_fn = make_grad_fn(mdef, mcfg, coords,
                           torch.stack(targets) if members else targets[0], precision,
                           pixel_chunks, transform=transform, grid_hw=(h, w),
                           members=bool(members), pixel_group=pixel_group)
    losses = []
    for step in range(quant_cfg.num_steps):
        loss, grads = grad_fn(state)
        if kmeans:  # the 0-centroid stays exactly 0
            grads = tuple(g | {"centroids": _zero_first(g["centroids"])} if "centroids" in g
                          else g for g in grads)
        elif masked:
            mask_grads(grads, masks)
        state, opt_state = opt_update(grads, opt_state, state, schedule(step), optim_cfg,
                                      members=bool(members))
        if not kmeans and masked:
            with torch.no_grad():
                apply_masks_(state, masks)
        losses.append(loss)
    set_trainable_(state, False)

    with torch.no_grad():
        if kmeans:
            params_q = tuple({k: v.detach() for k, v in layer.items()}
                             for layer in transform(state))
            books = [tuple(LayerCodebook(centroids=layer["centroids"].detach(),
                                         labels=lab.to(torch.int32))
                           if lab is not None else None
                           for layer, lab in zip(_at(state, m), _at_labels(labels, m)))
                     for m in fits]
        else:
            converted = [convert(_at(state, m), quant_cfg) for m in fits]
            books = [bk for _, bk in converted]
            params_q = stack_members([p for p, _ in converted]) if members else converted[0][0]
            if masked:
                params_q = apply_masks(params_q, masks)
        if members:
            preds = forward_members(mdef, mcfg, params_q, coords, (h, w), precision,
                                    pixel_group).unbind(0)
        else:
            preds = [forward_flat(mdef, mcfg, params_q, coords, (h, w), precision, pixel_group)]
        if eval_group(mdef, pixel_group) is None:
            scores = [(mse(p, t), psnr_8bit(p, t)) for p, t in zip(preds, targets)]
        else:
            scores = [(row[0], row[2]) for row in eval_scores(preds, targets, pixel_group)]
    synchronize(device)
    wall = time.perf_counter() - t0
    return [QuantResult(params=params_q if m is None else
                        tuple({k: v[m].clone() for k, v in layer.items()} for layer in params_q),
                        codebooks=books[j],
                        metrics=_metrics([loss if m is None else loss[m] for loss in losses],
                                         *scores[j]),
                        wall_seconds=wall)
            for j, m in enumerate(fits)]


def _zero_first(centroids):
    """The centroids' gradient with its 0-centroid's entry (the first along
    the last axis, of each member's codebook) set to 0."""
    return torch.cat([centroids.new_zeros(centroids.shape[:-1] + (1,)), centroids[..., 1:]],
                     dim=-1)


def _at_labels(labels, m):
    """Member m's per-layer labels (None entries kept); labels itself when m
    is None."""
    return labels if m is None else [None if lab is None else lab[m] for lab in labels]


def _metrics(losses, qloss, qpsnr8) -> Dict[str, Any]:
    return {
        "loss": torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32),
        "quant_loss": float(qloss),
        "quant_psnr": float(10.0 * torch.log10(1.0 / qloss)),
        "quant_psnr_8bit": float(qpsnr8),
    }
