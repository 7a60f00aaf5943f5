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
from implicit_image_tpu_torch.training.fit import (
    OptimConfig,
    forward_flat,
    make_grad_fn,
    set_trainable_,
    synchronize,
)

__all__ = ["QuantResult", "quant_finetune"]


class QuantResult(NamedTuple):
    params: Any  # snapped params (weights == centroids[labels], or codes * scales)
    codebooks: Any  # per-layer LayerCodebook, PerChannelCodebook or None
    metrics: Dict[str, Any]
    wall_seconds: float


def _reconstruct(state, labels, offsets, masks=None):
    """Params with w = centroids[labels] for the quantized layers (delta:
    (offset + centroids[labels]) * (labels != 0)), then masked when masks
    are given."""
    out = []
    for layer, lab, off in zip(state, labels, offsets):
        if lab is None:
            out.append(layer)
            continue
        rest = {k: v for k, v in layer.items() if k != "centroids"}
        w = gather_centroids(layer["centroids"], lab)
        if off is not None:
            w = (w + off) * (lab != 0)
        out.append(rest | {"w": w})
    if masks is not None and any(m is not None for m in masks):
        return apply_masks(tuple(out), masks)
    return tuple(out)


def _ste(latent, cfg: QuantConfig, masks):
    """The QAT forward's params: snapped.detach() + w - w.detach() for each
    quantized weight (the JAX package's stop_gradient form; on the other
    leaves it is w exactly, so they pass as they are), then masked."""
    snapped = quantize_params(tuple({k: v.detach() for k, v in layer.items()}
                                    for layer in latent), cfg)
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
) -> QuantResult:
    """KMeans: cluster, finetune the codebooks for quant_cfg.num_steps,
    freeze; QAT: the STE finetune, then convert. Runs on the device of
    `params`. quant.row_stride > 1 finetunes against
    every s-th image row (the returned metrics are then those of that
    grid). `masks`: the sparse fit's per-layer masks (None entries for
    unmasked layers), or None. `offset_params`: a params-like tuple whose
    weights are the delta offsets (quant.delta), or None."""
    device = next(layer["w"] for layer in params if "w" in layer).device
    stride = int(quant_cfg.row_stride)
    grid = grid.to(device)[::stride]
    target = torch.as_tensor(np.asarray(img), dtype=torch.float32).to(device)[::stride]
    h, w, c = grid.shape
    coords = grid.reshape(h * w, c)
    target_flat = target.reshape(h * w, -1)
    schedule = step_lr(optim_cfg.lr if quant_cfg.lr is None else float(quant_cfg.lr),
                       1000, 0.5)

    if quant_cfg.name != "KMeans":
        if offset_params is not None:
            raise ValueError("delta (offset_params) is KMeans-only")
        return _qat_finetune(params, mdef, mcfg, coords, target_flat, (h, w), quant_cfg,
                             optim_cfg, schedule, precision, pixel_chunks, masks, device)

    synchronize(device)
    t0 = time.perf_counter()
    qset = set(quantized_layer_indices(params, quant_cfg))
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
            _, book = quantize_weight(layer["w"], quant_cfg.layer_bits(i), quant_cfg.lloyd_iters,
                                      offset=offsets[i])
            if quant_cfg.ecvq_lambda > 0.0:
                book = ecvq_refine(layer["w"], book, quant_cfg.ecvq_lambda, quant_cfg.ecvq_iters,
                                   offset=offsets[i])
            labels.append(book.labels.long())
            state.append({k: v.detach().clone() for k, v in layer.items() if k != "w"}
                         | {"centroids": book.centroids.clone()})
    state = tuple(state)
    set_trainable_(state, True)
    opt_state = opt_init(state, optim_cfg)

    grad_fn = make_grad_fn(mdef, mcfg, coords, target_flat, precision, pixel_chunks,
                           transform=lambda st: _reconstruct(st, labels, offsets, masks),
                           grid_hw=(h, w))
    losses = []
    for step in range(quant_cfg.num_steps):
        loss, grads = grad_fn(state)
        grads = tuple(
            g | {"centroids": torch.cat([g["centroids"].new_zeros(1), g["centroids"][1:]])}
            if "centroids" in g else g
            for g in grads
        )
        state, opt_state = opt_update(grads, opt_state, state, schedule(step), optim_cfg)
        losses.append(loss)

    with torch.no_grad():
        params_q = tuple({k: v.detach() for k, v in layer.items()}
                         for layer in _reconstruct(state, labels, offsets, masks))
        pred = forward_flat(mdef, mcfg, params_q, coords, (h, w), precision)
        qloss = mse(pred, target_flat)
        qpsnr8 = psnr_8bit(pred, target_flat)
    synchronize(device)
    wall = time.perf_counter() - t0
    codebooks = tuple(
        LayerCodebook(centroids=layer["centroids"].detach(), labels=lab.to(torch.int32))
        if lab is not None else None
        for layer, lab in zip(state, labels)
    )
    set_trainable_(state, False)
    return QuantResult(params=params_q, codebooks=codebooks,
                       metrics=_metrics(losses, qloss, qpsnr8), wall_seconds=wall)


def _metrics(losses, qloss, qpsnr8) -> Dict[str, Any]:
    return {
        "loss": torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32),
        "quant_loss": float(qloss),
        "quant_psnr": float(10.0 * torch.log10(1.0 / qloss)),
        "quant_psnr_8bit": float(qpsnr8),
    }


def _qat_finetune(params, mdef, mcfg, coords, target_flat, grid_hw, quant_cfg, optim_cfg,
                  schedule, precision, pixel_chunks, masks, device) -> QuantResult:
    """QAT: the STE finetune of the latent weights, then `convert`."""
    masked = masks is not None and any(m is not None for m in masks)
    synchronize(device)
    t0 = time.perf_counter()
    latent = tuple({k: v.detach().clone() for k, v in layer.items()} for layer in params)
    set_trainable_(latent, True)
    opt_state = opt_init(latent, optim_cfg)
    grad_fn = make_grad_fn(mdef, mcfg, coords, target_flat, precision, pixel_chunks,
                           transform=lambda lt: _ste(lt, quant_cfg, masks), grid_hw=grid_hw)
    losses = []
    for step in range(quant_cfg.num_steps):
        loss, grads = grad_fn(latent)
        if masked:
            mask_grads(grads, masks)
        latent, opt_state = opt_update(grads, opt_state, latent, schedule(step), optim_cfg)
        if masked:
            with torch.no_grad():
                apply_masks_(latent, masks)
        losses.append(loss)
    set_trainable_(latent, False)
    with torch.no_grad():
        params_q, codebooks = convert(latent, quant_cfg)
        if masked:
            params_q = apply_masks(params_q, masks)
        pred = forward_flat(mdef, mcfg, params_q, coords, grid_hw, precision)
        qloss = mse(pred, target_flat)
        qpsnr8 = psnr_8bit(pred, target_flat)
    synchronize(device)
    return QuantResult(params=params_q, codebooks=codebooks,
                       metrics=_metrics(losses, qloss, qpsnr8),
                       wall_seconds=time.perf_counter() - t0)

