"""The compress pipeline over a member axis on one device (counterpart of
the one-device half of implicit_image_tpu/parallel/pipeline.py).

`batched_compress` takes many images end to end: one batched fit over the
member axis (parallel/batched.py), then the codebook finetune over the
member axis (training/quant_phase.quant_finetune_members, the JAX
package's vmap of its quant fit), then for each member its container
written by the port's container code and decoded again from the written
bytes. Either package decodes what it writes to the same weights.
`sharded_compress` (one image over a device mesh) waits for the multi-GPU
slice (ROADMAP.md, M16).
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from implicit_image_tpu_torch.coding import (
    apply_xor_residual,
    compress_state_dict,
    decode_and_render,
    linear_state_dict,
    state_ref_map,
)
from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.parallel.batched import batched_fit
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig
from implicit_image_tpu_torch.ops.sine_mlp import precision_from_config
from implicit_image_tpu_torch.training.quant_phase import quant_finetune_members

__all__ = ["PipelineResult", "batched_compress"]


class PipelineResult(NamedTuple):
    psnr: float  # fit PSNR (last eval)
    quant_psnr: float
    decoded_psnr: float  # rendered from the written container
    compressed_bytes: int
    params: object  # final (quantized) params
    stream_dir: str
    # the wall of the fit over the member axis, shared by its members
    fit_wall_s: float = float("nan")


def _fit_psnr(metrics) -> float:
    p = np.asarray(metrics["psnr"]).reshape(-1)
    p = p[np.isfinite(p)]
    return float(p[-1]) if p.size else float("nan")


def _check_delta(delta_info, init_params, quant_cfg) -> None:
    if delta_info is not None and (init_params is None or quant_cfg is None
                                   or quant_cfg.name != "KMeans"):
        raise ValueError("delta_info requires init_params (the shared artifact) and "
                         "quant=kmeans")


def _encode_decode(params_q, codebooks, mdef, mcfg, h, w, img_np, stream_dir, stream_name, half,
                   coding_kwargs=None, delta_info=None, delta_ref=None, device="cuda"):
    """Write one member's container (the stream backend's kwargs, e.g. a zstd
    `level`, as compress.main passes them; a delta container with the XOR
    residual of the unquantized tensors against `delta_ref`), decode it and
    render it in the fp32 mode: returns (container bytes, decoded PSNR)."""
    delta = None
    if delta_info is not None:
        if codebooks is None:
            raise ValueError("delta coding requires a quantized member")
        delta = dict(delta_info)
        delta["layers"] = [i for i, cb in enumerate(codebooks) if cb is not None]
    state = linear_state_dict(params_q, codebooks, half=half)
    if delta is not None and delta_ref is not None:
        state, delta["xor"] = apply_xor_residual(state, delta_ref)
    nbytes = compress_state_dict(state, stream_dir, stream_name, delta=delta,
                                 **dict(coding_kwargs or {}))
    dec_img, _ = decode_and_render(stream_dir, stream_name, mdef, mcfg, h, w, device=device,
                                   precision="fp32")
    mse = float(np.mean((np.asarray(dec_img, np.float64) - img_np) ** 2))
    return nbytes, float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def member_params(tree, m: int):
    """Member m of params whose leaves carry a leading member axis, each leaf
    a copy in its own allocation (a single fit's layout)."""
    return tuple({k: v[m].clone() for k, v in layer.items()} for layer in tree)


def finetune_and_code(res, targets, mdef, mcfg, grid, train_cfg: TrainConfig,
                      optim_cfg: OptimConfig, quant_cfg: Optional[QuantConfig], stream_dirs,
                      stream_name: str, half, coding_kwargs, init_params, delta_info,
                      device) -> Sequence[PipelineResult]:
    """After a fit over a member axis: the members' codebook finetune over
    the member axis (quant_finetune_members, each member with its masks and
    against `targets[m]`, at train.matmul_precision's mode without "+mixed",
    as the JAX package's pipeline passes only matmul_precision), then each
    member's container and decode, member after member, into
    stream_dirs[m]. Shared by batched_compress and the density ladder,
    which check delta_info (_check_delta) before their fits."""
    delta_ref = state_ref_map(init_params) if delta_info is not None else None
    h, w = grid.shape[:2]
    b = len(stream_dirs)
    quant = None
    if quant_cfg is not None and quant_cfg.name != "none":
        masks = None if res.mask_state is None else list(res.mask_state.masks)
        quant = quant_finetune_members(
            res.params, [np.asarray(targets[m]) for m in range(b)], mdef, mcfg, grid, quant_cfg,
            optim_cfg, precision=precision_from_config(train_cfg.matmul_precision), masks=masks,
            offset_params=init_params if delta_info is not None else None)
    out = []
    for m, stream_dir in enumerate(stream_dirs):
        params_q, books, qpsnr = member_params(res.params, m), None, float("nan")
        img = np.asarray(targets[m])
        if quant is not None:
            params_q, books = quant[m].params, quant[m].codebooks
            qpsnr = quant[m].metrics["quant_psnr"]
        nbytes, dec_psnr = _encode_decode(params_q, books, mdef, mcfg, h, w,
                                          np.asarray(img, np.float64), stream_dir, stream_name,
                                          half, coding_kwargs, delta_info, delta_ref, device)
        out.append(PipelineResult(psnr=_fit_psnr({"psnr": res.metrics["psnr"][m]}),
                                  quant_psnr=qpsnr,
                                  decoded_psnr=dec_psnr, compressed_bytes=nbytes,
                                  params=params_q, stream_dir=str(stream_dir),
                                  fit_wall_s=res.wall_seconds))
    return out


def batched_compress(
    generator: torch.Generator,
    mdef: ModelDef,
    mcfg,
    grid: torch.Tensor,
    imgs,
    train_cfg: TrainConfig,
    optim_cfg: OptimConfig,
    masking_cfg=None,
    quant_cfg: Optional[QuantConfig] = None,
    stream_name: str = "zstd",
    stream_root: str = "outputs/batched_streams",
    half="auto",
    coding_kwargs: Optional[dict] = None,
    init_params=None,
    member_subdir: str = "",
    member_names: Optional[Sequence[str]] = None,
    delta_info: Optional[dict] = None,
    device="cuda",
) -> Sequence[PipelineResult]:
    """A batch of images (B, H, W, C) end to end on `device` (the grid moves
    there; "cpu" runs the plain versions): one batched fit (member i draws from
    member_generators(generator, B)[i]), then each member's finetune,
    container and decode.

    `init_params` warm-starts every member from one shared meta-init.
    `member_names` labels the members' stream dirs under `stream_root`
    (default img{i}); `member_subdir` nests each stream inside its member's
    dir ("model_quantized" makes members look like compress.py run dirs).
    `delta_info` ({"artifact": path, "sha256": hex}, quant.delta) makes every
    member code residual codebooks against the shared `init_params`
    artifact; it requires init_params and a k-means quant_cfg."""
    imgs = np.asarray(imgs)
    b = imgs.shape[0]
    if member_names is not None and len(member_names) != b:
        raise ValueError(f"member_names has {len(member_names)} entries for {b} images")
    _check_delta(delta_info, init_params, quant_cfg)
    device = torch.device(device)
    grid = grid.to(device)
    res = batched_fit(generator, mdef, mcfg, grid, imgs, train_cfg, optim_cfg, masking_cfg,
                      init_params=init_params, device=device)
    names = member_names if member_names is not None else [f"img{i}" for i in range(b)]
    dirs = [Path(stream_root) / name / member_subdir if member_subdir
            else Path(stream_root) / name for name in names]
    return finetune_and_code(res, imgs, mdef, mcfg, grid, train_cfg, optim_cfg, quant_cfg, dirs,
                             stream_name, half, coding_kwargs, init_params, delta_info, device)
