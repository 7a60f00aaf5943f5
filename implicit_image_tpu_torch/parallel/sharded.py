"""One image over many devices: its rows split over the mesh's "pixel"
ranks (counterpart of implicit_image_tpu/parallel/sharded.py).

The JAX package shards the image's row axis with a NamedSharding and lets
GSPMD all-reduce the gradients and the metrics. Here each pixel rank holds
H/n rows of the grid and the target and the replicated params; the fit is
training.fit's with the mesh's pixel group: rank r runs chunk r of the
single fit's pixel chunks (k · n with train.pixel_chunks = k) and the
chunk gradients of all ranks are added in rank order on every rank. So the
sharded fit on n ranks has the bits of the single fit with
train.pixel_chunks = n · k wherever each chunk's forward and backward have
them (the fused SIREN on the CPU and the card), every rank the same.
Separable models (CoordX, hashgrid) keep their grid forward on their row
block, as the single fit's row-block chunks do. Under train.loss=ms-ssim,
whose windows straddle the rows, every rank gathers the rows' predictions
and takes the whole image's loss (training/fit.py's module note): the
single fit's values up to the order of the gradients' sum. A full-grid
model (wavelet_siren) splits its DWT lattices' rows over the ranks instead
(contiguous shares that differ by at most one row), gathers the shares and
takes the whole image's loss on every rank, the gradients added in rank
order (training.fit's `lattice_split`): the single fit's values up to the
order of that sum, where the JAX package's GSPMD gathers the lattices. The
image's rows must still divide by the pixel axis (JAX asserts it).

An "image" axis above 1 repeats the same fit on each image coordinate, as
the JAX package's layout replicates it there.

`sharded_render` is the decode counterpart: each pixel rank renders its
rows of the (ROI-windowed) lattice and every rank returns the whole render
(a full-grid model: its share of the DWT lattices' rows, the whole image
only).

CLI: the compress pipeline of compress.py's config (its overrides) with the
image's rows over every rank of the process group (parallel/pipeline.
sharded_compress), one process per GPU under torchrun (NCCL), or several
processes sharing one GPU over gloo (`backend=gloo`); rank 0 writes the run
dir <output_dir>/<img>/sharded_<exp_name> (config.json, summary.json and
the model_quantized/ container, which decompress reads):

    torchrun --nproc_per_node=<GPUs> -m implicit_image_tpu_torch.parallel.sharded \
        entropy_coding=zstd
    torchrun --nproc_per_node=2 -m implicit_image_tpu_torch.parallel.sharded backend=gloo
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import torch

from implicit_image_tpu_torch.data import get_grid_window
from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.parallel.mesh import Mesh
from implicit_image_tpu_torch.training.fit import (
    FitResult,
    OptimConfig,
    TrainConfig,
    check_optim,
    check_pixel_group,
    fit,
    forward_flat,
    lattice_split,
)

__all__ = ["make_sharded_fit_fn", "sharded_fit", "sharded_render"]


def sharded_render(mesh: Mesh, mdef: ModelDef, mcfg, params, height: int, width: int,
                   roi=None, precision: str = "fp32") -> torch.Tensor:
    """Render (a window (r0, r1, c0, c1) of) the height × width lattice with
    its rows split over the pixel ranks, in `precision` (the decoder's fp32
    by default), on mesh.device; every rank returns the whole (r1 - r0,
    c1 - c0, out) render. The window's rows must divide by the pixel axis
    (ValueError). A full-grid model renders the whole lattice only (any
    other window raises ValueError), its DWT lattices' rows over the ranks
    (training.fit's `lattice_split`)."""
    r0, r1, c0, c1 = roi if roi is not None else (0, height, 0, width)
    n = mesh.shape["pixel"]
    if (r1 - r0) % n:
        raise ValueError(f"window rows {r1 - r0} not divisible by pixel axis {n}")
    if lattice_split(mdef, mesh.pixel):
        if (r0, r1, c0, c1) != (0, height, 0, width):
            raise ValueError(f"model {mdef.name!r} renders its full grid only; got the window "
                             f"{(r0, r1, c0, c1)} of {height} x {width}")
        params = tuple({k: v.to(mesh.device) for k, v in layer.items()} for layer in params)
        grid = get_grid_window(height, width, 0, height, 0, width, mesh.device)
        with torch.no_grad():
            out = forward_flat(mdef, mcfg, params, grid.reshape(height * width, -1),
                               (height, width), precision, mesh.pixel)
        return out.reshape(height, width, -1)
    rows = (r1 - r0) // n
    lo = r0 + mesh.pixel.rank * rows
    grid = get_grid_window(height, width, lo, lo + rows, c0, c1, mesh.device)
    params = tuple({k: v.to(mesh.device) for k, v in layer.items()} for layer in params)
    with torch.no_grad():
        out = mdef.apply(params, grid, mcfg, precision)
    return mesh.pixel.cat(out)


def make_sharded_fit_fn(mesh: Mesh, mdef: ModelDef, mcfg, grid: torch.Tensor,
                        train_cfg: TrainConfig, optim_cfg: OptimConfig, masking_cfg=None,
                        init_params=None):
    """fit(generator, img) -> FitResult: the fit of img (H, W, C) with its
    rows split over the mesh's pixel ranks, on mesh.device (module note);
    every rank passes the whole image and the same generator state and
    returns the same result. `init_params` warm-starts it, as the single
    fit's. H not divisible by the pixel axis raises ValueError here."""
    check_pixel_group(mdef, mesh.pixel, grid.shape[0])
    check_optim(mdef, train_cfg, optim_cfg)

    def fit_fn(generator: torch.Generator, img) -> FitResult:
        return fit(generator, mdef, mcfg, grid, img, train_cfg, optim_cfg, masking_cfg,
                   init_params=init_params, device=mesh.device, pixel_group=mesh.pixel)

    return fit_fn


def sharded_fit(generator: torch.Generator, mesh: Mesh, mdef: ModelDef, mcfg,
                grid: torch.Tensor, img, train_cfg: TrainConfig, optim_cfg: OptimConfig,
                masking_cfg=None, init_params=None) -> FitResult:
    """One pixel-sharded fit (make_sharded_fit_fn). train_cfg.segment_steps
    is the boundary work's cadence only, as in the single fit: it does not
    change the result."""
    return make_sharded_fit_fn(mesh, mdef, mcfg, grid, train_cfg, optim_cfg, masking_cfg,
                               init_params)(generator, img)


def cli(argv=None) -> None:
    """Join the process group (env://, as torchrun sets it), build a 1 x
    world mesh on cfg's device and run sharded_compress on the composed
    config; rank 0 writes the run dir and prints the result."""
    import torch.distributed as dist

    from implicit_image_tpu_torch.config import compose
    from implicit_image_tpu_torch.ops.cuda_build import open_device
    from implicit_image_tpu_torch.parallel.ladder import build_ladder_args
    from implicit_image_tpu_torch.parallel.mesh import make_mesh
    from implicit_image_tpu_torch.parallel.multihost import init_multihost
    from implicit_image_tpu_torch.parallel.pipeline import sharded_compress

    argv = list(sys.argv[1:] if argv is None else argv)
    backend = next((a.split("=", 1)[1] for a in argv if a.startswith("backend=")), None)
    cfg = compose([a for a in argv if not a.startswith("backend=")])
    device = torch.device(cfg.get("device", "cuda"))
    owned = not dist.is_initialized()
    init_multihost(backend=backend, device=device)
    if int(os.environ.get("LOCAL_RANK", dist.get_rank())) == 0:
        open_device(device)  # one process of each machine builds the kernels
    dist.barrier()
    mesh = make_mesh(1, dist.get_world_size(), device=device)
    args = build_ladder_args(cfg)
    run_dir = Path(cfg.get("output_dir", "outputs")) / cfg.img.name / (
        "sharded_" + cfg.get("exp_name", "run"))
    t0 = time.perf_counter()
    res = sharded_compress(torch.Generator().manual_seed(int(cfg.seed)), mesh, args["mdef"],
                           args["mcfg"], args["grid"], args["img"], args["train_cfg"],
                           args["optim_cfg"], args["masking"], args["quant_cfg"],
                           stream_name=args["stream_name"],
                           stream_dir=str(run_dir / "model_quantized"), half=args["half"],
                           coding_kwargs=args["coding_kwargs"])
    wall = time.perf_counter() - t0
    if mesh.world.rank == 0:
        member_cfg = json.loads(json.dumps(cfg, default=str))
        member_cfg.setdefault("entropy_coding", {})["stream_name"] = args["stream_name"]
        (run_dir / "config.json").write_text(json.dumps(member_cfg, indent=2))
        (run_dir / "summary.json").write_text(json.dumps({
            "PSNR": res.psnr, "Quant PSNR": res.quant_psnr, "Decoded PSNR": res.decoded_psnr,
            "Compressed Bytes": res.compressed_bytes, "fit_wall_s": res.fit_wall_s,
            "pixel_ranks": mesh.shape["pixel"], "backend": dist.get_backend()}, indent=2))
        print(f"SHARDED {mesh.shape['pixel']} pixel ranks ({dist.get_backend()}): fit "
              f"{res.psnr:.2f} dB, quant {res.quant_psnr:.2f} dB, decoded "
              f"{res.decoded_psnr:.2f} dB, {res.compressed_bytes} B in {wall:.1f} s -> {run_dir}")
    if owned:
        dist.destroy_process_group()


if __name__ == "__main__":
    cli()
