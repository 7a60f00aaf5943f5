"""The density ladder on one device (counterpart of
implicit_image_tpu/parallel/ladder.py): the reference's rate-distortion
sweep over densities as one fit over a member axis.

The reference runs one process per density. The JAX package builds one
mask state per density and vmaps one segment program over them against
the shared image. Here the members' fits run in one loop over a member
axis (parallel/batched.fit_members): each step one K1 and one K2 launch
over the member axis for all densities. Each member's init (params, Adam
and mask state at its density) is the single fit's own (training.fit.
init_fit_state) with its generator, member_generators(generator, B)[i], so
member i has the bits of a single `fit` at its density with that
generator.

GMP (decay_schedule="magnitude-prune") ladders sweep final_density: every
member starts from the preset's init density and prunes toward its own
target, through a prune-rate schedule built from its own config
(sparsity/decay.py). RigL-style presets sweep the init density.

CLI (compress.py's overrides; the density list is the ladder:
masking.density for RigL-style presets, masking.final_density for GMP):

    python -m implicit_image_tpu_torch.parallel.ladder img=synthetic \\
        entropy_coding=zstd masking=RigL masking.density=0.05,0.1,0.25,0.5,0.75
    python -m implicit_image_tpu_torch.parallel.ladder img=synthetic \\
        masking=Pruning masking.density=1.0 masking.final_density=0.1,0.25,0.5

Each member writes a run dir (config.json, summary.json, the
model_quantized/ container and, with train.save_weights, the fit's
model.npz and mask.npz as compress.py writes them) under
<output_dir>/<img>/ladder_<masking>_<exp_name>/d<density>, which both
packages' decoders read (decompress.decode_run, and decode_runs for the
whole ladder in one K1 launch over the member axis). `device=cpu` runs the
plain versions instead of the kernels, as compress.py.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from implicit_image_tpu_torch.models import ModelDef
from implicit_image_tpu_torch.parallel.batched import fit_members, member_generators
from implicit_image_tpu_torch.parallel.pipeline import (
    PipelineResult,
    _check_delta,
    finetune_and_code,
)
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.training.fit import FitResult, OptimConfig, TrainConfig, synchronize

__all__ = ["ladder_fit", "ladder_compress", "build_ladder_args", "parse_ladder_cli", "cli"]

log = logging.getLogger("implicit_image_tpu_torch")


def _member_configs(masking_cfg, densities):
    """One masking config per member: the ladder's axis (final_density for
    GMP, density otherwise) set to the member's value."""
    if masking_cfg is None or masking_cfg.dense:
        raise ValueError("ladder_fit needs a sparse masking config")
    if len(densities) == 0:
        raise ValueError("densities is empty")
    axis = "final_density" if masking_cfg.decay_schedule == "magnitude-prune" else "density"
    return [dataclasses.replace(masking_cfg, **{axis: float(d)}) for d in densities]


def ladder_fit(generator: torch.Generator, mdef: ModelDef, mcfg, grid: torch.Tensor, img,
               train_cfg: TrainConfig, optim_cfg: OptimConfig, masking_cfg,
               densities: Sequence[float], init_params=None, device="cuda") -> FitResult:
    """Fit ONE image at B densities together on `device` (the grid moves
    there; "cpu" runs the plain versions); returns a FitResult whose leaves carry a leading member axis
    aligned with `densities`. Member i draws from
    member_generators(generator, B)[i]."""
    cfgs = _member_configs(masking_cfg, densities)
    return fit_members(member_generators(generator, len(cfgs)), mdef, mcfg, grid, img,
                       train_cfg, optim_cfg, cfgs, init_params, device)


def ladder_compress(
    generator: torch.Generator,
    mdef: ModelDef,
    mcfg,
    grid: torch.Tensor,
    img,
    train_cfg: TrainConfig,
    optim_cfg: OptimConfig,
    masking_cfg,
    densities: Sequence[float],
    quant_cfg: Optional[QuantConfig] = None,
    stream_name: str = "zstd",
    stream_root: str = "outputs/ladder",
    half="auto",
    coding_kwargs: Optional[dict] = None,
    init_params=None,
    delta_info: Optional[dict] = None,
    device="cuda",
) -> Sequence[PipelineResult]:
    """The ladder end to end on `device`: the fit over the member axis, the
    codebook finetune over the member axis, then each member's container in
    <stream_root>/d<density>/model_quantized and its decode (the reference
    pipeline's order). `delta_info` (quant.delta): every member codes
    residual codebooks against the shared `init_params` artifact, whose path
    and sha256 each manifest records."""
    return _ladder_run(generator, mdef, mcfg, grid, img, train_cfg, optim_cfg, masking_cfg,
                       densities, quant_cfg, stream_name, stream_root, half, coding_kwargs,
                       init_params, delta_info, device)[1]


def _ladder_run(generator, mdef, mcfg, grid, img, train_cfg, optim_cfg, masking_cfg, densities,
                quant_cfg, stream_name, stream_root, half, coding_kwargs, init_params,
                delta_info, device):
    """ladder_compress's work: (the fit's FitResult, the members' results)."""
    _check_delta(delta_info, init_params, quant_cfg)
    device = torch.device(device)
    grid = grid.to(device)
    res = ladder_fit(generator, mdef, mcfg, grid, img, train_cfg, optim_cfg, masking_cfg,
                     densities, init_params=init_params, device=device)
    run_dirs = [Path(stream_root) / f"d{d}" for d in densities]
    t0 = time.perf_counter()
    out = finetune_and_code(res, [img] * len(densities), mdef, mcfg, grid, train_cfg, optim_cfg,
                            quant_cfg, [d / "model_quantized" for d in run_dirs], stream_name,
                            half, coding_kwargs, init_params, delta_info, device)
    synchronize(device)
    log.info("ladder finetune + coding: %.2f s for %d members", time.perf_counter() - t0,
             len(densities))
    return res, [r._replace(stream_dir=str(d)) for r, d in zip(out, run_dirs)]


def build_ladder_args(cfg) -> dict:
    """cfg -> ladder_compress's arguments, from the port's own config pieces
    (compress.py's masking config, segment cadence, image loader, optimizer
    and quantizer configs, and warm start). It opens cfg's device (default
    "cuda": RuntimeError without one; the kernels build here, outside any
    timed wall)."""
    from implicit_image_tpu_torch.compress import (
        _half_policy,
        _load_image,
        _optim_config,
        _quant_config,
        _warm_start,
        auto_segment_steps,
        masking_config,
    )
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.models import build_model_from_config
    from implicit_image_tpu_torch.ops.cuda_build import open_device

    device = open_device(cfg.get("device", "cuda"))
    img = _load_image(cfg.img)
    h, w = img.shape[:2]
    grid = get_grid(h, w, device)
    mdef, mcfg = build_model_from_config(cfg)
    mult = int(cfg.train.get("multiplier", 1))
    num_steps = int(cfg.train.num_steps) * mult
    train_cfg = TrainConfig(
        num_steps=num_steps,
        log_steps=int(cfg.train.log_steps),
        segment_steps=auto_segment_steps(cfg),
        # train.matmul_precision rides every ladder member, as in the JAX
        # package (its members run the kernels' modes, never "+mixed")
        matmul_precision=cfg.train.get("matmul_precision") or None,
        matmul_precision_early=cfg.train.get("matmul_precision_early") or None,
        matmul_precision_switch=float(cfg.train.get("matmul_precision_switch", 0.75)),
    )
    quant_raw = cfg.get("quant")
    quant_cfg = None
    delta_requested = False
    if quant_raw and quant_raw.get("name", "none") != "none":
        delta_requested = bool(quant_raw.get("delta", False))
        if delta_requested and str(quant_raw.get("name")) != "KMeans":
            raise ValueError("quant.delta requires quant=kmeans")
        if delta_requested and not cfg.train.get("init_path"):
            raise ValueError("quant.delta codes residuals against the meta-init artifact; "
                             "set train.init_path")
        # explicit per-layer widths ride the ladder; quant.bit_alloc=auto is
        # per-run work and stays compress.py's, as in the JAX package
        quant_cfg = _quant_config(quant_raw)
    ec = cfg.get("entropy_coding") or {}
    stream_name = ec.get("stream_name", "zstd")
    if stream_name == "none":
        stream_name = "zstd"
    init_params, init_path = _warm_start(cfg, mdef, mcfg, num_steps, device)
    delta_info = None
    if delta_requested:
        import hashlib

        delta_info = {"artifact": str(init_path),
                      "sha256": hashlib.sha256(Path(init_path).read_bytes()).hexdigest()}
    return dict(
        img=img, grid=grid, mdef=mdef, mcfg=mcfg, masking=masking_config(cfg),
        train_cfg=train_cfg, optim_cfg=_optim_config(cfg), quant_cfg=quant_cfg,
        stream_name=stream_name, init_params=init_params, delta_info=delta_info,
        half=_half_policy(ec), device=device,
        # progressive / base_finetune / xor are compress.py's container
        # policy, not stream kwargs: ladder members write flat containers
        coding_kwargs={k: v for k, v in ec.items()
                       if k not in ("stream_name", "half", "progressive", "base_finetune",
                                    "xor")},
    )


def parse_ladder_cli(argv):
    """(composed cfg, densities, gmp) from compress.py-style overrides. The
    ladder axis is masking.density for RigL-style presets and
    masking.final_density for GMP (decay magnitude-prune); a single value
    on the other axis passes through as a plain override, a comma list on
    it raises ValueError. A dense masking config falls back to RigL."""
    from implicit_image_tpu_torch.config import compose

    density_list = final_list = None
    kept = []
    for a in argv:
        if a.startswith("masking.density="):
            density_list = [float(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("masking.final_density="):
            final_list = [float(x) for x in a.split("=", 1)[1].split(",")]
        else:
            kept.append(a)
    cfg = compose(kept)
    if not cfg.get("masking") or cfg.masking.get("dense", False):
        kept = [a for a in kept if not a.startswith("masking=")]
        cfg = compose(kept + ["masking=RigL"])
    gmp = cfg.masking.get("decay_schedule") == "magnitude-prune"
    axis_list, other_list, other_key = (
        (final_list, density_list, "masking.density") if gmp
        else (density_list, final_list, "masking.final_density"))
    if other_list is not None:
        if len(other_list) != 1:
            raise ValueError(f"{other_key} is not the ladder axis for "
                             f"masking={cfg.masking.get('name')}; give a single value")
        cfg = compose(kept + [f"{other_key}={other_list[0]}"])
    densities = axis_list or ([0.1, 0.25, 0.5] if gmp else [0.05, 0.1, 0.2, 0.4, 0.75])
    return cfg, densities, gmp


def cli(argv=None) -> None:
    """Compose the compress.py config, read the density comma list as the
    ladder axis, and write one run dir per member."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, densities, gmp = parse_ladder_cli(argv)
    args = build_ladder_args(cfg)  # opens the device: the kernels build outside the wall
    device = args["device"]

    # the root carries the masking method: three ladders of one exp_name
    # (the RigL / SNFS / Pruning study sweeps) must not overwrite each other
    mname = (cfg.get("masking") or {}).get("name") or "dense"
    root = Path(cfg.get("output_dir", "outputs")) / cfg.img.name / (
        f"ladder_{mname}_" + cfg.get("exp_name", "run"))
    t0 = time.perf_counter()
    res, results = _ladder_run(
        torch.Generator().manual_seed(int(cfg.seed)), args["mdef"], args["mcfg"], args["grid"],
        args["img"], args["train_cfg"], args["optim_cfg"], args["masking"], densities,
        args["quant_cfg"], args["stream_name"], str(root), args["half"], args["coding_kwargs"],
        args["init_params"], args["delta_info"], device)
    wall = time.perf_counter() - t0
    for m, (d, r) in enumerate(zip(densities, results)):
        run_dir = Path(r.stream_dir)
        if cfg.train.get("save_weights", True):
            # the fit's weights and masks, as compress.py writes them
            # (masking.mask_path of a later run reads mask.npz)
            np.savez(run_dir / "model.npz", **{f"layers.{i}.{k}": v[m].cpu().numpy()
                                               for i, layer in enumerate(res.params)
                                               for k, v in layer.items()})
            np.savez(run_dir / "mask.npz", **{f"layers.{i}.mask": mk[m].cpu().numpy()
                                              for i, mk in enumerate(res.mask_state.masks)
                                              if mk is not None})
        member_cfg = json.loads(json.dumps(cfg, default=str))
        member_cfg["masking"]["final_density" if gmp else "density"] = d
        # the stream the member was written with (entropy_coding=none writes zstd)
        member_cfg.setdefault("entropy_coding", {})["stream_name"] = args["stream_name"]
        (run_dir / "config.json").write_text(json.dumps(member_cfg, indent=2))
        (run_dir / "summary.json").write_text(json.dumps({
            "PSNR": r.psnr,
            "Quant PSNR": r.quant_psnr,
            "Decoded PSNR": r.decoded_psnr,
            "Compressed Bytes": r.compressed_bytes,
            # the wall of the one fit over the member axis, shared by the members
            "fit_wall_s": res.wall_seconds,
            "members": len(densities),
        }, indent=2))
        print(f"d={d}: fit={r.psnr:.2f} dB quant={r.quant_psnr:.2f} dB "
              f"decoded={r.decoded_psnr:.2f} dB bytes={r.compressed_bytes}")
    print(f"LADDER {len(densities)} members in {wall:.1f}s (one fit over the member axis)")


if __name__ == "__main__":
    cli()
