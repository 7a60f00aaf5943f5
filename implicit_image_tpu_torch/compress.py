"""Orchestrator / CLI (counterpart of implicit_image_tpu/compress.py): load
image -> fit (dense, or sparse under the masking group; cold, or warm from a
meta-init) -> quantization finetune (k-means codebooks, absolute or delta
against the meta-init, or QAT) -> container -> decode the written container and render ->
report (decoded PSNR, container bytes, decoded MS-SSIM).

    python -m implicit_image_tpu_torch.compress            # the JAX default: RigL
    python -m implicit_image_tpu_torch.compress masking=SNFS train.num_steps=2000
    # the reference's studies (scripts/run_studies_r5.sh)
    python -m implicit_image_tpu_torch.compress img=synthetic mlp=wavelet_siren \
        masking=none quant=kmeans entropy_coding=zstd
    python -m implicit_image_tpu_torch.compress img=synthetic masking=Feathermap \
        masking.density=0.2 train.multiplier=5 entropy_coding=zstd
    # the JAX bench's flagship recipe
    python -m implicit_image_tpu_torch.compress mlp=coordx mlp.hidden_size=96 \
        mlp.split_depth=5 masking.density=0.85 train.num_steps=1200 \
        train.init_path=auto quant.delta=true quant.row_stride=4 entropy_coding=auto
    # the fit's options: the precision schedule, mixed precision, early
    # stop, checkpoint / resume / watch, gradient clipping, the exact sine
    python -m implicit_image_tpu_torch.compress train.matmul_precision_early=bfloat16
    python -m implicit_image_tpu_torch.compress train.mixed_precision=true
    python -m implicit_image_tpu_torch.compress train.stop_at_psnr=40 train.segment_steps=100
    python -m implicit_image_tpu_torch.compress train.checkpoint=true train.watch=true
    python -m implicit_image_tpu_torch.compress train.resume=outputs/run/checkpoint.npz
    python -m implicit_image_tpu_torch.compress mlp.hidden_size=512 optim.grad_clip=1.0
    python -m implicit_image_tpu_torch.compress mlp.fast_sine=false
    python -m implicit_image_tpu_torch.compress mlp=hashgrid quant.skip_layers=[] \
        optim.lr=1e-2 optim.epsilon=1e-15
    # the other quantizer and optimizers: QAT (per channel or per tensor),
    # Shampoo, the EKFAC preconditioner
    python -m implicit_image_tpu_torch.compress quant=qat entropy_coding=zstd
    python -m implicit_image_tpu_torch.compress quant=qat quant.qscheme=per_tensor
    python -m implicit_image_tpu_torch.compress optim=shampoo
    python -m implicit_image_tpu_torch.compress +optim.preconditioner=ekfac
    # the run tools: per-layer bit allocation, the progressive container,
    # a profiler trace of the fit, a multirun sweep
    python -m implicit_image_tpu_torch.compress quant.bit_alloc=auto entropy_coding=zstd
    python -m implicit_image_tpu_torch.compress entropy_coding.progressive=true
    python -m implicit_image_tpu_torch.compress profile=True
    python -m implicit_image_tpu_torch.compress -m seed=0,1,2 launcher.n_jobs=2

It composes its config with the port's copy of the JAX package's composer
and YAML tree (implicit_image_tpu_torch.config), so it takes the same
overrides, plus
one key the YAML tree does not hold: `device` (default "cuda"; the tests
pass device=cpu). Run dirs hold the same files as the JAX package's
(config.json, metrics.jsonl, summary.json, model.npz, mask.npz for a
sparse fit, model_quantized/), and either package's decoder reads them. summary.json also records the
stage walls (fit_wall_s, quant_wall_s, encode_wall_s, decode_wall_s), on
CUDA the kernels' build-or-load seconds (kernel_build_s), and for a stream
that runs the native codecs their build-or-load seconds (codec_build_s);
no stage wall includes either.

Models: SIREN, CoordX, Fourier features (mlp=fourier), wavelet-SIREN
(mlp=wavelet_siren) and hashgrid. Masking: RigL (the default), SNFS, Pruning (GMP),
Small_Dense, Feathermap (the model's tensors hashed into V1 @ V2 at
masking.density; a dense fit) and none. Streams: every backend (plain,
zstd, lzma, huffman, range, rans, auto). `train.init_path`: a meta-init .npz, or `auto` (warm
from the matching artifact of assets/meta inside the measured budget, else
cold; training/metainit.py). `quant.delta`: residual codebooks against the
meta-init, with the unquantized tensors stored as XOR residuals
(`entropy_coding.xor`, default on).
`quant.bit_alloc=auto` (quant/allocate.py): per-layer codebook widths from
measured render-MSE probes, finetuned too, adopted only if the allocation's
(decoded PSNR, bytes) dominates the uniform one's; both probe containers stay
in `bit_alloc_{auto,uniform}/` and summary.json records `Bit Allocation`.
`entropy_coding.progressive=true` writes the format-4 container
(coding/progressive.py) with its base codebooks finetuned against the image
(`entropy_coding.base_finetune`, default on; quant/base_layer.py).
`profile=True` writes a torch.profiler trace of the fit to
<run>/profile/trace.json. `-m` / `--multirun` expands comma lists into one run
per member under `<output_dir>/<overrides>`, `launcher.n_jobs` at once on
worker threads sharing the card; a member's results do not depend on
n_jobs.
The run sets torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 to False: `tensorfloat32` means fp32 here,
never NVIDIA's 1-pass TF32.
The fit (training/fit.py): `train.matmul_precision_early` /
`_switch` (the precision schedule; a switch that leaves no step at
matmul_precision raises), `train.mixed_precision`, `train.stop_at_psnr`,
`train.checkpoint` (<run>/checkpoint.npz), `train.resume`, `train.watch`
(<run>/histograms.jsonl); the last four act at the JAX package's segment
boundaries, every `train.segment_steps` steps (null: its auto formula,
copied here), which the port reads as that cadence only. `optim.grad_clip`
clips to a global norm; Adam ignores the Shampoo/EKFAC keys (momentum,
weight_decay, epsilon, update_freq, graft_norm, precond_*), as in the JAX
package, and the run logs so once.
The quantizer: quant=kmeans, or quant=qat (quant.qscheme per_channel, the
default: int8 codes + per-channel scales in the container; or per_tensor:
labels + a 2^b-entry codebook), whose STE finetune runs the fit's chain
(training/quant_phase.py); quant.delta and quant.bit_alloc=auto are
k-means only (delta with QAT raises, bit_alloc=auto is skipped for QAT,
as in the JAX package). The optimizer: optim=adam or optim=shampoo
(optim/shampoo.py; also the finetune's), and optim.preconditioner=ekfac
(optim/ekfac.py) on either; a Shampoo fit takes no train.checkpoint or
train.resume.
Ignored: TPU-runtime keys with no meaning here (train.use_pallas) and the
logging keys other than logging.use (no W&B sink).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.coding import (
    apply_xor_residual,
    compress_state_dict,
    decode_and_render,
    linear_state_dict,
    state_ref_map,
)
from implicit_image_tpu_torch.coding.parsers import load_native_codecs
from implicit_image_tpu_torch.config import DotDict, compose, expand_multirun
from implicit_image_tpu_torch.data import (
    get_grid,
    load_img,
    resolve_benchmark_path,
    stable_seed,
    synthetic_image,
)
from implicit_image_tpu_torch.models import build_model_from_config
from implicit_image_tpu_torch.ops.sine_mlp import precision_from_config
from implicit_image_tpu_torch.optim import optimizer_registry
from implicit_image_tpu_torch.ops.ssim import ms_ssim
from implicit_image_tpu_torch.quant import QuantConfig, quantized_layer_indices
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit, synchronize
from implicit_image_tpu_torch.training.quant_phase import quant_finetune
from implicit_image_tpu_torch.utils import MetricsLogger, annotate, catch_error_decorator, trace

log = logging.getLogger("implicit_image_tpu_torch")

# the kernels' mode of a render the JAX package runs with no precision
# context around it (the bit allocation's probes, the base finetune): JAX's
# default, one bf16 pass on the TPU
_JAX_DEFAULT_PRECISION = precision_from_config(None)

# the OptimConfig keys that Adam does not read, in either package (EKFAC's
# precond_* are read under optim.preconditioner=ekfac, Adam's or Shampoo's)
_ADAM_IGNORES = ("momentum", "weight_decay", "epsilon", "update_freq", "graft_norm",
                 "precond_eps", "precond_interval")

_AUTO_CHUNK_PIXELS = 1 << 20

# the masking-group keys MaskingConfig takes (others, e.g. apply_when, are ignored)
_MASKING_FIELDS = {
    "density",
    "sparse_init",
    "dense_gradients",
    "prune_mode",
    "growth_mode",
    "redistribution_mode",
    "decay_schedule",
    "prune_rate",
    "final_density",
    "start_when",
    "end_when",
    "interval",
    "dense",
    "print_FLOPs",
    "name",
    "mask_path",
}


def _load_image(img_cfg) -> np.ndarray:
    """The configured image; the deterministic synthetic stand-in when the
    benchmark file is not present."""
    path = img_cfg.get("path")
    resolved = resolve_benchmark_path(path) if path else None
    if resolved:
        return load_img(
            resolved, height=img_cfg.height, width=img_cfg.width, bits=img_cfg.bits,
            crop_mode=img_cfg.get("crop_mode", "centre-crop"),
            save_gt=img_cfg.get("save_gt", False),
        )
    if path:
        log.warning("image %s not found; using synthetic stand-in", path)
    return synthetic_image(img_cfg.height, img_cfg.width,
                           seed=stable_seed(img_cfg.get("name", "synthetic")))


def _resolve_pixel_chunks(raw, h: int, w: int) -> int:
    """train.pixel_chunks: an int, or "auto"/0 -> the smallest row-aligned
    chunk count bounding each chunk to 2^20 pixels."""
    if not (raw in ("auto", None) or (isinstance(raw, (int, float)) and int(raw) == 0)):
        return int(raw)
    if h * w <= _AUTO_CHUNK_PIXELS:
        return 1
    need = -(-(h * w) // _AUTO_CHUNK_PIXELS)
    return next((k for k in range(need, h + 1) if h % k == 0), h)


def _half_policy(ec):
    half = ec.get("half", "auto")
    return {"auto": "auto", True: True, False: False, "true": True, "false": False}[half]


def _decoded_psnr(img, dec_img) -> float:
    err = float(np.mean((np.asarray(dec_img, np.float64) - np.asarray(img, np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / max(err, 1e-12)))


def _auto_alloc_dominates(cfg, qres_auto, qres_uniform, mdef, mcfg, img, run_dir,
                          device) -> bool:
    """quant.bit_alloc=auto's post-finetune A/B: adopt the per-layer
    allocation only if its (decoded PSNR, container bytes) dominates the
    uniform codebooks' on the run's own stream; without a stream, by quant
    PSNR. Both probe containers stay in the run dir (`bit_alloc_{auto,
    uniform}/`); the winner is written to model_quantized/ by the coding
    stage."""
    ec = cfg.get("entropy_coding")
    if not ec or ec.get("stream_name", "none") == "none":
        return qres_auto.metrics["quant_psnr"] >= qres_uniform.metrics["quant_psnr"]
    h, w = img.shape[:2]

    def point(qr, tag):
        state = linear_state_dict(qr.params, qr.codebooks, half=_half_policy(ec))
        d = Path(run_dir) / f"bit_alloc_{tag}"
        nbytes = compress_state_dict(state, d, ec.stream_name, level=int(ec.get("level", 22)))
        dec, _ = decode_and_render(d, ec.stream_name, mdef, mcfg, h, w, device=device,
                                   precision="fp32")
        return _decoded_psnr(img, dec), nbytes

    db_a, by_a = point(qres_auto, "auto")
    db_u, by_u = point(qres_uniform, "uniform")
    log.info("bit_alloc A/B: auto %.3f dB @ %d B vs uniform %.3f dB @ %d B",
             db_a, by_a, db_u, by_u)
    return db_a >= db_u and by_a <= by_u


def _optim_config(cfg) -> OptimConfig:
    if cfg.optim.get("name") not in optimizer_registry:
        raise KeyError(f"optim={cfg.optim.get('name')!r} is not one of {optimizer_registry}")
    fields = {f.name for f in dataclasses.fields(OptimConfig)}
    unknown = set(cfg.optim) - fields
    if unknown:
        raise KeyError(f"optim keys {sorted(unknown)} are not OptimConfig fields")
    ignored = sorted(k for k in cfg.optim if k in _ADAM_IGNORES)
    if ignored and cfg.optim.get("name") == "adam":
        log.info("optim: Adam ignores %s (Shampoo's and EKFAC's keys), as the JAX package's "
                 "Adam does; its eps is 1e-8", ignored)
    # PyYAML parses bare "3e-4" as a string: coerce what looks numeric, as
    # the JAX package does
    kwargs = {}
    for k, v in cfg.optim.items():
        if k != "name" and isinstance(v, str):
            try:
                v = float(v)
            except ValueError:
                pass
        kwargs[k] = v
    return OptimConfig(**kwargs)


def auto_segment_steps(cfg) -> int:
    """train.segment_steps, or the JAX package's `_auto_segment_steps`
    (compress.py) when it is null: 2000 scaled down with the hidden width
    squared and the pixel count (hashgrid: with pixels x levels). The port
    reads it as the cadence of the boundary work only (training/fit.py)."""
    explicit = cfg.train.get("segment_steps")
    if explicit is not None:
        return int(explicit)
    pixels = int(cfg.img.get("height", 512)) * int(cfg.img.get("width", 512))
    if cfg.mlp.get("name") == "hashgrid":
        levels = int(cfg.mlp.get("n_levels", 12))
        scale = min(1.0, (512.0 * 512.0 * 12.0) / max(pixels * max(levels, 1), 1))
        return max(25, min(2000, int(2000 * scale)))
    width = int(cfg.mlp.get("hidden_size", 128))
    scale = min(1.0, (128.0 / max(width, 1)) ** 2)
    scale *= min(1.0, (512.0 * 512.0) / max(pixels, 1))
    return max(25, int(2000 * scale))


def masking_config(cfg) -> Optional[MaskingConfig]:
    """The sparse masking config of a composed run config, None for a dense
    run; end_when and interval scale with train.multiplier."""
    raw = cfg.get("masking")
    if not raw or raw.get("dense", False):
        return None
    mult = int(cfg.train.get("multiplier", 1))
    fields = {k: v for k, v in raw.items() if k in _MASKING_FIELDS}
    for key in ("end_when", "interval"):
        if key in fields:
            fields[key] = int(fields[key] * mult)
    return MaskingConfig(**fields)


def _quant_config(q) -> QuantConfig:
    return QuantConfig(
        name=q.name,
        bits=int(q.get("bits", 8)),
        num_steps=int(q.get("num_steps", 100)),
        ecvq_lambda=float(q.get("ecvq_lambda", 0.0)),
        lr=float(q["lr"]) if q.get("lr") is not None else None,
        row_stride=int(q.get("row_stride", 1)),
        qscheme=str(q.get("qscheme", "per_channel")),
        skip_layers=(tuple(int(i) for i in q["skip_layers"])
                     if q.get("skip_layers") is not None else None),
        bits_per_layer=(tuple(int(b) if b is not None else None for b in q["bits_per_layer"])
                        if q.get("bits_per_layer") is not None else None),
    )


def _warm_start(cfg, mdef, mcfg, num_steps: int, device):
    """(init params or None, init path or None) from train.init_path: a
    meta-init .npz, or "auto" (resolve_auto_init: warm from the matching
    artifact inside the measured budget, else cold)."""
    from implicit_image_tpu_torch.training import metainit

    init_path = cfg.train.get("init_path") or None
    if init_path == "auto":
        params, path, why = metainit.resolve_auto_init(
            mdef.name, mcfg, num_steps,
            matmul_precision=cfg.train.get("matmul_precision") or None, device=device)
        log.info("fit: init_path=auto -> %s (%s)", "warm" if params is not None else "cold", why)
        return params, path
    if not init_path:
        return None, None
    if num_steps > metainit.WARM_BUDGET_MAX_STEPS:
        log.warning(
            "fit: explicit warm start at %d steps is past the measured warm-win "
            "regime (<= %d); beyond it is unmeasured — use train.init_path=auto "
            "for budget-aware arbitration", num_steps, metainit.WARM_BUDGET_MAX_STEPS)
    params = metainit.load_meta_init(init_path, expect_model=mdef.name, expect_mcfg=mcfg,
                                     device=device)
    log.info("fit: warm-starting from meta-init %s", init_path)
    return params, init_path


def main(cfg: DotDict, run_dir: Optional[str] = None, image=None) -> Tuple[float, int]:
    """Run the compress pipeline; returns (decoded PSNR, compressed bytes)
    — the quant PSNR (or the fit PSNR) when no container is written.

    `image` (api.compress_image) is a preloaded (H, W, 3) float array in
    [0, 1] that replaces the image cfg.img names; cfg.img.height / width
    must already be its shape (the run dir's config.json sets the decoder's
    lattice)."""
    device = torch.device(cfg.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but no CUDA device is available")
    # fp32 products: `tensorfloat32` meant 3 passes on the TPU, never 1-pass TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_dir = run_dir or cfg.get("output_dir", "outputs/run")
    Path(run_dir).mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(run_dir, use=cfg.get("logging", {}).get("use", True))
    try:
        return _run(cfg, run_dir, device, logger, image)
    finally:
        logger.close()


def _run(cfg, run_dir: str, device: torch.device, logger: MetricsLogger,
         image=None) -> Tuple[float, int]:
    generator = torch.Generator().manual_seed(int(cfg.seed))
    if device.type == "cuda":
        # set-up, kept out of the stage walls: build (or load) the kernels
        from implicit_image_tpu_torch.ops.cuda_build import load_library

        t0 = time.perf_counter()
        load_library()
        logger.summary({"kernel_build_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    if load_native_codecs((cfg.get("entropy_coding") or {}).get("stream_name", "none")):
        logger.summary({"codec_build_s": time.perf_counter() - t0})
    (Path(run_dir) / "config.json").write_text(json.dumps(cfg, indent=2, default=str))

    img = np.asarray(image, np.float32) if image is not None else _load_image(cfg.img)
    h, w = img.shape[:2]
    grid = get_grid(h, w, device)
    mdef, mcfg = build_model_from_config(cfg)

    mult = int(cfg.train.get("multiplier", 1))
    num_steps = int(cfg.train.num_steps) * mult
    train_cfg = TrainConfig(
        num_steps=num_steps,
        log_steps=int(cfg.train.log_steps),
        pixel_chunks=_resolve_pixel_chunks(cfg.train.get("pixel_chunks", "auto"), h, w),
        loss=str(cfg.train.get("loss", "mse")),
        ssim_weight=float(cfg.train.get("ssim_weight", 0.84)),
        matmul_precision=cfg.train.get("matmul_precision") or None,
        matmul_precision_early=cfg.train.get("matmul_precision_early") or None,
        matmul_precision_switch=float(cfg.train.get("matmul_precision_switch", 0.75)),
        mixed_precision=bool(cfg.train.get("mixed_precision", False)),
        segment_steps=auto_segment_steps(cfg),
    )
    optim_cfg = _optim_config(cfg)
    masking = masking_config(cfg)

    init_params, init_path = _warm_start(cfg, mdef, mcfg, num_steps, device)
    if train_cfg.matmul_precision_early and init_path:
        log.warning("fit: train.matmul_precision_early with a warm start: the JAX package "
                    "measured the early noise walking a meta-init out of its basin (-0.2 to "
                    "-1.3 dB, config.yaml); the schedule pays on cold fits only")

    fit_kwargs = {}
    if cfg.train.get("checkpoint", False):
        fit_kwargs["checkpoint_path"] = Path(run_dir) / "checkpoint.npz"
    resume_from = cfg.train.get("resume") or None
    if resume_from:
        fit_kwargs["resume_from"] = resume_from
    if cfg.train.get("watch", False):
        def watch(params_w, opt_state_w, step_w):
            # per-layer weights and Adam's first moment, as the JAX package's watch
            tensors = {f"layers.{i}.{k}": v.detach().cpu().numpy()
                       for i, layer in enumerate(params_w) for k, v in layer.items()}
            if hasattr(opt_state_w, "mu"):
                tensors.update({f"layers.{i}.{k}.grad_ema": v.detach().cpu().numpy()
                                for i, layer in enumerate(opt_state_w.mu)
                                for k, v in layer.items()})
            logger.histogram(step_w, tensors)

        fit_kwargs["watch"] = watch
    stop_at = cfg.train.get("stop_at_psnr")
    if stop_at is not None:
        if resume_from:
            raise ValueError("train.stop_at_psnr cannot combine with train.resume "
                             "(step-index bookkeeping would misalign the metric log)")
        fit_kwargs["stop_psnr"] = float(stop_at)

    log.info("fit: %s on %s (%dx%d), %d steps, masking=%s, device %s",
             cfg.mlp.name, cfg.img.name, h, w, num_steps,
             (cfg.get("masking") or {}).get("name", "none"), device)
    with contextlib.ExitStack() as stack:
        if cfg.get("profile", False):
            # a torch.profiler trace of the fit, <run>/profile/trace.json
            stack.enter_context(trace(str(Path(run_dir) / "profile")))
            stack.enter_context(annotate("fit"))
        res = fit(generator, mdef, mcfg, grid, img, train_cfg, optim_cfg, masking,
                  init_params=init_params, device=device, **fit_kwargs)
    test_psnr = float("nan")
    # [first_step, end_step): the executed window (a resume starts late, an
    # early stop ends early)
    end_step = res.stopped_at if res.stopped_at is not None else num_steps
    first_step = end_step - len(res.metrics["psnr"])
    for i in range(first_step, end_step):
        if (i + 1) % train_cfg.log_steps == 0 or i == num_steps - 1:
            j = i - first_step
            entry = {"loss": float(res.metrics["test_loss"][j]),
                     "PSNR": float(res.metrics["psnr"][j]),
                     "PSNR_8bit": float(res.metrics["psnr_8bit"][j])}
            if masking is not None:
                entry["Prune Rate"] = float(res.metrics["prune_rate"][j])
                entry["Density"] = float(res.metrics["density"][j])
            logger.log(i + 1, entry)
            test_psnr = entry["PSNR"]
    if res.stopped_at is not None:
        # the check that stopped the fit is the freshest PSNR
        test_psnr = float(res.stop_psnr_db)
        log.info("fit: stop_at_psnr reached %.2f dB at step %d (budget %d)",
                 test_psnr, res.stopped_at, num_steps)
        logger.log(res.stopped_at, {"PSNR": test_psnr})
    logger.summary({"PSNR": test_psnr, "fit_wall_s": res.wall_seconds,
                    **({"stopped_at": res.stopped_at} if res.stopped_at is not None else {})})
    if "clip_scale" in res.metrics and len(res.metrics["clip_scale"]):
        # optim.grad_clip: the scale the clip applied (1 = not binding)
        logger.summary({"clip_scale_min": float(res.metrics["clip_scale"].min()),
                        "clip_scale_last": float(res.metrics["clip_scale"][-1])})
    params = res.params
    compressed_bytes = 0

    qres = None
    delta_info = None
    quant_raw = cfg.get("quant")
    if quant_raw and quant_raw.get("name", "none") != "none":
        quant_cfg = _quant_config(quant_raw)
        if bool(quant_raw.get("delta", False)):
            # residual codebooks against the meta-init, which becomes shared
            # encoder/decoder state: the container records it by path and sha256
            if quant_cfg.name != "KMeans":
                raise ValueError("quant.delta requires quant=kmeans")
            if not init_path:
                raise ValueError(
                    "quant.delta codes residuals against the meta-init "
                    "artifact; set train.init_path"
                )
            delta_info = {"artifact": str(init_path),
                          "sha256": hashlib.sha256(Path(init_path).read_bytes()).hexdigest()}
        quant_kwargs = dict(precision=train_cfg.precision, pixel_chunks=train_cfg.pixel_chunks,
                            masks=res.mask_state.masks if res.mask_state else None,
                            offset_params=init_params if delta_info is not None else None)
        qres = quant_finetune(params, img, mdef, mcfg, grid, quant_cfg, optim_cfg,
                              **quant_kwargs)
        quant_wall = qres.wall_seconds
        if (str(quant_raw.get("bit_alloc", "none")) == "auto" and quant_cfg.name == "KMeans"
                and quant_cfg.bits_per_layer is None):
            # per-layer widths (quant/allocate.py), finetuned too, adopted only
            # if the allocation dominates the uniform codebooks end to end
            from implicit_image_tpu_torch.quant.allocate import allocate_bits

            t0 = time.perf_counter()
            report = allocate_bits(mdef, mcfg, params, grid, img, quant_cfg,
                                   precision=_JAX_DEFAULT_PRECISION)
            synchronize(device)
            alloc_s = time.perf_counter() - t0
            chosen = quant_cfg
            if not report.chosen_uniform:
                auto_cfg = dataclasses.replace(quant_cfg, bits_per_layer=report.bits_per_layer)
                qres_auto = quant_finetune(params, img, mdef, mcfg, grid, auto_cfg, optim_cfg,
                                           **quant_kwargs)
                quant_wall += qres_auto.wall_seconds
                adopt = _auto_alloc_dominates(cfg, qres_auto, qres, mdef, mcfg, img, run_dir,
                                              device)
                if adopt:
                    qres, chosen = qres_auto, auto_cfg
                log.info("bit_alloc=auto: %s allocation %s",
                         "adopted" if adopt else "rejected (uniform dominates)",
                         report.bits_per_layer)
            quant_cfg = chosen
            qset = set(quantized_layer_indices(params, chosen))
            effective = chosen.bits_per_layer or tuple(
                chosen.bits if i in qset else None for i in range(len(params)))
            logger.summary({"Bit Allocation": [-1 if b is None else b for b in effective],
                            "bit_alloc_search_s": alloc_s})
        if delta_info is not None:
            delta_info["layers"] = [i for i, cb in enumerate(qres.codebooks) if cb is not None]
        qpsnr = qres.metrics["quant_psnr"]
        logger.log(num_steps, {"Quant PSNR": qpsnr,
                               "Quant PSNR_8bit": qres.metrics["quant_psnr_8bit"]},
                   prefix="Quant")
        logger.summary({"Quant PSNR": qpsnr, "quant_wall_s": quant_wall})
        test_psnr = qpsnr

    if cfg.train.get("save_weights", True):
        flat = {f"layers.{i}.{k}": v.detach().cpu().numpy()
                for i, layer in enumerate(params) for k, v in layer.items()}
        np.savez(Path(run_dir) / "model.npz", **flat)
        np.savez(Path(run_dir) / "model_half.npz",
                 **{k: v.astype(np.float16) for k, v in flat.items()})
        if res.mask_state is not None:
            # feeds masking.mask_path (lottery-ticket / resume) of a later run
            np.savez(Path(run_dir) / "mask.npz",
                     **{f"layers.{i}.mask": m.cpu().numpy()
                        for i, m in enumerate(res.mask_state.masks) if m is not None})

    ec = cfg.get("entropy_coding")
    if ec and ec.get("stream_name", "none") != "none":
        t0 = time.perf_counter()
        state = linear_state_dict(qres.params if qres else params,
                                  qres.codebooks if qres else None,
                                  half=_half_policy(ec))
        refmap = None
        if delta_info is not None and bool(ec.get("xor", True)):
            # lossless XOR residual of the unquantized tensors against the
            # meta-init (entropy_coding.xor=false opts out)
            refmap = state_ref_map(init_params)
            state, delta_info["xor"] = apply_xor_residual(state, refmap)
        container = Path(run_dir) / "model_quantized"
        level = int(ec.get("level", 22))
        ft_wall = []  # the base finetune's seconds, kept out of the encode wall
        if ec.get("progressive", False):
            base_ft, ft_wall = _base_finetune(ec, mdef, mcfg, grid, img, delta_info, refmap,
                                              init_params, device)
            from implicit_image_tpu_torch.coding.progressive import base_bytes, compress_progressive

            compressed_bytes = compress_progressive(state, container, ec.stream_name,
                                                    base_finetune=base_ft, delta=delta_info,
                                                    level=level)
            prefix = base_bytes(container)
            log.info("Compressed bytes %d (progressive: base prefix %d%s)", compressed_bytes,
                     prefix, ", delta" if delta_info is not None else "")
            logger.summary({"base_bytes": prefix, **({"base_finetune_wall_s": ft_wall[0]}
                                                     if ft_wall else {})})
        else:
            compressed_bytes = compress_state_dict(state, container, ec.stream_name,
                                                   delta=delta_info, level=level)
            log.info("Compressed bytes %d (%s)", compressed_bytes, ec.stream_name)
        encode_s = time.perf_counter() - t0 - sum(ft_wall)

        t0 = time.perf_counter()
        dec_img, _ = decode_and_render(container, ec.stream_name, mdef, mcfg, h, w,
                                       device=device, precision="fp32")
        decode_s = time.perf_counter() - t0
        dec64 = np.asarray(dec_img, np.float64)
        decoded_psnr = _decoded_psnr(img, dec64)
        mse8 = float(np.mean((np.trunc(dec64 * 255.0)
                              - np.trunc(np.asarray(img, np.float64) * 255.0)) ** 2))
        decoded_psnr8 = float(10.0 * np.log10(255.0**2 / max(mse8, 1e-12)))
        entry = {"Decoded PSNR": decoded_psnr, "Decoded PSNR_8bit": decoded_psnr8}
        # as many MS-SSIM scales as the lattice holds, at most 5
        lv = min(5, int(np.log2(max(min(h, w) // 11, 1))) + 1)
        if min(h, w) >= 11:
            with torch.no_grad():
                entry["Decoded MS-SSIM"] = float(ms_ssim(
                    torch.from_numpy(np.asarray(dec_img, np.float32)).to(device),
                    torch.from_numpy(np.asarray(img, np.float32)).to(device), levels=lv))
        logger.log(num_steps, entry, prefix="Decoded")
        logger.summary({"Compressed Bytes": compressed_bytes, "Decoded PSNR": decoded_psnr,
                        "encode_wall_s": encode_s, "decode_wall_s": decode_s,
                        **({"Decoded MS-SSIM": entry["Decoded MS-SSIM"]}
                           if "Decoded MS-SSIM" in entry else {})})
        test_psnr = decoded_psnr
    return test_psnr, compressed_bytes


def _base_finetune(ec, mdef, mcfg, grid, img, delta_info, refmap, init_params, device):
    """(the progressive container's base_finetune callable or None, a list
    that receives its wall seconds): entropy_coding.base_finetune, on by
    default, trains the base codebooks against the image (quant/base_layer.py)
    in JAX's default bf16 pass; on a delta stream the residual books against
    the base decode's rule, on the fp tensors un-XORed (XOR is a storage
    transform; the finetune renders real weights)."""
    if not ec.get("base_finetune", True):
        return None, []
    from implicit_image_tpu_torch.coding import _xor_arrays
    from implicit_image_tpu_torch.quant.base_layer import finetune_base_codebooks

    extra = {}
    if delta_info is not None:
        extra = {"delta_layers": list(delta_info["layers"]),
                 "delta_offsets": {i: init_params[i]["w"].detach().cpu().numpy()
                                   for i in delta_info["layers"]}}
    walls = []

    def base_ft(entries):
        if refmap is not None:
            entries = dict(entries)
            for name in delta_info["xor"]:
                if name in entries:
                    entries[name] = _xor_arrays(entries[name], refmap[name])
        t0 = time.perf_counter()
        books = finetune_base_codebooks(mdef, mcfg, grid, img, entries,
                                        precision=_JAX_DEFAULT_PRECISION, **extra)
        synchronize(device)
        walls.append(time.perf_counter() - t0)
        return books

    return base_ft, walls


def _run_job(overrides, multirun: bool):
    cfg = compose(overrides)
    subdir = ",".join(overrides).replace("/", "_") or "default"
    run_dir = cfg.get("output_dir", "outputs/run")
    if multirun:
        run_dir = os.path.join(run_dir, subdir)
    psnr, nbytes = main(cfg, run_dir=run_dir)
    return subdir, psnr, nbytes


@catch_error_decorator
def cli(argv=None) -> None:
    """`python -m implicit_image_tpu_torch.compress [overrides]`; with -m /
    --multirun every member of the comma lists' product runs into its own
    `<output_dir>/<overrides>`, launcher.n_jobs at once on worker threads
    (the JAX package's launcher: they share the one card)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    multirun = "-m" in argv or "--multirun" in argv
    argv = [a for a in argv if a not in ("-m", "--multirun")]
    jobs = expand_multirun(argv) if multirun else [argv]
    n_jobs = int((compose(jobs[0]).get("launcher") or {}).get("n_jobs", 1)) if jobs else 1
    threads = n_jobs > 1 and len(jobs) > 1
    results = []
    with ThreadPoolExecutor(max_workers=n_jobs) if threads else contextlib.nullcontext() as pool:
        for subdir, psnr, nbytes in (pool.map if threads else map)(
                lambda job: _run_job(job, multirun), jobs):
            print(f"[{subdir}] PSNR={psnr:.3f} bytes={nbytes}")
            results.append((psnr, nbytes))
    if len(results) == 1:
        psnr, nbytes = results[0]
        print(f"RESULT PSNR={psnr:.4f} COMPRESSED_BYTES={nbytes}")


if __name__ == "__main__":
    cli()
