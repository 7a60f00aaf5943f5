"""Where the time of an encode goes on the card.

    python -m implicit_image_tpu_torch.profile_fit [--out outputs/profile_fit.json] \
        [overrides ...]
    # the JAX bench's flagship recipe
    python -m implicit_image_tpu_torch.profile_fit --out outputs/flagship.json \
        mlp=coordx mlp.hidden_size=96 mlp.split_depth=5 masking.density=0.85 \
        train.num_steps=1200 train.init_path=auto quant.delta=true quant.row_stride=4 \
        entropy_coding=auto
    # the reference's finals operating point for its harder images
    # (scripts/finals.sh, one density): SIREN w182, 9-bit k-means, zstd, 5x steps
    python -m implicit_image_tpu_torch.profile_fit --out outputs/finals.json \
        img=big_building mlp.hidden_size=182 quant.bits=9 entropy_coding=zstd \
        train.multiplier=5 masking=RigL masking.density=0.5
    # the reference's other families (scripts/run_studies_r5.sh)
    python -m implicit_image_tpu_torch.profile_fit --out outputs/wavelet.json \
        img=synthetic mlp=wavelet_siren masking=none quant=kmeans entropy_coding=zstd
    python -m implicit_image_tpu_torch.profile_fit --out outputs/feathermap.json \
        img=synthetic masking=Feathermap masking.density=0.2 train.multiplier=5 \
        entropy_coding=zstd

Two parts, both on CUDA, with the composed default config (the JAX
default, masking=RigL) and the given overrides:

  1. the whole protocol through `compress.main`: the stage walls of
     summary.json, decoded PSNR, MS-SSIM, container bytes and, for
     `entropy_coding=auto`, the backend it chose;
  2. STEPS (30) fit steps of the same configuration under torch.profiler. From
     the device rows of the trace (kernels, copies, sets; no host row, so no
     time is counted twice) it reports each kernel's time and count, the
     device time per step (the run's one eval forward included), the
     profiled span, and the device's idle share over that span:
     1 - (union of the device rows' intervals) / span. The same steps run
     once more without the profiler for their ms per step, and once with
     masking=none beside them (a separable model, CoordX or hashgrid,
     runs its grid forward as the fit does; the fit's precision keys,
     the schedule and mixed precision included, apply to these steps); for a sparse config, the ms of one mask
     topology update (sparsity.update_connections) is timed on its own,
     host clock around MASK_UPDATES updates ending in a synchronize.

Prints one line per part and writes the record, with the card's name and
power limit, as JSON to --out; the chrome trace goes beside it
(<out stem>.trace.json).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from implicit_image_tpu_torch import compress
from implicit_image_tpu_torch.coding.parsers import _AUTO_ORDER
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model_from_config
from implicit_image_tpu_torch.optim import adam_momentum
from implicit_image_tpu_torch.sparsity import build_decay, total_density, update_connections
from implicit_image_tpu_torch.training.fit import TrainConfig, fit, make_grad_fn, set_trainable_

_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
STEPS = 30
MASK_UPDATES = 20


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def protocol(overrides, run_dir: Path) -> dict:
    cfg = compress.compose(list(overrides))
    t0 = time.perf_counter()
    psnr, nbytes = compress.main(cfg, run_dir=str(run_dir))
    wall = time.perf_counter() - t0
    summary = json.loads((run_dir / "summary.json").read_text())
    keys = ("kernel_build_s", "codec_build_s", "fit_wall_s", "quant_wall_s", "encode_wall_s",
            "decode_wall_s", "PSNR", "Quant PSNR", "Decoded MS-SSIM")
    record = {"main_wall_s": wall, "decoded_psnr": psnr, "bytes": nbytes,
              "stream": cfg.entropy_coding.stream_name,
              **{k: summary.get(k) for k in keys}}
    if record["stream"] == "auto":
        blob = (run_dir / "model_quantized" / "compressed_weights.data").read_bytes()
        record["auto_backend"] = _AUTO_ORDER[blob[0]]
    return record


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def trace_breakdown(trace_path: Path, steps: int) -> dict:
    """Device rows of a chrome trace: per-kernel totals, busy time and the
    idle share of the span the trace covers."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in _DEVICE_CATEGORIES]
    if not device:
        raise RuntimeError("the profiler recorded no device time; time with CUDA events")
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    rows = {}
    for e in device:
        row = rows.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])
    return {
        "span_ms": span / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_ms_per_step": sum(r[0] for r in rows.values()) / 1e3 / steps,
        "idle_share": 1.0 - busy / span,
        "rows": [{"name": name, "ms": us / 1e3, "count": n,
                  "ms_per_step": us / 1e3 / steps} for name, (us, n) in top],
    }


def mask_update_ms(res, mdef, mcfg, coords, target_flat, grid_hw, train_cfg, masking,
                   reps: int) -> float:
    """ms per mask topology update, on the final state of a sparse fit."""
    params = res.params
    set_trainable_(params, True)
    _, grads = make_grad_fn(mdef, mcfg, coords, target_flat, train_cfg.precision,
                            grid_hw=grid_hw)(params)
    momentum = "momentum" in (masking.growth_mode, masking.redistribution_mode)
    momenta = [adam_momentum(res.opt_state, i) if momentum and m is not None else None
               for i, m in enumerate(res.mask_state.masks)]
    state = res.mask_state
    rate = build_decay(masking)(0, 1.0 - total_density(state))
    gen = torch.Generator().manual_seed(0)
    update_connections(params, grads, momenta, state, rate, gen, masking)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        params, state = update_connections(params, grads, momenta, state, rate, gen, masking)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_steps(overrides, steps: int, trace_path: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    cfg = compress.compose(list(overrides))
    masking = compress.masking_config(cfg)
    dev = torch.device("cuda")
    img = compress._load_image(cfg.img)
    h, w = img.shape[:2]
    grid = get_grid(h, w, dev)
    mdef, mcfg = build_model_from_config(cfg)
    train_cfg = TrainConfig(
        num_steps=steps, log_steps=steps,
        pixel_chunks=compress._resolve_pixel_chunks(cfg.train.get("pixel_chunks", "auto"), h, w),
        matmul_precision=cfg.train.get("matmul_precision") or None,
        matmul_precision_early=cfg.train.get("matmul_precision_early") or None,
        matmul_precision_switch=float(cfg.train.get("matmul_precision_switch", 0.75)),
        mixed_precision=bool(cfg.train.get("mixed_precision", False)),
    )
    optim_cfg = compress._optim_config(cfg)

    def run(mask_cfg):
        return fit(torch.Generator().manual_seed(int(cfg.seed)), mdef, mcfg, grid, img,
                   train_cfg, optim_cfg, mask_cfg, device=dev)

    run(masking)  # warm-up: kernel build and load, allocator
    run(None)
    unprofiled = run(masking)
    dense = run(None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(masking)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_path))
    record = {
        "steps": steps,
        "masking": masking.name if masking is not None else "none",
        "ms_per_step": unprofiled.wall_seconds / steps * 1e3,
        "ms_per_step_dense": dense.wall_seconds / steps * 1e3,
        "profiled_wall_ms": wall * 1e3,
        **trace_breakdown(trace_path, steps),
    }
    if masking is not None:
        coords = grid.reshape(h * w, -1)
        target_flat = torch.as_tensor(img, dtype=torch.float32, device=dev).reshape(h * w, -1)
        record["ms_per_mask_update"] = mask_update_ms(
            unprofiled, mdef, mcfg, coords, target_flat, (h, w), train_cfg, masking,
            MASK_UPDATES)
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs/profile_fit.json")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    record = {"card": card(), "overrides": list(args.overrides)}
    print(record["card"], flush=True)
    record["protocol"] = protocol(args.overrides, out.parent / f"{out.stem}_protocol")
    print("protocol: " + json.dumps(record["protocol"]), flush=True)
    prof = profile_steps(args.overrides, STEPS, out.with_name(f"{out.stem}.trace.json"))
    record["profile"] = prof
    print(f"profile, {STEPS} fit steps, masking={prof['masking']}: ms/step "
          f"{prof['ms_per_step']:.3f} unprofiled ({prof['ms_per_step_dense']:.3f} with "
          f"masking=none; ms per mask update {prof.get('ms_per_mask_update', float('nan')):.3f}), "
          f"{prof['profiled_wall_ms'] / STEPS:.3f} profiled; device "
          f"{prof['device_ms_per_step']:.3f} ms/step; idle share {prof['idle_share']:.4f} "
          f"of a {prof['span_ms']:.1f} ms span", flush=True)
    for row in prof["rows"][:12]:
        print(f"  {row['ms_per_step']:9.4f} ms/step  {row['count']:6d}x  {row['name'][:90]}",
              flush=True)
    out.write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
