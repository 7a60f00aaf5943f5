"""Decode CLI (counterpart of implicit_image_tpu/decompress.py):

    python -m implicit_image_tpu_torch.decompress outputs/<img>/<exp> \
        [--out decoded.png] [--scale 4] [--size HxW] \
        [--roi row0:row1,col0:col1] [--tile-rows N] [--base] \
        [--delta-artifact meta.npz] [--device cuda]
    python -m implicit_image_tpu_torch.decompress run.iic
    python -m implicit_image_tpu_torch.decompress <run dir> <run dir> ...

Reads `config.json` (written by either package's compress) to rebuild the
model and the stream backend, decodes `model_quantized/` (a delta container
needs its meta-init artifact: `--delta-artifact` overrides where it is
looked for; `--base` reads a progressive container's base prefix only),
renders through the model registry on the GPU (SIREN and wavelet-SIREN
through the fused kernel chain, Feathermap after its V1 @ V2, CoordX,
Fourier features and hashgrid through fp32 products) and writes the image
next to the container (`decoded.png`, `decoded_base.png` for `--base`).

Resolution-free decode (one run): the weights render any lattice —
`--scale` / `--size` for a larger or smaller one, `--roi` for a window of
it (the slice of the full render, bit for bit), `--tile-rows` for row bands
one launch after another (bounding device memory on large outputs; one
launch takes at most ops/sine_mlp.MAX_ROWS rows). A wavelet-SIREN renders
its fitted lattice only.

A packed `.iic` file (coding/container_file.py) decodes like the run dir it
holds. A sequence's P-frame run dir decodes on its own: its container walks
its verified chain back to the I-frame (sequence.py). Several run dirs decode together (`decode_runs`): every stream is
decoded on the host, the runs are grouped by (model, config, H, W), and
each group renders in one member-axis forward (a SIREN group in one K1
launch over the member axis).
"""
from __future__ import annotations

import json
import logging
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from implicit_image_tpu_torch.coding import (
    decode_and_render,
    decompress_state_dict,
    params_from_state_dict,
    render_region,
)
from implicit_image_tpu_torch.data import get_grid, save_img
from implicit_image_tpu_torch.models import build_model_from_config
from implicit_image_tpu_torch.training.fit import synchronize
from implicit_image_tpu_torch.utils import catch_error_decorator

log = logging.getLogger("implicit_image_tpu_torch")

__all__ = ["decode_run", "decode_runs", "cli"]


def _fp32_products() -> None:
    # the decoder never renders with 1-pass TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _run_model(run_dir: Path):
    """(cfg, stream, mdef, mcfg, h, w) of a run dir's config.json."""
    cfg = json.loads((run_dir / "config.json").read_text())
    stream = cfg.get("entropy_coding", {}).get("stream_name", "zstd")
    if stream == "none":
        raise ValueError(f"{run_dir} was produced without entropy coding")
    mdef, mcfg = build_model_from_config(cfg)
    return cfg, stream, mdef, mcfg, int(cfg["img"]["height"]), int(cfg["img"]["width"])


def decode_run(run_dir, out_path=None, device="cuda", delta_artifact=None, scale=None,
               size=None, roi=None, tile_rows=0, base=False):
    """Decode one compress run directory, or a packed .iic file; returns
    (image, stats).

    scale: render the lattice at scale x the fitted size; size: (H, W), the
    lattice (before scale); roi: (row0, row1, col0, col1), a window of that
    lattice; tile_rows: row bands of at most that many rows; base: a
    progressive container's base prefix only; delta_artifact: where a
    delta container's artifact is looked for first
    (coding._resolve_delta_offsets has the search order)."""
    _fp32_products()
    run_dir = Path(run_dir)
    geometry = dict(scale=scale, size=size, roi=roi, tile_rows=tile_rows, base=base)
    if run_dir.is_file():
        from implicit_image_tpu_torch.coding.container_file import unpack_run

        with tempfile.TemporaryDirectory() as td:
            inner = unpack_run(run_dir, Path(td) / run_dir.stem)
            return decode_run(inner, out_path or run_dir.with_suffix(".decoded.png"), device,
                              delta_artifact, **geometry)
    _, stream, mdef, mcfg, h, w = _run_model(run_dir)
    if scale or size or roi or tile_rows:
        rh, rw = size if size else (h, w)
        if scale:
            rh, rw = round(rh * scale), round(rw * scale)
        t0 = time.perf_counter()
        state = decompress_state_dict(run_dir / "model_quantized", stream, delta_artifact,
                                      base_only=base)
        t1 = time.perf_counter()
        params = params_from_state_dict(state, device)
        synchronize(device)
        t2 = time.perf_counter()
        img = render_region(mdef, mcfg, params, rh, rw, roi=roi, tile_rows=tile_rows)
        t3 = time.perf_counter()
        stats = {"decode_s": t1 - t0, "upload_s": t2 - t1, "render_s": t3 - t2,
                 "lattice": (rh, rw), "window": tuple(roi) if roi else (0, rh, 0, rw)}
    else:
        img, stats = decode_and_render(run_dir / "model_quantized", stream, mdef, mcfg, h, w,
                                       device=device, precision="fp32",
                                       delta_artifact=delta_artifact, base_only=base)
    # the render includes the host copy of the image (and a first launch's
    # set-up): a one-shot rate, not a steady one
    stats["mpix_per_s"] = img.shape[0] * img.shape[1] / max(stats["render_s"], 1e-9) / 1e6
    out_path = Path(out_path) if out_path else run_dir / (
        "decoded_base.png" if base else "decoded.png")
    save_img(str(out_path), np.asarray(img))
    stats["out"] = str(out_path)
    return img, stats


def decode_runs(run_dirs, device="cuda"):
    """Decode many run dirs; returns their images in input order and writes
    each to its run dir's decoded.png.

    Every stream is decoded on the host, then the runs are grouped by
    (model, config, H, W): decoded weights are dense (centroids[labels]), so
    the members of a group share their shapes whatever their sparsity.
    Every group renders in one member-axis forward (`ModelDef.apply_batched`,
    the JAX package's vmap of the render): a SIREN group in one K1 launch
    over the member axis, each member the bits of its own decode; a
    wavelet-SIREN group in one per sub-SIREN; CoordX, Fourier, hashgrid and
    Feathermap groups under torch.func.vmap (their products batched over the
    members: each member within a few fp32 ulps of its own decode)."""
    _fp32_products()
    t0 = time.perf_counter()
    infos, groups = [], {}
    for idx, rd in enumerate(run_dirs):
        rd = Path(rd)
        _, stream, mdef, mcfg, h, w = _run_model(rd)
        state = decompress_state_dict(rd / "model_quantized", stream)
        groups.setdefault((mdef.name, repr(mcfg), h, w), []).append(idx)
        infos.append((rd, mdef, mcfg, h, w, params_from_state_dict(state, device)))
    synchronize(device)
    host_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    images = [None] * len(infos)
    for idxs in groups.values():
        _, mdef, mcfg, h, w, _ = infos[idxs[0]]
        grid = get_grid(h, w, device)
        members = [infos[i][5] for i in idxs]
        outs = [o.cpu().numpy() for o in mdef.apply_batched(members, grid, mcfg, "fp32")]
        for j, i in enumerate(idxs):
            images[i] = outs[j]
            save_img(str(infos[i][0] / "decoded.png"), outs[j])
    render_s = time.perf_counter() - t0
    log.info("batch-decoded %d runs in %d group(s): host %.1f ms, render+write %.1f ms",
             len(infos), len(groups), host_s * 1e3, render_s * 1e3)
    return images


@catch_error_decorator
def cli(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)

    def take_opt(name):
        if name not in argv:
            return None
        i = argv.index(name)
        if i + 1 >= len(argv):
            raise SystemExit(f"{name} needs a value")
        val = argv[i + 1]
        del argv[i : i + 2]
        return val

    base = "--base" in argv
    if base:
        argv.remove("--base")
    out = take_opt("--out")
    delta_artifact = take_opt("--delta-artifact")
    device = take_opt("--device") or "cuda"
    scale, size, roi, tile_rows = (take_opt(f"--{k}") for k in ("scale", "size", "roi",
                                                                "tile-rows"))
    geometry = dict(
        scale=float(scale) if scale else None,
        size=tuple(int(x) for x in size.split("x")) if size else None,
        roi=tuple(int(x) for x in roi.replace(",", ":").split(":")) if roi else None,
        tile_rows=int(tile_rows) if tile_rows else 0,
        base=base,
    )
    if geometry["size"] is not None and len(geometry["size"]) != 2:
        raise SystemExit("--size expects HxW, e.g. --size 1024x1024")
    if geometry["roi"] is not None and len(geometry["roi"]) != 4:
        raise SystemExit("--roi expects row0:row1,col0:col1")
    if not argv:
        print(__doc__)
        raise SystemExit(2)
    if len(argv) > 1:
        if out is not None or delta_artifact is not None or any(geometry.values()):
            raise SystemExit("--out/--scale/--size/--roi/--tile-rows/--base/--delta-artifact "
                             "take a single run dir")
        decode_runs(argv, device=device)
        return
    _, stats = decode_run(argv[0], out, device=device, delta_artifact=delta_artifact,
                          **geometry)
    log.info("decoded %s: host %.1f ms + upload %.1f ms, render %.2f ms (%.1f Mpix/s) -> %s",
             argv[0], stats["decode_s"] * 1e3, stats["upload_s"] * 1e3,
             stats["render_s"] * 1e3, stats["mpix_per_s"], stats["out"])


if __name__ == "__main__":
    cli()
