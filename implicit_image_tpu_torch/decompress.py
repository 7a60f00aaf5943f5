"""Decode CLI (counterpart of implicit_image_tpu/decompress.py, one run dir
at the fitted size):

    python -m implicit_image_tpu_torch.decompress outputs/<img>/<exp> \
        [--out decoded.png] [--delta-artifact meta.npz] [--device cuda]

Reads `config.json` (written by either package's compress) to rebuild the
model and the stream backend, decodes `model_quantized/` (a delta container
needs its meta-init artifact: `--delta-artifact` overrides where it is
looked for), renders through the model registry on the GPU (SIREN and
wavelet-SIREN through the fused kernel chain, Feathermap after its V1 @ V2,
CoordX and Fourier features through fp32 products) and writes the image
next to the container. A wavelet-SIREN decodes at its training size only.
Batched decode, resolution-free rendering and packed .iic files are not
ported.
"""
from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from implicit_image_tpu_torch.coding import decode_and_render
from implicit_image_tpu_torch.data import save_img
from implicit_image_tpu_torch.models import build_model_from_config
from implicit_image_tpu_torch.utils import catch_error_decorator

log = logging.getLogger("implicit_image_tpu_torch")

__all__ = ["decode_run", "cli"]


def decode_run(run_dir, out_path=None, device="cuda", delta_artifact=None):
    """Decode one compress run directory; returns (image, stats).
    `delta_artifact` overrides where a delta container's artifact is looked
    for (coding._resolve_delta_offsets has the search order)."""
    # fp32 products: the decoder never renders with 1-pass TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_dir = Path(run_dir)
    cfg = json.loads((run_dir / "config.json").read_text())
    stream = cfg.get("entropy_coding", {}).get("stream_name", "zstd")
    if stream == "none":
        raise ValueError(f"{run_dir} was produced without entropy coding")
    mdef, mcfg = build_model_from_config(cfg)
    h, w = int(cfg["img"]["height"]), int(cfg["img"]["width"])
    img, stats = decode_and_render(run_dir / "model_quantized", stream, mdef, mcfg,
                                   h, w, device=device, precision="fp32",
                                   delta_artifact=delta_artifact)
    out_path = Path(out_path) if out_path else run_dir / "decoded.png"
    save_img(str(out_path), np.asarray(img))
    stats["out"] = str(out_path)
    return img, stats


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

    out = take_opt("--out")
    delta_artifact = take_opt("--delta-artifact")
    device = take_opt("--device") or "cuda"
    if len(argv) != 1:
        print(__doc__)
        raise SystemExit(2)
    _, stats = decode_run(argv[0], out, device=device, delta_artifact=delta_artifact)
    log.info("decoded %s: host %.1f ms + upload %.1f ms, render %.2f ms -> %s",
             argv[0], stats["decode_s"] * 1e3, stats["upload_s"] * 1e3,
             stats["render_s"] * 1e3, stats["out"])


if __name__ == "__main__":
    cli()
