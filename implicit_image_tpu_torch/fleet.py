"""Fleet encode CLI (counterpart of implicit_image_tpu/fleet.py): many images
fitted together over a member axis.

    python -m implicit_image_tpu_torch.fleet fleet.images=a,b,c [overrides...]

Each entry of fleet.images is a benchmark image name (the file when present,
else its seeded synthetic stand-in, as compress.py loads it) or a path to an
image file. The fleet runs through parallel/pipeline.batched_compress: one
fit over the member axis (for a SIREN each step one `sine_mlp_fwd_batched`
and one `sine_mlp_bwd_batched` launch for every image; every family and fit
option runs there), the codebook finetune over the member axis, then each
member's container and decode. `train.init_path` starts every member
from one shared meta-init; `masking.dense` (masking=none) fits without
masks. Each member gets a compress-style run dir (config.json,
summary.json, model_quantized/) under `<output_dir>/fleet_<exp_name>/<name>`,
which both packages' decoders read (decompress.decode_run, and decode_runs
for the whole fleet in one K1 launch over the member axis).

It runs on the card (`device`, default "cuda": RuntimeError without one;
`device=cpu` runs the plain versions); the kernels build before the fleet's
timed wall.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.utils import catch_error_decorator

__all__ = ["run", "encode_fleet", "cli"]


def _member_overrides(entry: str):
    """A fleet entry -> (the img.* overrides selecting it, its name)."""
    p = Path(entry)
    if p.suffix and p.exists():
        return [f"img.path={entry}", f"img.name={p.stem}"], p.stem
    return [f"img.name={entry}"], entry


def run(argv) -> list:
    """Compose the config, load the fleet's images, encode them together and
    write the members' run dirs. Returns [(name, decoded PSNR, bytes), ...]."""
    from implicit_image_tpu_torch.compress import _load_image

    argv = list(argv)
    cfg = compose(argv)
    fleet_raw = (cfg.get("fleet") or {}).get("images")
    if not fleet_raw:
        raise ValueError("fleet.images=<name_or_path>[,...] is required "
                         "(benchmark names or image file paths)")
    entries = ([str(e) for e in fleet_raw] if isinstance(fleet_raw, (list, tuple))
               else str(fleet_raw).split(","))
    base = [a for a in argv if not a.startswith(("fleet.", "img.name=", "img.path="))]
    member_cfgs, names, imgs = [], [], []
    for entry in entries:
        ov, name = _member_overrides(entry)
        member_cfg = compose(base + ov)
        member_cfgs.append(member_cfg)
        names.append(name)
        imgs.append(_load_image(member_cfg.img))
    return encode_fleet(cfg, imgs, names, member_cfgs)


def encode_fleet(cfg, imgs, names, member_cfgs, root=None) -> list:
    """The fleet body: B same-shape (H, W, 3) arrays -> one fit over the
    member axis -> one run dir per member under `root` (default
    <output_dir>/fleet_<exp_name>). The CLI loads the arrays from
    fleet.images; api.compress_images passes them. Returns [(name, decoded
    PSNR, bytes), ...]."""
    from implicit_image_tpu_torch.parallel.ladder import build_ladder_args
    from implicit_image_tpu_torch.parallel.pipeline import batched_compress

    # the ladder's arguments (model, fit, optimizer, quantizer, stream, warm
    # start); it opens the device, so the kernels build before the wall.
    # The masking config is None for a dense fleet
    args = build_ladder_args(cfg)
    if root is None:
        root = Path(cfg.get("output_dir", "outputs")) / f"fleet_{cfg.get('exp_name', 'run')}"
    root = Path(root)
    t0 = time.perf_counter()
    results = batched_compress(
        torch.Generator().manual_seed(int(cfg.seed)), args["mdef"], args["mcfg"], args["grid"],
        np.stack(imgs), args["train_cfg"], args["optim_cfg"], args["masking"],
        quant_cfg=args["quant_cfg"], stream_name=args["stream_name"], stream_root=str(root),
        half=args["half"], coding_kwargs=args["coding_kwargs"],
        init_params=args["init_params"], delta_info=args["delta_info"],
        member_subdir="model_quantized", member_names=names, device=args["device"])
    wall = time.perf_counter() - t0

    out = []
    for name, member_cfg, r in zip(names, member_cfgs, results):
        run_dir = root / name
        member_cfg = json.loads(json.dumps(member_cfg, default=str))
        # the stream the member was written with (entropy_coding=none writes zstd)
        member_cfg.setdefault("entropy_coding", {})["stream_name"] = args["stream_name"]
        (run_dir / "config.json").write_text(json.dumps(member_cfg, indent=2))
        (run_dir / "summary.json").write_text(json.dumps({
            "PSNR": r.psnr,
            "Quant PSNR": r.quant_psnr,
            "Decoded PSNR": r.decoded_psnr,
            "Compressed Bytes": r.compressed_bytes,
            # the wall of the one fit over the member axis, shared by the members
            "fit_wall_s": r.fit_wall_s,
            "members": len(names),
        }, indent=2))
        print(f"[{name}] fit={r.psnr:.2f} dB decoded={r.decoded_psnr:.2f} dB "
              f"bytes={r.compressed_bytes}")
        out.append((name, r.decoded_psnr, r.compressed_bytes))
    print(f"FLEET {len(names)} images in {wall:.1f}s ({wall / len(names):.2f}s/image, one fit "
          "over the member axis)")
    return out


@catch_error_decorator
def cli(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    run(list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    cli()
