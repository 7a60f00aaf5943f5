"""Meta-init training CLI (counterpart of implicit_image_tpu/meta_train.py):

    python -m implicit_image_tpu_torch.meta_train mlp=coordx \\
        img.height=512 img.width=512 \\
        meta.pool_size=16 meta.inner_steps=100 meta.outer_steps=200 \\
        meta.out=outputs/meta/coordx.npz

It writes the .npz warm-start artifact that `train.init_path` of either
package consumes (training/metainit.py: REPTILE over a pool of synthetic
images). The `meta.*` keys are MetaConfig's fields plus `meta.out`; the
rest are the compress CLI's overrides (the model, the image size).
`train.matmul_precision` picks the kernels' mode, as in a single fit
(tensorfloat32 and float32: fp32; bfloat16: bf16), and is recorded in the
artifact's `meta.matmul_precision`, which `init_path=auto` matches. It runs
on the card (`device`, default "cuda": RuntimeError without one;
`device=cpu` runs the plain versions); the kernels build before the timed
wall. The last line printed is `META_INIT path=... wall_s=...
final_loss=...`.
"""
from __future__ import annotations

import dataclasses
import logging
import sys
from pathlib import Path

from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.models import build_model_from_config
from implicit_image_tpu_torch.ops.sine_mlp import precision_from_config
from implicit_image_tpu_torch.training.metainit import (
    MetaConfig,
    meta_pool,
    meta_train,
    save_meta_init,
)
from implicit_image_tpu_torch.utils import catch_error_decorator

__all__ = ["run", "cli"]

log = logging.getLogger(__name__)


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(min(n, k), 0, -1):
        if n % d == 0:
            return d
    return 1


def run(cfg) -> str:
    """Meta-train from a composed config; returns the artifact path."""
    from implicit_image_tpu_torch.data import get_grid
    from implicit_image_tpu_torch.ops.cuda_build import open_device

    device = open_device(cfg.get("device", "cuda"))
    h = int(cfg.img.height)
    w = int(cfg.img.width)
    meta_raw = dict(cfg.get("meta") or {})
    out = meta_raw.pop("out", None)
    fields = MetaConfig.__dataclass_fields__
    meta_cfg = MetaConfig(**{k: type(fields[k].default)(v) for k, v in meta_raw.items()
                             if k in fields})
    # chunk clamped to a divisor of outer_steps (a logging cadence), so the
    # CLI cannot trip meta_train's divisibility check
    chunk = _largest_divisor_leq(meta_cfg.outer_steps, meta_cfg.chunk)
    if chunk != meta_cfg.chunk:
        meta_cfg = dataclasses.replace(meta_cfg, chunk=chunk)

    mdef, mcfg = build_model_from_config(cfg)
    grid = get_grid(h, w, device)
    pool = meta_pool(h, w, meta_cfg.pool_size)
    log.info("meta-train: %s %dx%d pool=%d inner=%d outer=%d batch=%d on %s", mdef.name, h, w,
             meta_cfg.pool_size, meta_cfg.inner_steps, meta_cfg.outer_steps,
             meta_cfg.meta_batch, device)

    def progress(step, loss):
        log.info("meta-step %d/%d post-adapt loss %.3e", step, meta_cfg.outer_steps, loss)

    prec = cfg.get("train", {}).get("matmul_precision") or None
    params, losses, wall = meta_train(mdef, mcfg, grid, pool, meta_cfg, log=progress,
                                      precision=precision_from_config(prec), device=device)
    out = out or f"outputs/meta/{mdef.name}_{h}x{w}.npz"
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    save_meta_init(out, params, mdef.name, mcfg, matmul_precision=prec)
    log.info("meta-train: %.1fs, final post-adapt loss %.3e -> %s", wall, float(losses[-1]), out)
    print(f"META_INIT path={out} wall_s={wall:.1f} final_loss={float(losses[-1]):.4e}")
    return out


@catch_error_decorator
def cli(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    run(compose(list(sys.argv[1:] if argv is None else argv)))


if __name__ == "__main__":
    cli()
