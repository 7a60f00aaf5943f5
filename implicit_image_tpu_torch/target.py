"""Target-rate / target-quality compression (counterpart of
implicit_image_tpu/target.py): `target.bytes=` / `target.db=`.

The density axis is searched with the density ladder
(parallel/ladder.ladder_compress): a coarse ladder of candidate densities
fitted together over the member axis, then `refine` bracketed ladders of up
to 3 members between the incumbent and its neighbour across the binding
constraint. Every probe is a complete run (fit, finetune, container,
decode) with its own run dir, and the choice is made on the decoded PSNR of
the written container against its real bytes:

  * target.bytes=N -> among members with bytes <= N, the best decoded PSNR;
    if none fits, the smallest member, reported as a miss.
  * target.db=X    -> among members with decoded PSNR >= X, the fewest
    bytes; if none reaches it, the best-PSNR member and the miss.
  * both           -> bytes <= N maximizing PSNR, reporting whether X was
    reached.

    python -m implicit_image_tpu_torch.target img=flower target.bytes=60000
    python -m implicit_image_tpu_torch.target img=flower target.db=48 target.refine=1

It takes compress.py's overrides (a masking.density list seeds the coarse
ladder; target.ladder sets its size, default 5; a dense config runs RigL)
and runs on the card (`device`, default "cuda": RuntimeError without one;
`device=cpu` runs the plain versions); the kernels build before the timed
search.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.parallel.ladder import build_ladder_args, ladder_compress
from implicit_image_tpu_torch.parallel.pipeline import PipelineResult

__all__ = ["compress_to_target", "TargetResult", "cli"]

log = logging.getLogger("implicit_image_tpu_torch")


class TargetResult(dict):
    """Plain dict result with attribute access for the chosen member."""

    __getattr__ = dict.__getitem__


def _meets(r: PipelineResult, tb: Optional[int], tdb: Optional[float]) -> bool:
    ok = True
    if tb is not None:
        ok &= r.compressed_bytes <= tb
    if tdb is not None:
        ok &= r.decoded_psnr >= tdb
    return ok


def _pick(members: List[Tuple[float, PipelineResult]], tb: Optional[int],
          tdb: Optional[float]) -> Tuple[float, PipelineResult, bool]:
    """The best (density, member) under the target, and False on a miss."""
    feasible = [(d, r) for d, r in members if _meets(r, tb, tdb)]
    if feasible:
        if tb is not None:  # rate-constrained: the best quality inside the budget
            d, r = max(feasible, key=lambda dr: dr[1].decoded_psnr)
        else:  # quality-constrained: the least rate at or above the bar
            d, r = min(feasible, key=lambda dr: dr[1].compressed_bytes)
        return d, r, True
    # a miss: the nearest side of the constraint
    if tb is not None:
        d, r = min(members, key=lambda dr: dr[1].compressed_bytes)
    else:
        d, r = max(members, key=lambda dr: dr[1].decoded_psnr)
    return d, r, False


def _bracket(members: List[Tuple[float, PipelineResult]], tb: Optional[int],
             tdb: Optional[float]) -> Tuple[float, float]:
    """The density interval to refine: between the last member inside the
    binding constraint and the first outside it (rate and, nearly, decoded
    PSNR rise with density)."""
    ms = sorted(members, key=lambda dr: dr[0])
    dens = [d for d, _ in ms]
    inside = [i for i, (_, r) in enumerate(ms) if _meets(r, tb, tdb)]
    if not inside:  # everything misses: refine around the nearest member
        if tb is not None:
            i = min(range(len(ms)), key=lambda i: ms[i][1].compressed_bytes)
            lo, hi = dens[max(i - 1, 0)], dens[i]
        else:
            i = max(range(len(ms)), key=lambda i: ms[i][1].decoded_psnr)
            lo, hi = dens[i], dens[min(i + 1, len(ms) - 1)]
        return min(lo, hi), max(lo, hi)
    if tb is not None:  # feasible = small densities: toward the first infeasible
        i = max(inside)
        j = min(i + 1, len(ms) - 1)
    else:  # feasible = large densities: toward the first infeasible
        i = min(inside)
        j = max(i - 1, 0)
    lo, hi = sorted((dens[i], dens[j]))
    return lo, hi


def compress_to_target(cfg, target_bytes: Optional[int] = None, target_db: Optional[float] = None,
                       densities: Optional[Sequence[float]] = None, ladder_size: int = 5,
                       refine: int = 1, out_root: Optional[str] = None) -> TargetResult:
    """Search the density axis for the cheapest member meeting the target:
    one coarse ladder (default np.geomspace(0.02, 0.9, ladder_size) rounded
    to 4 places), then `refine` ladders on the interior points of a 5-point
    linspace of the bracket that are not yet probed. Each ladder's members
    draw from a generator seeded with cfg.seed. The winner's bitstream is on
    disk when the search returns (<out_root>/<img>/<coarse|refine{k}>/d*)."""
    if target_bytes is None and target_db is None:
        raise ValueError("need target_bytes and/or target_db")
    args = build_ladder_args(cfg)  # opens the device: the kernels build outside the wall
    root = Path(out_root or "outputs/target") / cfg.img.name
    if densities is None:
        densities = list(np.round(np.geomspace(0.02, 0.9, ladder_size), 4))

    t0 = time.perf_counter()
    members: List[Tuple[float, PipelineResult]] = []

    def run_ladder(dens: Sequence[float], tag: str):
        results = ladder_compress(
            torch.Generator().manual_seed(int(cfg.seed)), args["mdef"], args["mcfg"],
            args["grid"], args["img"], args["train_cfg"], args["optim_cfg"], args["masking"],
            list(dens), quant_cfg=args["quant_cfg"], stream_name=args["stream_name"],
            stream_root=str(root / tag), half=args["half"], coding_kwargs=args["coding_kwargs"],
            init_params=args["init_params"], delta_info=args["delta_info"],
            device=args["device"])
        for d, r in zip(dens, results):
            members.append((float(d), r))
            log.info("target probe d=%.4g: decoded %.2f dB @ %d B", d, r.decoded_psnr,
                     r.compressed_bytes)

    run_ladder(densities, "coarse")
    for k in range(refine):
        lo, hi = _bracket(members, target_bytes, target_db)
        if hi - lo < 1e-3:
            break
        probed = {round(d, 4) for d, _ in members}
        new = [d for d in np.round(np.linspace(lo, hi, 5)[1:-1], 4)
               if d not in probed and 0.0 < d < 1.0]
        if not new:
            break
        run_ladder(new, f"refine{k}")

    d, r, hit = _pick(members, target_bytes, target_db)
    wall = time.perf_counter() - t0
    return TargetResult(
        density=d,
        decoded_psnr=r.decoded_psnr,
        compressed_bytes=r.compressed_bytes,
        target_met=hit,
        stream_dir=r.stream_dir,
        probes=[{"density": dd, "decoded_psnr": rr.decoded_psnr, "bytes": rr.compressed_bytes}
                for dd, rr in sorted(members, key=lambda dr: dr[0])],
        wall_s=round(wall, 2),
    )


def cli(argv=None) -> None:
    import sys

    from implicit_image_tpu_torch.config import compose

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    tb, tdb, refine, ladder_size = None, None, 1, 5
    densities = None
    kept = []
    for a in argv:
        if a.startswith("target.bytes="):
            tb = int(float(a.split("=", 1)[1]))
        elif a.startswith("target.db="):
            tdb = float(a.split("=", 1)[1])
        elif a.startswith("target.refine="):
            refine = int(a.split("=", 1)[1])
        elif a.startswith("target.ladder="):
            ladder_size = int(a.split("=", 1)[1])
        elif a.startswith("masking.density="):
            densities = [float(x) for x in a.split("=", 1)[1].split(",")]
        else:
            kept.append(a)
    cfg = compose(kept)
    if not cfg.get("masking") or cfg.masking.get("dense", False):
        kept = [a for a in kept if not a.startswith("masking=")]
        cfg = compose(kept + ["masking=RigL"])
    res = compress_to_target(cfg, target_bytes=tb, target_db=tdb, densities=densities,
                             ladder_size=ladder_size, refine=refine)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    cli()
