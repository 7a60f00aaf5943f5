"""The JAX package's own CPU runs of chip_smoke.py phase 14's density
ladders, each at a SIDE² lattice (the synthetic image samples the same
function at any size), from which phase 14's PSNR floors are set (a manual
script, not collected by pytest).

    PYTHONPATH=. python tests/ladder_floors.py --side 128 --out /tmp/ladder_floors

Runs `python -m implicit_image_tpu.parallel.ladder` with phase 14's
overrides and prints each member's fit, quant and decoded PSNR and bytes.
JAX on the CPU computes every product in fp32.
"""
import argparse
import json
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

from chip_smoke import LADDER_CUT, LADDER_RUNS  # noqa: E402 (phase 14's overrides)
from implicit_image_tpu.parallel import ladder as jladder  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--out", default="outputs/ladder_floors")
    args = ap.parse_args()
    out = Path(args.out)
    rows = {}
    for name, overrides in LADDER_RUNS.items():
        root = out / name.replace(" ", "_")
        t0 = time.perf_counter()
        jladder.cli(overrides + LADDER_CUT + [f"img.height={args.side}",
                                              f"img.width={args.side}", f"output_dir={root}",
                                              "exp_name=floors"])
        members = sorted((root / "synthetic").glob("ladder_*_floors/d*"))
        rows[name] = {d.name: json.loads((d / "summary.json").read_text()) for d in members}
        print(f"[{name}] {args.side}², {time.perf_counter() - t0:.1f} s: " + "; ".join(
            f"{k}: decoded {v['Decoded PSNR']:.3f} dB, {v['Compressed Bytes']} B"
            for k, v in rows[name].items()), flush=True)
    out.mkdir(parents=True, exist_ok=True)
    (out / "floors.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
