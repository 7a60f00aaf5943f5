"""The JAX package's own CPU runs of chip_smoke.py phase 12's configurations,
each at a SIDE² lattice (the synthetic image samples the same function at
any size), from which phase 12's PSNR floors are set (a manual script, not
collected by pytest).

    python tests/phase12_floors.py --side 128 --out /tmp/floors

Prints, per sub-phase, the decoded PSNR (or the fit PSNR where the run
writes no container) and for (c) the stop step. JAX on the CPU computes
every product in fp32 whatever train.matmul_precision(_early) says, so (a)
and (g) read the fp32 fit of their configuration.
"""
import argparse
import json
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

from implicit_image_tpu import compress as jcompress  # noqa: E402
from implicit_image_tpu.config import compose  # noqa: E402

RUNS = {
    "12a schedule": ["train.num_steps=200", "train.log_steps=100", "quant.num_steps=20",
                     "entropy_coding=plain", "train.matmul_precision_early=bfloat16"],
    "12a w182": ["mlp.hidden_size=182", "masking=none", "quant=none", "entropy_coding=none",
                 "train.num_steps=20", "train.log_steps=10",
                 "train.matmul_precision_early=bfloat16", "train.matmul_precision_switch=0.5"],
    "12b mixed": ["train.num_steps=200", "train.log_steps=100", "quant.num_steps=20",
                  "entropy_coding=plain", "train.mixed_precision=true"],
    "12c stop": ["train.num_steps=400", "train.log_steps=100", "train.segment_steps=25",
                 "train.stop_at_psnr={stop}", "quant.num_steps=20", "entropy_coding=plain"],
    "12e clip": ["mlp.hidden_size=512", "optim.lr=3e-4", "optim.grad_clip=1.0", "masking=none",
                 "quant=none", "entropy_coding=none", "train.num_steps=20",
                 "train.log_steps=10"],
    "12f exact sine": ["mlp.fast_sine=false", "masking=none", "train.num_steps=200",
                       "train.log_steps=100", "quant.num_steps=20", "entropy_coding=plain"],
    "12g coordx bf16": ["mlp=coordx", "mlp.hidden_size=96", "mlp.split_depth=5",
                        "masking.density=0.85", "train.num_steps=300", "train.log_steps=100",
                        "train.matmul_precision=bfloat16", "quant.row_stride=4",
                        "quant.num_steps=20", "entropy_coding=auto"],
    "12h hashgrid": ["mlp=hashgrid", "quant.skip_layers=[]", "optim.lr=1e-2",
                     "optim.epsilon=1e-15", "train.num_steps=300", "train.log_steps=100",
                     "quant.num_steps=20", "entropy_coding=zstd"],
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--stop", type=float, default=30.0, help="(c)'s train.stop_at_psnr")
    ap.add_argument("--out", default="outputs/phase12_floors")
    ap.add_argument("--only", nargs="*", help="sub-phase names to run (default: all)")
    args = ap.parse_args()
    out = Path(args.out)
    rows = {}
    for name, overrides in RUNS.items():
        if args.only and name not in args.only:
            continue
        ov = [o.format(stop=args.stop) for o in overrides] + [
            "img=synthetic", f"img.height={args.side}", f"img.width={args.side}"]
        run_dir = out / name.replace(" ", "_")
        t0 = time.perf_counter()
        psnr, nbytes = jcompress.main(compose(ov), run_dir=str(run_dir))
        summary = json.loads((run_dir / "summary.json").read_text())
        train = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
        stop = [x["step"] for x in train if x["prefix"] == "Train" and list(x) == [
            "step", "prefix", "PSNR"]]
        rows[name] = {"psnr": psnr, "bytes": nbytes, "fit_psnr": summary.get("PSNR"),
                      "stopped_at": stop[-1] if stop else None,
                      "seconds": time.perf_counter() - t0}
        print(f"[{name}] {args.side}²: PSNR {psnr:.3f} dB (fit {summary.get('PSNR'):.3f}), "
              f"{nbytes} B, stopped at {rows[name]['stopped_at']}, "
              f"{rows[name]['seconds']:.1f} s", flush=True)
    out.mkdir(parents=True, exist_ok=True)
    (out / "floors.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
