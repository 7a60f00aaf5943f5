"""The JAX package's own CPU runs of chip_smoke.py phase 15's configurations
(QAT, Shampoo, the EKFAC preconditioner and its chunked capture, Fourier
at bfloat16 and Feathermap under the precision schedule), each at a SIDE²
lattice (the synthetic image samples the same function at any size), from
which phase 15's PSNR floors are set (a manual script, not collected by
pytest).

    PYTHONPATH=. python tests/phase15_floors.py --side 128 --out outputs/phase15_floors

Prints, per sub-phase, the decoded PSNR (or the fit PSNR where the run
writes no container). JAX on the CPU computes every product in fp32
whatever train.matmul_precision(_early) says, so (f) reads the fp32 fits
of its configurations.
"""
import argparse
import json
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

from implicit_image_tpu import compress as jcompress  # noqa: E402
from implicit_image_tpu.config import compose  # noqa: E402

CUT = ["train.num_steps=200", "train.log_steps=100", "quant.num_steps=20"]
RUNS = {
    "15a qat": CUT + ["masking=none", "quant=qat", "entropy_coding=zstd"],
    "15b qat per_tensor": CUT + ["quant=qat", "quant.qscheme=per_tensor", "entropy_coding=zstd"],
    "15c shampoo": CUT + ["optim=shampoo", "entropy_coding=plain"],
    "15d ekfac": CUT + ["+optim.preconditioner=ekfac", "entropy_coding=plain"],
    "15d ekfac chunks": ["+optim.preconditioner=ekfac", "train.pixel_chunks=2",
                         "train.num_steps=20", "train.log_steps=10", "quant=none",
                         "entropy_coding=none"],
    "15f fourier bf16": ["mlp=fourier", "train.matmul_precision=bfloat16", "masking=none",
                         "quant=none", "entropy_coding=none", "train.num_steps=20",
                         "train.log_steps=10"],
    "15f feathermap schedule": ["masking=Feathermap", "masking.density=0.2",
                                "train.matmul_precision_early=bfloat16", "quant=none",
                                "entropy_coding=none", "train.num_steps=20",
                                "train.log_steps=10"],
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--out", default="outputs/phase15_floors")
    ap.add_argument("--only", nargs="*", help="sub-phase names to run (default: all)")
    args = ap.parse_args()
    out = Path(args.out)
    rows = {}
    for name, overrides in RUNS.items():
        if args.only and name not in args.only:
            continue
        ov = overrides + ["img=synthetic", f"img.height={args.side}",
                          f"img.width={args.side}"]
        run_dir = out / name.replace(" ", "_")
        t0 = time.perf_counter()
        psnr, nbytes = jcompress.main(compose(ov), run_dir=str(run_dir))
        summary = json.loads((run_dir / "summary.json").read_text())
        rows[name] = {"psnr": psnr, "bytes": nbytes, "fit_psnr": summary.get("PSNR"),
                      "seconds": time.perf_counter() - t0}
        print(f"[{name}] {args.side}²: PSNR {psnr:.3f} dB (fit {summary.get('PSNR'):.3f}), "
              f"{nbytes} B, {rows[name]['seconds']:.1f} s", flush=True)
    out.mkdir(parents=True, exist_ok=True)
    (out / "floors.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
