"""The composed protocol's decoded PSNR through the kernels, or through the
plain fp32 chain on the card (exact fp32 products, no kernel): what a
kernel's arithmetic does to a whole fit, which a one-shot error check
cannot show.

    python -m implicit_image_tpu_torch.tools.protocol_ab LABEL [--plain] [overrides ...]

Runs compress.main with `entropy_coding=plain` and the overrides into
outputs/protocol_ab_LABEL and prints one line: decoded PSNR, bytes, fit and
quant PSNR, the fit's ms a step (its wall over train.num_steps), wall, the
run's peak device memory (torch.cuda.max_memory_allocated) and the
launches of each kernel that ran. Run it from the root of each checkout to
compare commits on one card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from implicit_image_tpu_torch import compress
from implicit_image_tpu_torch.ops import sine_mlp as sm


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label")
    ap.add_argument("--plain", action="store_true",
                    help="run the plain fp32 chain on the card instead of the kernels")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("protocol_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.plain:
        sm.sine_mlp_fwd = sm.siren_chain_reference
        sm.sine_mlp_bwd = sm.siren_chain_backward_reference
    run_dir = f"outputs/protocol_ab_{args.label}"
    cfg = compress.compose(["entropy_coding=plain", f"output_dir={run_dir}"] + args.overrides)
    sm.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    psnr, nbytes = compress.main(cfg, run_dir=run_dir)
    summary = json.loads(open(f"{run_dir}/summary.json").read())
    ms_step = summary["fit_wall_s"] / int(cfg.train.num_steps) * 1e3
    print(f"[protocol_ab] {args.label} plain={args.plain} {args.overrides}: decoded "
          f"{psnr:.4f} dB, {nbytes} B, fit PSNR {summary['PSNR']:.4f}, quant PSNR "
          f"{summary['Quant PSNR']:.4f}, fit {ms_step:.3f} ms/step, wall "
          f"{time.perf_counter() - t0:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB, launches { {k: v for k, v in sm.LAUNCHES.items() if v} }", flush=True)
    return psnr


if __name__ == "__main__":
    main()
