"""The fp32 kernels against the plain chain element by element, and a
protocol's decoded PSNR over seeds, on the card.

    python -m implicit_image_tpu_torch.tools.grad_check [--widths 128 182]
        [--seeds 1 2] [--out FILE] [overrides ...]

At 512^2 pixels, d8 at each of --widths (default 128), the SIREN init of
seed 0 and the cotangent of an MSE loss against a smooth target, it runs
sine_mlp_fwd and sine_mlp_bwd and the plain chain (all on the card, the
plain one in fp32 with TF32 off) and prints the forward's largest error
and, per leaf of the backward, the largest error over the largest value
(the form the limits of tests/test_torch_kernels.py take) and the 99.9th
percentile and the largest of the elementwise relative error over the
entries above 1e-3 of the largest: an optimizer that scales each entry
(Adam) sees those. Then it runs compress.main (the default protocol with
the overrides, `plain` stream) at each of --seeds and prints the fit's
PSNR at each logged step and the decoded PSNR. Run it in two checkouts to
compare two kernels. Writes the record, with the card's name and power
limit, as JSON to --out.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from implicit_image_tpu_torch import compress
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import cuda_build
from implicit_image_tpu_torch.ops import sine_mlp as sm


def leaf_errors(dev, width: int = 128) -> dict:
    mdef, mcfg = build_model("siren", depth=8, hidden_size=width)
    params = mdef.init(torch.Generator().manual_seed(0), mcfg, dev)
    x = (get_grid(512, 512, dev).reshape(-1, 2) - 0.5) * 2.0
    target = (torch.sin(3 * x[:, :1] + 2 * x[:, 1:]) * 0.5).repeat(1, 3)
    out = sm.siren_chain_reference(params, x, mcfg, "fp32")
    out_k = sm.sine_mlp_fwd(params, x, mcfg, "fp32")
    g = 2 * (out - target) / out.numel()
    _, grads = sm.sine_mlp_bwd(params, x, g, mcfg, "fp32")
    _, plain = sm.siren_chain_backward_reference(params, x, g, mcfg, "fp32")
    rows = {"out": {"max_abs": float((out_k - out).abs().max()),
                    "max_over_max": float((out_k - out).abs().max() / out.abs().max())}}
    print(f"[grad_check] w{width} forward: max abs error {rows['out']['max_abs']:.2e}, over max "
          f"{rows['out']['max_over_max']:.2e}", flush=True)
    for i, (k_layer, p_layer) in enumerate(zip(grads, plain)):
        for key in ("w", "b"):
            a, b = k_layer[key].double(), p_layer[key].double()
            top = float(b.abs().max())
            big = b.abs() > 1e-3 * top
            rel = ((a - b).abs() / b.abs().clamp_min(1e-30))[big].float()
            row = rows[f"{i}.{key}"] = {
                "max_over_max": float((a - b).abs().max()) / top,
                "p999": float(torch.quantile(rel, 0.999)) if rel.numel() > 10 else float(rel.max()),
                "max": float(rel.max()),
            }
            print(f"[grad_check] w{width} layer {i} {key}: max error / max "
                  f"{row['max_over_max']:.2e}, "
                  f"elementwise 99.9% {row['p999']:.2e}, max {row['max']:.2e}", flush=True)
    return rows


def seed_fits(seeds, overrides=()) -> dict:
    fits = {}
    for seed in seeds:
        run_dir = Path(tempfile.mkdtemp(prefix=f"grad_check_{seed}_"))
        cfg = compress.compose([f"seed={seed}", "entropy_coding=plain", f"exp_name=gc{seed}",
                                *overrides])
        psnr, _ = compress.main(cfg, run_dir=str(run_dir))
        steps = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        fits[seed] = {"decoded_psnr": psnr,
                      "fit_psnr": {r["step"]: r["PSNR"] for r in steps if r.get("prefix") == "Train"}}
        print(f"[grad_check] seed {seed}: decoded {psnr:.3f} dB, fit PSNR by step "
              f"{fits[seed]['fit_psnr']}", flush=True)
    return fits


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--widths", type=int, nargs="+", default=[128])
    ap.add_argument("--out", default="outputs/grad_check.json")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    dev = cuda_build.open_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    record = {"card": card, "leaves": {w: leaf_errors(dev, w) for w in args.widths},
              "fits": seed_fits(args.seeds, args.overrides), "overrides": args.overrides}
    print(f"[grad_check] {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
