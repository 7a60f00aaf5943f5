"""The fp32 kernels against the plain chain element by element, and a
protocol's decoded PSNR over seeds, on the card.

    python -m implicit_image_tpu_torch.tools.grad_check [--widths 128 182]
        [--seeds 1 2] [--out FILE] [overrides ...]

(`--seeds` with no value runs no fit: `--widths 512 640 1024 2048 --seeds`
checks the kernels alone.)

At 512^2 pixels, d8 at each of --widths (default 128), the SIREN init of
seed 0 and the cotangent of an MSE loss against a smooth target, it runs
sine_mlp_fwd and sine_mlp_bwd and the plain chain (all on the card, the
plain one in fp32 with TF32 off) and prints the forward's largest error
and, per leaf of the backward, the largest error over the largest value
(the form the limits of tests/test_torch_kernels.py take) and the 99.9th
percentile and the largest of the elementwise relative error over the
entries above 1e-3 of the largest: an optimizer that scales each entry
(Adam) sees those. Beside them it prints, for the forward, dx and each
leaf, the same largest error of the kernels and of the plain fp32 chain
against the chain in float64 (`chain_float64`): the second says how much
of the first error is the plain chain's own rounding. Then it runs compress.main (the default protocol with
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
from implicit_image_tpu_torch.ops import cuda_build, fast_math
from implicit_image_tpu_torch.ops import sine_mlp as sm


def _poly(x: torch.Tensor, coeffs, odd: bool) -> torch.Tensor:
    """fast_math's polynomial in x's own dtype (fast_math casts to fp32)."""
    r = x - fast_math._2PI * torch.round(x * fast_math._INV2PI)
    r2 = r * r
    p = coeffs[-1] * r2 + coeffs[-2]
    for c in reversed(coeffs[:-2]):
        p = p * r2 + c
    return r * p if odd else p


def chain_float64(params, x: torch.Tensor, g: torch.Tensor, omegas):
    """(out, dx, grads) of the chain in float64: siren_chain_reference and
    siren_chain_backward_reference's fp32 mode in float64 arithmetic."""
    params = tuple({k: v.double() for k, v in layer.items()} for layer in params)
    x, g = x.double(), g.double()
    zs, a = [], x
    for i in range(len(params) - 1):
        z = a @ params[i]["w"] + params[i]["b"]
        zs.append(z)
        a = _poly(omegas[i] * z, fast_math._SIN_COEFFS, True)
    out = a @ params[-1]["w"] + params[-1]["b"]
    grads = [None] * len(params)
    grads[-1] = {"w": a.t() @ g, "b": g.sum(0)}
    ga = g @ params[-1]["w"].t()
    for i in range(len(params) - 2, -1, -1):
        gz = ga * (omegas[i] * _poly(omegas[i] * zs[i], fast_math._COS_COEFFS, False))
        prev = x if i == 0 else _poly(omegas[i - 1] * zs[i - 1], fast_math._SIN_COEFFS, True)
        grads[i] = {"w": prev.t() @ gz, "b": gz.sum(0)}
        ga = gz @ params[i]["w"].t()
    return out, ga, grads


def _over_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest error of a against ref over the largest |ref|."""
    a, ref = a.double(), ref.double()
    return float((a - ref).abs().max() / ref.abs().max())


def leaf_errors(dev, width: int = 128) -> dict:
    mdef, mcfg = build_model("siren", depth=8, hidden_size=width)
    params = mdef.init(torch.Generator().manual_seed(0), mcfg, dev)
    x = (get_grid(512, 512, dev).reshape(-1, 2) - 0.5) * 2.0
    target = (torch.sin(3 * x[:, :1] + 2 * x[:, 1:]) * 0.5).repeat(1, 3)
    out = sm.siren_chain_reference(params, x, mcfg, "fp32")
    out_k = sm.sine_mlp_fwd(params, x, mcfg, "fp32")
    g = 2 * (out - target) / out.numel()
    dx_k, grads = sm.sine_mlp_bwd(params, x, g, mcfg, "fp32")
    torch.cuda.empty_cache()
    dx, plain = sm.siren_chain_backward_reference(params, x, g, mcfg, "fp32")
    torch.cuda.empty_cache()
    omegas = [float(mcfg.first_omega_0)] + [float(mcfg.hidden_omega_0)] * 7
    out_64, dx_64, grads_64 = chain_float64(params, x, g, omegas)
    torch.cuda.empty_cache()
    rows = {"out": {"max_abs": float((out_k - out).abs().max()),
                    "max_over_max": _over_max(out_k, out),
                    "kernel_vs_f64": _over_max(out_k, out_64),
                    "fp32_vs_f64": _over_max(out, out_64)},
            "dx": {"max_over_max": _over_max(dx_k, dx), "kernel_vs_f64": _over_max(dx_k, dx_64),
                   "fp32_vs_f64": _over_max(dx, dx_64)}}
    for name in ("out", "dx"):
        row = rows[name]
        print(f"[grad_check] w{width} {name}: max error / max {row['max_over_max']:.2e}; "
              f"against float64 kernel {row['kernel_vs_f64']:.2e}, fp32 "
              f"{row['fp32_vs_f64']:.2e}", flush=True)
    for i, (k_layer, p_layer, f_layer) in enumerate(zip(grads, plain, grads_64)):
        for key in ("w", "b"):
            a, b = k_layer[key].double(), p_layer[key].double()
            top = float(b.abs().max())
            big = b.abs() > 1e-3 * top
            rel = ((a - b).abs() / b.abs().clamp_min(1e-30))[big].float()
            row = rows[f"{i}.{key}"] = {
                "max_over_max": float((a - b).abs().max()) / top,
                "p999": float(torch.quantile(rel, 0.999)) if rel.numel() > 10 else float(rel.max()),
                "max": float(rel.max()),
                "kernel_vs_f64": _over_max(a, f_layer[key]),
                "fp32_vs_f64": _over_max(b, f_layer[key]),
            }
            print(f"[grad_check] w{width} layer {i} {key}: max error / max "
                  f"{row['max_over_max']:.2e}, "
                  f"elementwise 99.9% {row['p999']:.2e}, max {row['max']:.2e}; against float64 "
                  f"kernel {row['kernel_vs_f64']:.2e}, fp32 {row['fp32_vs_f64']:.2e}", flush=True)
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
