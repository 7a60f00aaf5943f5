"""The layer-wise kernels against the fused ones at one width, on the card.

    python -m implicit_image_tpu_torch.tools.layer_width_ab [--width 512]
        [--side 512] [--rounds 3] [--out FILE]

A SIREN of hidden width --width (512 by default, the widest fused kernel;
d8, --side² pixels, seeded init and cotangent) runs K1 and K2 twice: on
the kernels its width routes to (at 512 the fused `sine_mlp_fwd_wide`
kernel, then `sine_mlp_bwd_wide` with `sine_mlp_dw` and `sum_partials`),
and on the layer-wise kernels called directly (a launch a layer of
`sine_mlp_layer_fwd`; K2 the same chain again with the z stash, then
`sine_mlp_layer_bwd` and `sine_mlp_layer_dw` a layer and `sum_partials`
over the layer-wise row slices), at the same kernel width. Both are held
against the plain chain in the fp32 mode (the fp32 limits), then each pair
is timed in turns (CUDA events: routed, layer-wise, layer-wise, routed,
--rounds times). The routing (`LW_MIN`) is not changed: the layer-wise
wrappers are called here. Prints a line per check and per pair, and
writes the record, with the card's name and power limit, as JSON to
--out.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.ops import cuda_build as cb
from implicit_image_tpu_torch.ops import sine_mlp as sm

DEPTH = 8
FWD_TOL, BWD_TOL = 1e-4, 1e-4  # the fp32 mode's limits (chip_smoke.py)


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_wise_pair(params, x, g, cfg, precision: str = "fp32"):
    """K1 and K2 on the layer-wise kernels at the model's kernel width (a
    multiple of 128): (out, dx, grads) as `sine_mlp_fwd` / `sine_mlp_bwd`
    give them."""
    depth, (in_size, h), out_size = len(params), params[0]["w"].shape, params[-1]["w"].shape[1]
    hidden = sm.kernel_width(h)
    if hidden % sm.LAYER_TILE:
        raise ValueError(f"width {h} runs on kernel width {hidden}, not a multiple of "
                         f"{sm.LAYER_TILE}: the layer-wise kernels do not take it")
    bf16, mixed = sm.precision_modes(precision)
    out = sm._layer_fwd([params], x, cfg, bf16, mixed, "sine_mlp_layer_fwd")[0][0]
    dx, partials, sizes = sm._layer_bwd([params], x, g, cfg, precision, batched=False)
    flat = sm.sum_partials(partials, precision)
    grads = sm._split_grads(flat, (), sizes, depth, in_size, hidden, h, out_size, turned=False)
    return out, dx[0] if dx.dim() == 3 else dx, grads


def _errors(got, plain):
    (out_k, dx_k, gr_k), (out_p, dx_p, gr_p) = got, plain
    pairs = [(dx_k, dx_p)] + [(a[k], b[k]) for a, b in zip(gr_k, gr_p) for k in ("w", "b")]
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in pairs)
    return float((out_k - out_p).abs().max()), rel


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="outputs/layer_width_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layer_width_ab: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = cb.open_device("cuda")
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=args.width)
    gen = torch.Generator().manual_seed(0)
    params = mdef.init(gen, mcfg, dev)
    x = (get_grid(args.side, args.side, dev).reshape(-1, 2) - 0.5) * 2.0
    n = x.shape[0]
    g = (torch.randn((n, 3), generator=gen) / n).to(dev)
    tag = f"[layer_width_ab w{args.width} {args.side}² d{DEPTH}]"
    plain = (sm.siren_chain_reference(params, x, mcfg, "fp32"),
             *sm.siren_chain_backward_reference(params, x, g, mcfg, "fp32"))
    routed = (sm.sine_mlp_fwd(params, x, mcfg, "fp32"),
              *sm.sine_mlp_bwd(params, x, g, mcfg, "fp32"))
    layered = layer_wise_pair(params, x, g, mcfg, "fp32")
    torch.cuda.synchronize()
    record = {"card": card, "width": args.width, "kernel_width": sm.kernel_width(args.width),
              "side": args.side, "depth": DEPTH}
    for name, got in (("routed", routed), ("layer_wise", layered)):
        fwd, bwd = _errors(got, plain)
        record[f"{name}_errors"] = {"fwd_max_abs": fwd, "bwd_max_rel": bwd}
        print(f"{tag} {name}: fwd max abs err {fwd:.3e} (tol {FWD_TOL:g}), bwd max rel err "
              f"{bwd:.3e} (tol {BWD_TOL:g})", flush=True)
        if not (fwd <= FWD_TOL and bwd <= BWD_TOL):
            raise SystemExit(f"{tag} {name} fails the fp32 limits")
    del plain, routed, layered
    torch.cuda.empty_cache()
    bf16 = mixed = False
    pairs = {
        "K1": (lambda: sm.sine_mlp_fwd(params, x, mcfg, "fp32"),
               lambda: sm._layer_fwd([params], x, mcfg, bf16, mixed, "sine_mlp_layer_fwd")),
        "K2": (lambda: sm.sine_mlp_bwd(params, x, g, mcfg, "fp32"),
               lambda: layer_wise_pair(params, x, g, mcfg, "fp32")[1:]),
    }
    for what, (fused, layer) in pairs.items():
        times = {"routed": [], "layer_wise": []}
        for _ in range(args.rounds):
            for name, fn in (("routed", fused), ("layer_wise", layer), ("layer_wise", layer),
                             ("routed", fused)):
                times[name].append(_time_ms(fn, 3))
        record[what] = times
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"{tag} {what} ms in turns: routed {' '.join(f'{t:.3f}' for t in times['routed'])} "
              f"(median {med['routed']:.3f}); layer-wise "
              f"{' '.join(f'{t:.3f}' for t in times['layer_wise'])} (median "
              f"{med['layer_wise']:.3f}) = {med['layer_wise'] / med['routed']:.3f}x", flush=True)
    print(f"{tag} {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
