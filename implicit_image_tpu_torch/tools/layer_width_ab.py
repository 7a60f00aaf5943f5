"""The routed K1/K2 pair against the layer-wise kernels at one width, on the card.

    python -m implicit_image_tpu_torch.tools.layer_width_ab [--width 256]
        [--pad-to P] [--side 512] [--precisions fp32 bf16] [--members 1 2]
        [--rounds 3] [--out FILE]

A SIREN of hidden width --width (d8, --side² pixels, seeded init and
cotangent) runs K1 and K2 as a fit step does, under autograd: K1 through
`siren_apply_flat_fused` (over M members `siren_apply_flat_batched_fused`)
on leaves that require grad, K2 its backward, on the kernels the width
routes to ("routed"; where they are the layer-wise ones K1 fills the z
stash and K2 takes it). Beside it, where the routed kernels are not the
layer-wise ones at the same kernel width, the layer-wise pair called
directly ("layer_wise"): K1 `_layer_fwd(..., stash=True)`, K2 `_layer_bwd`
from that stash, `sum_partials` and the gradients' split, at the model's
width rounded up to a multiple of 128, or with --pad-to P at P (the
model's weights zero-padded to it: padded units stay exactly 0). Each arm
is held against the plain chain in each mode of --precisions (fp32 1e-4 /
1e-4, the others 1.5e-3 / 2e-2: max abs error of the output, max abs error
over the largest plain value per gradient), then the arms' K1 and K2 are
timed in turns (CUDA events, routed, layer-wise, layer-wise, routed,
--rounds times, the median of 3 calls each) for each mode and member
count, with each arm's peak device memory over one pair. The routing
(`LW_MIN`) is not changed: the layer-wise wrappers are called here. Run
the tool in two checkouts, in turns, to compare their routes. Prints a
line per check and per pair, and writes the record, with the card's name
and power limit, as JSON to --out.
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
TOL = {"fp32": (1e-4, 1e-4)}  # the other modes: TOL_LOW (chip_smoke.py's LAYER_TOL)
TOL_LOW = (1.5e-3, 2e-2)


def _leaves(params):
    return [{k: layer[k].detach().clone().requires_grad_(True) for k in ("w", "b")}
            for layer in params]


def routed_pair(params, coords, g, cfg, precision: str, members: bool):
    """(K1, K2) of the routed autograd pair: K1() -> (out, leaves) through
    the Function the width routes to, K2((out, leaves)) -> the leaves'
    gradients of the chain for output cotangent g (its output map's / 2
    undone)."""
    apply = sm.siren_apply_flat_batched_fused if members else sm.siren_apply_flat_fused

    def k1():
        leaves = _leaves(params)
        return apply(leaves, coords, cfg, precision), leaves

    def k2(state):
        out, leaves = state
        out.backward(2.0 * g)
        return tuple({k: layer[k].grad for k in ("w", "b")} for layer in leaves)

    return k1, k2


def layer_pair(params, x, g, cfg, precision: str, members: bool, h: int):
    """(K1, K2) of the layer-wise pair at the kernel width of `params` (a
    multiple of 128): K1() -> (out, z), the forward filling the z stash; K2
    ((out, z)) -> (dx, grads) from that stash, the gradients at the model's
    width h, with a leading member axis where `members`."""
    depth, in_size = len(params), params[0]["w"].shape[-2]
    hidden, out_size = params[0]["w"].shape[-1], params[-1]["w"].shape[-1]
    bf16, mixed = sm.precision_modes(precision)
    run = params if members else [params]
    name = "sine_mlp_layer_fwd" + ("_batched" if members else "")

    def k1():
        return sm._layer_fwd(run, x, cfg, bf16, mixed, name, stash=True)

    def k2(state):
        dx, partials, sizes = sm._layer_bwd(run, x, g, cfg, precision, batched=members,
                                            z=state[1])
        flat = (sm.sum_partials_batched if members else sm.sum_partials)(partials, precision)
        lead = (params[0]["w"].shape[0],) if members else ()
        flat = sm._rnd(flat, True) if mixed else flat
        return dx, sm._split_grads(flat, lead, sizes, depth, in_size, hidden, h, out_size,
                                   turned=False)

    return k1, k2


def _max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _pair_ms(k1, k2, reps: int = 3):
    """(K1 ms, K2 ms): medians of `reps` calls after one, each between CUDA
    events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t1, t2 = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        start.record()
        state = k1()
        end.record()
        torch.cuda.synchronize()
        t1.append(start.elapsed_time(end))
        start.record()
        k2(state)
        end.record()
        torch.cuda.synchronize()
        t2.append(start.elapsed_time(end))
        del state
    return statistics.median(t1[1:]), statistics.median(t2[1:])


def _peak_gib(k1, k2) -> float:
    """Device memory one pair takes above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k2(k1())
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--pad-to", type=int, default=None)
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--precisions", nargs="+", default=["fp32"])
    ap.add_argument("--members", type=int, nargs="+", default=[1])
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
    h = args.width
    pad = args.pad_to or -(-h // sm.LAYER_TILE) * sm.LAYER_TILE
    if pad % sm.LAYER_TILE or pad < h:
        raise SystemExit(f"--pad-to {pad}: the layer-wise kernels take a multiple of "
                         f"{sm.LAYER_TILE} at or above the width {h}")
    routed_width = sm.kernel_width(h)
    both = routed_width != pad or routed_width <= sm.KERNEL_WIDTHS[-1]
    mdef, mcfg = build_model("siren", depth=DEPTH, hidden_size=h)
    gen = torch.Generator().manual_seed(0)
    models = [mdef.init(gen, mcfg, dev) for _ in range(max(args.members))]
    coords = get_grid(args.side, args.side, dev).reshape(-1, 2)
    x = (coords - 0.5) * 2.0
    n = x.shape[0]
    gs = (torch.randn((max(args.members), n, 3), generator=gen) / n).to(dev)
    tag = f"[layer_width_ab w{h} {args.side}² d{DEPTH}]"
    record = {"card": card, "width": h, "routed_kernel_width": routed_width,
              "layer_wise_width": pad, "side": args.side, "depth": DEPTH, "runs": {}}
    print(f"{tag} routed to kernel width {routed_width}"
          + (f"; the layer-wise pair at {pad}" if both else " (the layer-wise kernels)"),
          flush=True)

    def arms(prec: str, m: int):
        """The arms' (K1, K2) for m members (m = 1: one SIREN, no member
        axis) in mode prec."""
        batched = m > 1
        ps = models[:m]
        params = sm.stack_members(ps) if batched else ps[0]
        lw = [sm._pad_params(p, pad) for p in ps]
        lw = sm.stack_members(lw) if batched else lw[0]
        g = gs[:m] if batched else gs[0]
        out = {"routed": routed_pair(params, coords, g, mcfg, prec, batched)}
        if both:
            out["layer_wise"] = layer_pair(lw, x, g, mcfg, prec, batched, h)
        return out

    for prec in args.precisions:
        fwd_tol, bwd_tol = TOL.get(prec, TOL_LOW)
        for m in args.members:
            key = f"{prec} x{m}"
            run = record["runs"][key] = {}
            plain = [(sm.siren_chain_reference(p, x, mcfg, prec),
                      *sm.siren_chain_backward_reference(p, x, gm, mcfg, prec))
                     for p, gm in zip(models[:m], gs[:m])]
            for name, (k1, k2) in arms(prec, m).items():
                state = k1()
                out = (state[0] if name == "layer_wise" else (state[0] - 0.5) * 2.0).detach()
                got = k2(state)
                dx, grads = got if name == "layer_wise" else (None, got)
                out = out.reshape(m, n, -1)
                fwd, bwd = 0.0, 0.0
                for i, (o_p, dx_p, gr_p) in enumerate(plain):
                    pick = (lambda t: t[i]) if m > 1 else (lambda t: t)
                    fwd = max(fwd, float((out[i] - o_p).abs().max()))
                    pairs = [(pick(a[k]), b[k]) for a, b in zip(grads, gr_p) for k in ("w", "b")]
                    if dx is not None:
                        pairs.append((dx[i] if dx.dim() == 3 else dx, dx_p))
                    bwd = max([bwd] + [_max_rel(a, b) for a, b in pairs])
                run[f"{name}_errors"] = {"fwd_max_abs": fwd, "bwd_max_rel": bwd}
                print(f"{tag} {key} {name}: fwd max abs err {fwd:.3e} (tol {fwd_tol:g}), bwd "
                      f"max rel err {bwd:.3e} (tol {bwd_tol:g})", flush=True)
                if not (fwd <= fwd_tol and bwd <= bwd_tol):
                    raise SystemExit(f"{tag} {key} {name} fails the limits of its mode")
                del state, got
            del plain
            torch.cuda.empty_cache()
            pairs = arms(prec, m)
            times = {name: {"K1": [], "K2": []} for name in pairs}
            order = ["routed", "layer_wise", "layer_wise", "routed"] if both else ["routed"]
            for _ in range(args.rounds):
                for name in order:
                    k1_ms, k2_ms = _pair_ms(*pairs[name])
                    times[name]["K1"].append(k1_ms)
                    times[name]["K2"].append(k2_ms)
            for name in pairs:
                run[name] = times[name]
                run[f"{name}_peak_gib"] = _peak_gib(*pairs[name])
                med = {k: statistics.median(v) for k, v in times[name].items()}
                print(f"{tag} {key} {name}: K1 ms in turns "
                      f"{' '.join(f'{t:.3f}' for t in times[name]['K1'])} (median "
                      f"{med['K1']:.3f}); K2 {' '.join(f'{t:.3f}' for t in times[name]['K2'])} "
                      f"(median {med['K2']:.3f}); pair {med['K1'] + med['K2']:.3f}; peak "
                      f"{run[f'{name}_peak_gib']:.3f} GiB", flush=True)
            del pairs
            torch.cuda.empty_cache()
    print(f"{tag} {card}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
