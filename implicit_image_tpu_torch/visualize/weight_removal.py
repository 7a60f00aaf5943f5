"""Sparsity-method comparison plot (counterpart of
implicit_image_tpu/visualize/weight_removal.py; reference
visualize/weight_removal.py).

PSNR vs density for RigL / SNFS / Pruning / Small-Dense / Feathermap
against the dense baseline (reference :104-149; observed plot range
13-45 dB, :139). Runs are read from the local store; run dirs encode
masking=<name> and masking.density=<d> overrides (scripts/sparsify.sh), and
the port's compress and ladder CLIs write each run's config.json, which
takes precedence:

    python -m implicit_image_tpu_torch.visualize.weight_removal \\
        outputs_root=outputs out=outputs/plots/weight_removal.pdf

matplotlib is imported by the plot alone; `gather` runs without it.
"""
from __future__ import annotations

import logging
import re
import sys
from collections import defaultdict
from pathlib import Path

from implicit_image_tpu_torch.visualize.runs import collect_runs, optional_import

__all__ = ["gather", "plot", "main"]

log = logging.getLogger("implicit_image_tpu_torch")

_METHOD = re.compile(r"masking=(\w+)")
_DENSITY = re.compile(r"density=([\d.]+)")


def _classify(run):
    """(method, density) for a run — from the persisted config.json when
    present (authoritative: a `-m masking.density=...` multirun dir carries
    no `masking=<name>` token, and the composed default there is RigL),
    falling back to dir-name regexes for runs without config.json."""
    masking = (run.get("config") or {}).get("masking")
    if masking is not None:
        # classify by NAME: Small_Dense/Feathermap set dense:True yet belong
        # on the method curves (they compress via width/hashing, not masks)
        if not masking or masking.get("name") in (None, "none"):
            return "none", None
        density = masking.get("density")
        if masking.get("name") == "Pruning":
            # GMP sweeps final_density (init density stays 1.0) — the
            # study axis is the FINAL density
            density = masking.get("final_density", density)
        return masking.get("name"), density
    d = run["dir"]
    m = _METHOD.search(d)
    if m is None or m.group(1) == "none":
        return "none", None
    dens = _DENSITY.search(d)
    return m.group(1), float(dens.group(1)) if dens else None


def gather(outputs_root="outputs"):
    """-> ({method: [(density, psnr), ...]}, dense psnr or None)"""
    table = defaultdict(list)
    dense_psnr = None
    for run in collect_runs(outputs_root, require=["PSNR"]):
        # SIREN-protocol study only — a wavelet_siren RigL point in the
        # store must not masquerade as a study row
        mlp = (run.get("config") or {}).get("mlp") or {}
        if mlp.get("name", "siren") != "siren":
            continue
        psnr = float(run.get("Quant PSNR", run["PSNR"]))
        method, density = _classify(run)
        if method == "none":
            # the dense baseline line is the PROTOCOL control (w128 d8,
            # multiplier 5) — width×depth grid members are also
            # masking=none and must not masquerade as it. Reject only on
            # POSITIVE evidence of a non-protocol config (a store without
            # mlp/train records still gets its dense line)
            cfg = run.get("config") or {}
            mlp = cfg.get("mlp") or {}
            tr = cfg.get("train") or {}
            if (int(mlp.get("hidden_size", 128)) == 128
                    and int(mlp.get("depth", 8)) == 8
                    and int(tr.get("multiplier", 5)) == 5):
                dense_psnr = psnr
            continue
        if density is not None:
            table[method].append((float(density), psnr))
    return table, dense_psnr


def plot(outputs_root="outputs", out_path="outputs/plots/weight_removal.pdf"):
    matplotlib = optional_import("matplotlib", "weight_removal.plot", "gather")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    table, dense_psnr = gather(outputs_root)
    fig, ax = plt.subplots(figsize=(6, 4))
    for method, pts in sorted(table.items()):
        dens, psnr = zip(*sorted(pts))
        ax.plot(dens, psnr, marker="o", label=method)
    if dense_psnr is not None:
        ax.axhline(dense_psnr, linestyle="--", color="k", label="Dense")
    ax.set_xlabel("Density")
    ax.set_ylabel("PSNR (dB)")
    ax.legend()
    ax.grid(alpha=0.3)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None) -> None:
    """`key=value` arguments: outputs_root, out."""
    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv)
    print("wrote", plot(args.get("outputs_root", "outputs"),
                        args.get("out", "outputs/plots/weight_removal.pdf")))


if __name__ == "__main__":
    main()
