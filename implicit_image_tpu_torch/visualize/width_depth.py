"""Width/depth ablation plot (counterpart of
implicit_image_tpu/visualize/width_depth.py; reference
visualize/width_depth.py:46-209).

Reads runs from the local store whose dirs encode mlp.hidden_size /
mlp.depth overrides (the sweep in scripts/width_depth.sh writes one run per
(model, width, depth) combo; the port's `compress -m` names the run dirs as
the JAX CLI does) and plots PSNR vs depth and PSNR vs sqrt(width) per model
family (reference slurm_scripts/width_depth.sh:53-72: w in {64,96,128,256}
x d in {4,6,8,10}):

    python -m implicit_image_tpu_torch.visualize.width_depth \\
        outputs_root=outputs out=outputs/plots/width_depth.pdf

matplotlib is imported by the plot alone; `gather` runs without it.
"""
from __future__ import annotations

import logging
import re
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

from implicit_image_tpu_torch.visualize.runs import collect_runs, optional_import

__all__ = ["gather", "plot", "main"]

log = logging.getLogger("implicit_image_tpu_torch")

_W = re.compile(r"hidden_size=(\d+)")
_D = re.compile(r"depth=(\d+)")
_M = re.compile(r"mlp=(\w+)")


def gather(outputs_root="outputs"):
    """-> {model: {(width, depth): psnr}}"""
    table = defaultdict(dict)
    for run in collect_runs(outputs_root, require=["PSNR"]):
        d = run["dir"]
        w = _W.search(d)
        dep = _D.search(d)
        model = _M.search(d)
        if not (w and dep):
            continue
        table[model.group(1) if model else "siren"][
            (int(w.group(1)), int(dep.group(1)))
        ] = float(run.get("Quant PSNR", run["PSNR"]))
    return table


def plot(outputs_root="outputs", out_path="outputs/plots/width_depth.pdf"):
    matplotlib = optional_import("matplotlib", "width_depth.plot", "gather")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    table = gather(outputs_root)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for model, points in table.items():
        widths = sorted({w for w, _ in points})
        depths = sorted({d for _, d in points})
        # PSNR vs depth at each width
        for w in widths:
            ys = [points.get((w, d)) for d in depths]
            axes[0].plot(depths, ys, marker="o", label=f"{model} w={w}")
        # PSNR vs sqrt(width) at each depth
        for d in depths:
            ys = [points.get((w, d)) for w in widths]
            axes[1].plot(np.sqrt(widths), ys, marker="o", label=f"{model} d={d}")
    axes[0].set_xlabel("Depth")
    axes[1].set_xlabel("sqrt(Width)")
    for ax in axes:
        ax.set_ylabel("PSNR (dB)")
        ax.grid(alpha=0.3)
        ax.legend(fontsize=7)
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
                        args.get("out", "outputs/plots/width_depth.pdf")))


if __name__ == "__main__":
    main()
