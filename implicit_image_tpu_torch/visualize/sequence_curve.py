"""Per-frame quality/rate plot for a sequence run (counterpart of
implicit_image_tpu/visualize/sequence_curve.py).

    python -m implicit_image_tpu_torch.visualize.sequence_curve outputs/seq_<name>

Reads seq_summary.json, which the port's sequence.encode_sequence writes,
and plots decoded PSNR and bytes per frame, marking I-frames — the
at-a-glance view of P-chain drift and the inter-frame rate saving. Output:
<seq_dir>/sequence_curve.pdf (or --out). matplotlib is imported by the plot
alone; `load_summary` runs without it.
"""
from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

from implicit_image_tpu_torch.visualize.runs import optional_import

__all__ = ["load_summary", "plot_sequence", "main"]

log = logging.getLogger("implicit_image_tpu_torch")


def load_summary(seq_dir) -> dict:
    """The sequence's seq_summary.json (its per-frame `rows`, `frames`,
    `bytes_per_frame`, `mean_decoded_psnr`); FileNotFoundError without it."""
    summary_file = Path(seq_dir) / "seq_summary.json"
    if not summary_file.is_file():
        raise FileNotFoundError(
            f"{summary_file} not found — encode the sequence first "
            "(python -m implicit_image_tpu_torch.sequence ...)"
        )
    return json.loads(summary_file.read_text())


def plot_sequence(seq_dir, out_path=None):
    """Render the per-frame curve; returns the output path."""
    seq_dir = Path(seq_dir)
    summary = load_summary(seq_dir)
    rows = summary["rows"]

    matplotlib = optional_import("matplotlib", "plot_sequence", "load_summary")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = list(range(len(rows)))
    psnr = [r["decoded_psnr"] for r in rows]
    kb = [r["bytes"] / 1024.0 for r in rows]
    iframes = [i for i, r in enumerate(rows) if r["kind"] == "I"]

    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.plot(t, psnr, "o-", color="tab:blue", label="decoded PSNR")
    ax1.set_xlabel("frame")
    ax1.set_ylabel("decoded PSNR (dB)", color="tab:blue")
    ax1.tick_params(axis="y", labelcolor="tab:blue")
    ax2 = ax1.twinx()
    ax2.bar(t, kb, color="tab:orange", alpha=0.35, label="bytes")
    ax2.set_ylabel("KB / frame", color="tab:orange")
    ax2.tick_params(axis="y", labelcolor="tab:orange")
    for i in iframes:
        ax1.axvline(i, color="gray", linestyle=":", alpha=0.6)
    ax1.set_title(
        f"{seq_dir.name}: {summary['frames']} frames, "
        f"{summary['bytes_per_frame'] / 1024.0:.1f} KB/frame, "
        f"mean {summary['mean_decoded_psnr']:.2f} dB "
        f"(dotted = I-frames)"
    )
    fig.tight_layout()
    out_path = Path(out_path) if out_path else seq_dir / "sequence_curve.pdf"
    fig.savefig(out_path)
    plt.close(fig)
    log.info("wrote %s", out_path)
    return out_path


def main(argv=None) -> None:
    """`<seq_dir> [--out file.pdf]`"""
    logging.basicConfig(level=logging.INFO)
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        raise SystemExit(__doc__)
    out = None
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i : i + 2]
    plot_sequence(args[0], out)


if __name__ == "__main__":
    main()
