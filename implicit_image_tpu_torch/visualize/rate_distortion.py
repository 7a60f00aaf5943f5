"""Rate-distortion curves: ours vs JPEG / JPEG2000 / WebP (counterpart of
implicit_image_tpu/visualize/rate_distortion.py, without JAX).

  * `traditional_rate_distortion`: re-encode the ground truth at a 20-point
    quality ladder per codec with OpenCV, recording (kilobytes, PSNR or
    MS-SSIM) per point;
  * `ours_rate_distortion`: ("Decoded PSNR" or "Decoded MS-SSIM",
    "Compressed Bytes") across the runs of the local run store;
  * `plot_rate_distortion`: the overlay plot, distortion vs KB.

MS-SSIM is the port's ops/ssim.py on the host (`_ms_ssim_np`), as many
scales as the image holds, as the JAX package's. cv2 and matplotlib are
imported where they are used and raise ImportError naming the package
where they are absent.

CLI:  python -m implicit_image_tpu_torch.visualize.rate_distortion \\
          img=flower outputs_root=outputs [metric=ms_ssim] [out=plot.pdf]
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.visualize.runs import collect_runs, optional_import

log = logging.getLogger("implicit_image_tpu_torch")

QUALITY_LADDER = np.linspace(1, 100, 20).astype(int)
_WITHOUT = "the run store's scoring (ours_rate_distortion)"


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def _ms_ssim_np(a: np.ndarray, b: np.ndarray) -> float:
    """MS-SSIM of two (H, W, C) images in [0, 1] through the port's
    ops/ssim.py in float32 on the host, as many scales as the image fits."""
    from implicit_image_tpu_torch.ops.ssim import ms_ssim

    lv = min(5, int(np.log2(max(min(a.shape[:2]) // 11, 1))) + 1)
    return float(ms_ssim(torch.from_numpy(np.asarray(a, np.float32)),
                         torch.from_numpy(np.asarray(b, np.float32)), levels=lv))


def traditional_rate_distortion(
    img: np.ndarray, ext: str = "jpg", metric: str = "psnr"
) -> List[Tuple[float, float]]:
    """(kilobytes, distortion) ladder for a standard codec, computed from
    the ground truth in memory (cv2.imencode). ext: 'jpg' | 'jp2' | 'webp';
    metric: 'psnr' | 'ms_ssim'."""
    cv2 = optional_import("cv2", "traditional_rate_distortion", _WITHOUT)
    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)[:, :, ::-1]  # RGB->BGR
    score = _psnr if metric == "psnr" else _ms_ssim_np
    points = []
    for q in QUALITY_LADDER:
        if ext == "jpg":
            flag = [cv2.IMWRITE_JPEG_QUALITY, int(q)]
        elif ext == "webp":
            flag = [cv2.IMWRITE_WEBP_QUALITY, int(q)]
        elif ext == "jp2":
            # OpenCV's jp2 compression scales 0-1000
            flag = [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, int(q * 10)]
        else:
            raise KeyError(ext)
        ok, buf = cv2.imencode(f".{ext}", img8, flag)
        if not ok:
            continue
        dec = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        points.append((len(buf) / 1024.0, score(dec / 255.0, img8 / 255.0)))
    return points


def ours_rate_distortion(
    outputs_root="outputs", img_name: Optional[str] = None, metric: str = "psnr",
) -> List[Tuple[float, float]]:
    """(kilobytes, distortion) from the local runs that carry the rate and
    distortion summary keys: 'Decoded PSNR' (the distortion a decoder of the
    written container recovers; 'Quant PSNR', then 'PSNR', for runs without
    it), or with metric='ms_ssim' 'Decoded MS-SSIM' (runs without it are
    skipped)."""
    runs = collect_runs(outputs_root, require=["Compressed Bytes"])
    points = []
    for run in runs:
        if img_name and img_name not in run["dir"]:
            continue
        if metric == "ms_ssim":
            val = run.get("Decoded MS-SSIM")
        else:
            val = run.get("Decoded PSNR", run.get("Quant PSNR", run.get("PSNR")))
        if val is None:
            continue
        points.append((run["Compressed Bytes"] / 1024.0, float(val)))
    return sorted(points)


def plot_rate_distortion(
    img: np.ndarray,
    outputs_root="outputs",
    img_name: Optional[str] = None,
    out_path: str = "outputs/plots/rate_distortion.pdf",
    metric: str = "psnr",
):
    """The overlay plot of the three codecs' ladders and the run store's
    points, written to out_path. A codec this OpenCV lacks is left out with
    a warning; without cv2 or matplotlib it raises ImportError."""
    matplotlib = optional_import("matplotlib", "plot_rate_distortion", _WITHOUT)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for ext, label in [("jpg", "JPEG"), ("jp2", "JPEG2000"), ("webp", "WebP")]:
        try:
            pts = traditional_rate_distortion(img, ext, metric=metric)
        except ImportError:
            raise
        except Exception as e:  # codec not built into this cv2
            log.warning("codec %s unavailable: %s", ext, e)
            continue
        if pts:
            kb, val = zip(*sorted(pts))
            ax.plot(kb, val, marker=".", label=label)
    ours = ours_rate_distortion(outputs_root, img_name, metric=metric)
    if ours:
        kb, val = zip(*ours)
        ax.plot(kb, val, marker="o", linewidth=2, label="Ours (INR)")
    ax.set_xlabel("Kilobytes")
    ax.set_ylabel("MS-SSIM" if metric == "ms_ssim" else "PSNR (dB)")
    ax.set_title(f"Rate-Distortion{' — ' + img_name if img_name else ''}")
    ax.legend()
    ax.grid(alpha=0.3)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:]))
    img_name = args.get("img", "synthetic")
    root = args.get("outputs_root", "outputs")
    metric = args.get("metric", "psnr")  # psnr | ms_ssim
    from implicit_image_tpu_torch.data import stable_seed, synthetic_image

    img = synthetic_image(512, 512, seed=stable_seed(img_name))
    suffix = "_msssim" if metric == "ms_ssim" else ""
    out = plot_rate_distortion(
        img, root, img_name,
        args.get("out", f"outputs/plots/{img_name}_rate_distortion{suffix}.pdf"),
        metric=metric,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
