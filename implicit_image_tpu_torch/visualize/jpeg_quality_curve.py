"""JPEG quality curves for the benchmark images: PSNR and file size vs
JPEG quality (counterpart of implicit_image_tpu/visualize/
jpeg_quality_curve.py, on the port's synthetic stand-ins). cv2 and
matplotlib are imported where they are used.

CLI:  python -m implicit_image_tpu_torch.visualize.jpeg_quality_curve \\
          [flower_foveon big_building bridge]
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path

import numpy as np

from implicit_image_tpu_torch.visualize.rate_distortion import _WITHOUT, QUALITY_LADDER, _psnr
from implicit_image_tpu_torch.visualize.runs import optional_import

log = logging.getLogger("implicit_image_tpu_torch")


def quality_curve(img: np.ndarray):
    """[(quality, kilobytes, psnr)] over the JPEG quality ladder."""
    cv2 = optional_import("cv2", "quality_curve", _WITHOUT)
    img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)[:, :, ::-1]
    out = []
    for q in QUALITY_LADDER:
        ok, buf = cv2.imencode(".jpg", img8, [cv2.IMWRITE_JPEG_QUALITY, int(q)])
        if not ok:
            continue
        dec = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        out.append((int(q), len(buf) / 1024.0, _psnr(dec / 255.0, img8 / 255.0)))
    return out


def plot(images: dict, out_path="outputs/plots/jpeg_quality.pdf"):
    matplotlib = optional_import("matplotlib", "plot", _WITHOUT)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for name, img in images.items():
        pts = quality_curve(img)
        q, kb, psnr = zip(*pts)
        axes[0].plot(q, psnr, marker=".", label=name)
        axes[1].plot(q, kb, marker=".", label=name)
    axes[0].set_xlabel("JPEG quality")
    axes[0].set_ylabel("PSNR (dB)")
    axes[1].set_xlabel("JPEG quality")
    axes[1].set_ylabel("Kilobytes")
    for ax in axes:
        ax.grid(alpha=0.3)
        ax.legend()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    from implicit_image_tpu_torch.data import stable_seed, synthetic_image

    names = sys.argv[1:] or ["flower_foveon", "big_building", "bridge"]
    images = {n: synthetic_image(512, 512, seed=stable_seed(n)) for n in names}
    print("wrote", plot(images))
