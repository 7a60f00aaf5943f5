"""Rate-distortion plots and the study analyses (counterpart of
implicit_image_tpu/visualize/, which imports JAX for its MS-SSIM and its
synthetic images): the run-store readers are copies, the codecs' ladder is
scored with the port's ops/ssim.py and the image comes from the port's
data.py, so the scoring runs where JAX is absent. `bd_rate`, `width_depth`,
`weight_removal` and `sequence_curve` are copies reading the run store
through this package's `runs`. OpenCV (cv2) and matplotlib are imported
where they are used; without them the codec ladder and the plots raise
ImportError naming the package, and the scoring and the readers still run.
"""
from implicit_image_tpu_torch.visualize.runs import collect_runs, load_run

__all__ = [
    "collect_runs",
    "load_run",
    "traditional_rate_distortion",
    "ours_rate_distortion",
    "plot_rate_distortion",
]

_RD_NAMES = (
    "traditional_rate_distortion",
    "ours_rate_distortion",
    "plot_rate_distortion",
)


def __getattr__(name):
    # lazy: `python -m implicit_image_tpu_torch.visualize.rate_distortion`
    # imports this package first; an eager import here would load the module
    # being run twice (runpy's warning)
    if name in _RD_NAMES:
        from implicit_image_tpu_torch.visualize import rate_distortion

        return getattr(rate_distortion, name)
    raise AttributeError(name)
