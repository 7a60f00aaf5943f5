"""Many fits and many devices (counterpart of implicit_image_tpu/parallel/):
batched fits over a member axis, the batched compress pipeline and the
density ladder on one device; the ("image", "pixel") mesh over a
torch.distributed process group, the pixel-sharded fit, render and
pipeline, the member axis over the image ranks, and fleets of fits over
many processes (parallel/multihost.py)."""
from implicit_image_tpu_torch.parallel.batched import (
    batched_fit,
    make_batched_fit_fn,
    member_generators,
)
from implicit_image_tpu_torch.parallel.mesh import Mesh, make_mesh
from implicit_image_tpu_torch.parallel.pipeline import (
    PipelineResult,
    batched_compress,
    sharded_compress,
)
from implicit_image_tpu_torch.parallel.sharded import (
    make_sharded_fit_fn,
    sharded_fit,
    sharded_render,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "member_generators",
    "make_batched_fit_fn",
    "batched_fit",
    "make_sharded_fit_fn",
    "sharded_fit",
    "sharded_render",
    "PipelineResult",
    "batched_compress",
    "sharded_compress",
    "ladder_fit",
    "ladder_compress",
]


def __getattr__(name):
    # lazy: `python -m implicit_image_tpu_torch.parallel.ladder` imports this
    # package first; an eager ladder import here would load the module being
    # run twice (runpy's warning)
    if name in ("ladder_fit", "ladder_compress"):
        from implicit_image_tpu_torch.parallel import ladder

        return getattr(ladder, name)
    raise AttributeError(name)
