"""Many fits on one device (counterpart of implicit_image_tpu/parallel/):
batched fits over a member axis, the batched compress pipeline and the
density ladder. The mesh and the sharded fit, render and pipeline wait for
the multi-GPU slice (ROADMAP.md, M16)."""
from implicit_image_tpu_torch.parallel.batched import (
    batched_fit,
    make_batched_fit_fn,
    member_generators,
)
from implicit_image_tpu_torch.parallel.pipeline import PipelineResult, batched_compress

__all__ = [
    "member_generators",
    "make_batched_fit_fn",
    "batched_fit",
    "PipelineResult",
    "batched_compress",
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
