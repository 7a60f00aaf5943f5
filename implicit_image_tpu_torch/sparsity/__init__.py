"""Sparse masking (counterpart of implicit_image_tpu/sparsity/): RigL, SNFS,
GMP (global-magnitude pruning) and their init schemes, prune, growth and
redistribution functions and decay schedules."""
from implicit_image_tpu_torch.sparsity.core import (
    MaskingConfig,
    MaskState,
    apply_masks,
    apply_masks_,
    create_mask_state,
    load_lottery_masks,
    mask_grads,
    mask_momentum,
    total_density,
    update_connections,
)
from implicit_image_tpu_torch.sparsity.decay import build_decay

__all__ = [
    "MaskState",
    "MaskingConfig",
    "apply_masks",
    "apply_masks_",
    "create_mask_state",
    "load_lottery_masks",
    "mask_grads",
    "mask_momentum",
    "total_density",
    "update_connections",
    "build_decay",
]
