"""Device ops: metrics, polynomial sine, the fused SIREN chain and its
kernels, the db3 DWT, the precision modes of the plain products
(precision.py); and the fp32 check of the products outside the kernels."""
from __future__ import annotations

import torch

__all__ = ["check_fp32"]


def check_fp32(x: torch.Tensor, what: str, precision: str = "fp32") -> None:
    """For a model whose products are plain torch.matmul (the JAX package
    runs them in XLA, outside any Pallas kernel): on the card the products
    must never be 1-pass TF32, so a CUDA tensor raises while
    torch.backends.cuda.matmul.allow_tf32 is set. A model that takes only
    the "fp32" precision (Fourier, Feathermap) passes its precision, and
    any other raises; CoordX and hashgrid take every mode (precision.py)
    and call it with the default."""
    if precision != "fp32":
        raise NotImplementedError(
            f"{what} runs in fp32 only; precision {precision!r} "
            "(train.matmul_precision=bfloat16 or null) is not ported yet"
        )
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{what} on CUDA needs fp32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
