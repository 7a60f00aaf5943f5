"""Device ops: metrics, polynomial sine, the fused SIREN chain and its
kernels, the db3 DWT, the precision modes of the plain products
(precision.py); the fp32 check of the products outside the kernels, and
the batched eigendecompositions of the second-order optimizers."""
from __future__ import annotations

import torch

__all__ = ["check_fp32", "eigh_by_shape"]


def check_fp32(x: torch.Tensor, what: str) -> None:
    """For products that are plain torch.matmul (the JAX package runs them
    in XLA, outside any Pallas kernel: CoordX, hashgrid, Fourier,
    Feathermap's V1 @ V2, the DWT, Shampoo, the EKFAC capture): on the card
    an fp32 product must be true fp32, never 1-pass TF32, so a CUDA tensor
    raises while torch.backends.cuda.matmul.allow_tf32 is set. The "bf16"
    mode's products are one explicit bf16 pass (precision.py)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{what} on CUDA needs fp32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def eigh_by_shape(mats):
    """[(eigenvalues, eigenvectors)] of each symmetric matrix (ascending
    eigenvalues), from one batched torch.linalg.eigh per shape: on the card
    each call goes through cuSOLVER and synchronizes, so Shampoo's factors
    and EKFAC's Grams are stacked by shape rather than decomposed one by
    one. On the CPU a batch gives each matrix's own bits."""
    out = [None] * len(mats)
    by_shape = {}
    for j, m in enumerate(mats):
        by_shape.setdefault(tuple(m.shape), []).append(j)
    for idx in by_shape.values():
        w, v = torch.linalg.eigh(torch.stack([mats[j] for j in idx]))
        for slot, j in enumerate(idx):
            out[j] = (w[slot], v[slot])
    return out
