"""2-D single-level db3 DWT / IDWT with zero padding (counterpart of
implicit_image_tpu/ops/wavelet.py), plain torch.

The PyWavelets convention, as in the JAX package:

  analysis:  full convolution with the decomposition filter, then the odd
             indices -> length floor((N + L - 1) / 2)
  synthesis: upsample by 2, full convolution with the reconstruction
             filter, crop L - 2 from the start -> length `out_len`

Along each axis either is a linear map, so it runs as one fp32 product with
the map's banded matrix (6 nonzeros per column), built once per length,
filter and device: x @ M along the columns, M^T @ x along the rows. A
product repeats bit for bit on the card, where cuDNN's transposed
convolution does not (its data-gradient kernels may add in any order), and
it costs one launch per product. The JAX package has no Pallas kernel here
(its DWT is XLA convolutions). With torch.backends.cuda.matmul.allow_tf32
set, a CUDA tensor raises rather than run 1-pass TF32 products.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.ops import check_fp32

__all__ = ["dwt2", "idwt2", "dwt_coeff_len", "DB3_DEC_LO"]

# Daubechies-3 decomposition low-pass filter (PyWavelets ordering).
DB3_DEC_LO = np.array(
    [
        0.035226291882100656,
        -0.08544127388224149,
        -0.13501102001039084,
        0.4598775021193313,
        0.8068915093133388,
        0.3326705529509569,
    ],
    dtype=np.float64,
)

_L = len(DB3_DEC_LO)


def _filters():
    dec_lo = DB3_DEC_LO
    # QMF relation, PyWavelets sign convention (pywt.Wavelet('db3').dec_hi):
    # dec_hi[n] = (-1)^(n+1) * dec_lo[L-1-n]
    dec_hi = np.array(
        [((-1.0) ** (n + 1)) * dec_lo[len(dec_lo) - 1 - n] for n in range(len(dec_lo))]
    )
    rec_lo = dec_lo[::-1].copy()
    rec_hi = dec_hi[::-1].copy()
    return dec_lo, dec_hi, rec_lo, rec_hi


def dwt_coeff_len(n: int) -> int:
    """Coefficient length for the zero-padded DWT of a length-n signal."""
    return (n + _L - 1) // 2


def _analysis_matrix(filt: np.ndarray, n: int) -> np.ndarray:
    """(n, M): column k holds the taps of coefficient k,
    y[k] = sum_t x[2k + t - (L - 2)] * filt[L - 1 - t]."""
    m = dwt_coeff_len(n)
    mat = np.zeros((n, m))
    for k in range(m):
        for t in range(_L):
            i = 2 * k + t - (_L - 2)
            if 0 <= i < n:
                mat[i, k] = filt[_L - 1 - t]
    return mat


def _synthesis_matrix(filt: np.ndarray, m: int, out_len: int) -> np.ndarray:
    """(m, out_len): row i spreads coefficient i over the cropped output,
    y[j] = sum_i x[i] * filt[j + (L - 2) - 2i]."""
    mat = np.zeros((m, out_len))
    for i in range(m):
        for t in range(_L):
            j = 2 * i + t - (_L - 2)
            if 0 <= j < out_len:
                mat[i, j] = filt[t]
    return mat


@functools.lru_cache(maxsize=None)
def _matrices(kind: str, m: int, n: int, device: torch.device, dtype: torch.dtype):
    """The (lo, hi) matrices of one axis on `device`: analysis of length n
    (kind "dwt"; m unused), or synthesis of m coefficients to n samples."""
    dec_lo, dec_hi, rec_lo, rec_hi = _filters()
    if kind == "dwt":
        mats = (_analysis_matrix(dec_lo, n), _analysis_matrix(dec_hi, n))
    else:
        mats = (_synthesis_matrix(rec_lo, m, n), _synthesis_matrix(rec_hi, m, n))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in mats)


def dwt2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-level 2-D db3 DWT of (H, W) -> (LL, LH, HL, HH), the band
    order of pytorch_wavelets' Yh stacking: LH (horizontal detail), HL
    (vertical detail), HH (diagonal)."""
    check_fp32(x, "the db3 DWT")
    h, w = x.shape
    rows_lo, rows_hi = _matrices("dwt", 0, h, x.device, x.dtype)
    cols_lo, cols_hi = _matrices("dwt", 0, w, x.device, x.dtype)
    lo_r = rows_lo.t() @ x
    hi_r = rows_hi.t() @ x
    return lo_r @ cols_lo, lo_r @ cols_hi, hi_r @ cols_lo, hi_r @ cols_hi


def idwt2(ll: torch.Tensor, lh: torch.Tensor, hl: torch.Tensor, hh: torch.Tensor,
          out_shape: Tuple[int, int]) -> torch.Tensor:
    """Single-level 2-D db3 inverse DWT -> (H, W) == out_shape."""
    check_fp32(ll, "the db3 inverse DWT")
    h, w = out_shape
    cols_lo, cols_hi = _matrices("idwt", ll.shape[1], w, ll.device, ll.dtype)
    rows_lo, rows_hi = _matrices("idwt", ll.shape[0], h, ll.device, ll.dtype)
    lo_r = ll @ cols_lo + lh @ cols_hi
    hi_r = hl @ cols_lo + hh @ cols_hi
    return rows_lo.t() @ lo_r + rows_hi.t() @ hi_r
