"""Wavelet-SIREN — two SIRENs predicting a db3 wavelet decomposition
(counterpart of implicit_image_tpu/models/wavelet_siren.py):

  * the LF SIREN predicts YCbCr on the DWT-LL lattice;
  * the HF SIREN predicts the Y detail bands (LH, HL, HH) on the same
    lattice, dwt_coeff_len(H) x dwt_coeff_len(W) (258 x 258 at 512²);
  * the inverse db3 DWT (zero mode) of (LL from LF, the bands from HF) is Y
    at full resolution;
  * Cb and Cr are the LF's channels 1-2, resized bilinearly with
    jax.image.resize's weights (half-pixel centres, a triangle kernel
    normalised over the samples inside the input: at the border all weight
    falls on the edge sample), as two fp32 products with the weight
    matrices — not F.interpolate, whose CUDA backward adds with atomics and
    does not repeat bit for bit;
  * YCbCr -> RGB with kornia's constants.

Both sub-SIRENs share depth, width and ω₀ (the width scaled by
sqrt(small_dense_density)); only wavelet_levels = 1 exists. The params are
the LF layers followed by the HF layers, so masking, quantization and the
container treat them as one layer stack. Each sub-SIREN runs through
models/siren.siren_apply_flat, the fused chain: on a CUDA tensor the
forward and backward kernels launch once per sub-SIREN, twice per fit step
(over a member axis, `wavelet_siren_apply_members`: the member-axis kernels,
twice per step for all members). The model renders only its configured
full grid.

Over a pixel group (`wavelet_siren_apply_split`, the sharded fit's and
render's, parallel/sharded.py): the DWT lattices' rows split into
contiguous shares that differ by at most one row (`lattice_share`: 258
rows at 512² over 4 ranks are 64, 65, 64, 65), each rank runs the two
sub-SIRENs on its share, the ranks' shares are gathered in rank order, and
every rank composes the whole image.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models.siren import (
    SirenConfig,
    init_siren,
    siren_apply_flat,
    siren_apply_flat_members,
)
from implicit_image_tpu_torch.ops.wavelet import dwt_coeff_len, idwt2

__all__ = [
    "WaveletSirenConfig",
    "init_wavelet_siren",
    "wavelet_siren_apply",
    "wavelet_siren_apply_flat",
    "wavelet_siren_apply_members",
    "wavelet_siren_apply_flat_members",
    "wavelet_siren_apply_split",
    "wavelet_siren_apply_members_split",
    "lattice_share",
    "ycbcr_to_rgb",
]


def ycbcr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """YCbCr (0.5-offset chroma, [0, 1]) -> RGB, kornia's convention."""
    y = img[..., 0]
    cb = img[..., 1] - 0.5
    cr = img[..., 2] - 0.5
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    b = y + 1.773 * cb
    return torch.stack([r, g, b], dim=-1)


@dataclass(frozen=True)
class WaveletSirenConfig:
    """Static config (defaults mirror conf/mlp/wavelet_siren.yaml)."""

    input_size: int = 2
    output_size: int = 3
    depth: int = 8
    hidden_size: int = 128
    wavelet_levels: int = 1
    first_omega_0: float = 50.0
    hidden_omega_0: float = 30.0
    outermost_linear: bool = True
    small_dense_density: float = 1.0
    # the target image size: the DWT lattices follow from it
    height: int = 512
    width: int = 512

    def __post_init__(self):
        assert self.wavelet_levels == 1, (
            "wavelet_levels > 1 is unsupported (the reference's IDWT call "
            "only ever reconstructs one level)"
        )

    def _sub(self, output_size: int) -> SirenConfig:
        return SirenConfig(
            input_size=self.input_size,
            output_size=output_size,
            depth=self.depth,
            hidden_size=self.hidden_size,
            first_omega_0=self.first_omega_0,
            hidden_omega_0=self.hidden_omega_0,
            outermost_linear=self.outermost_linear,
            small_dense_density=self.small_dense_density,
        )

    @property
    def lf_config(self) -> SirenConfig:
        return self._sub(self.output_size)

    @property
    def hf_config(self) -> SirenConfig:
        return self._sub(self.output_size * self.wavelet_levels)

    @property
    def n_lf_layers(self) -> int:
        return self.depth

    @property
    def lf_shape(self) -> Tuple[int, int]:
        return dwt_coeff_len(self.height), dwt_coeff_len(self.width)

    @property
    def hf_shape(self) -> Tuple[int, int]:
        return self.lf_shape


def init_wavelet_siren(generator: torch.Generator, cfg: WaveletSirenConfig, device="cpu"):
    """The LF SIREN's init, then the HF SIREN's, from one generator."""
    lf = init_siren(generator, cfg.lf_config, device)
    hf = init_siren(generator, cfg.hf_config, device)
    return tuple(lf) + tuple(hf)


@functools.lru_cache(maxsize=None)
def _grid_flat(h: int, w: int, device: torch.device) -> torch.Tensor:
    """The training grid convention (data.get_grid) at a DWT lattice, flat;
    built once per lattice and device."""
    return get_grid(h, w, device).reshape(h * w, 2)


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in) weights of jax.image.resize's "bilinear" along one axis
    (antialiased: the kernel widens by n_in / n_out when shrinking)."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    weights = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(n_in)[:, None])
                         / kernel_scale)
    weights = weights / weights.sum(axis=0, keepdims=True)
    weights[:, (sample < -0.5) | (sample > n_in - 0.5)] = 0.0
    return torch.as_tensor(weights.T, dtype=torch.float32, device=device)


def _upsample(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h0, w0, C) -> (h, w, C), resized bilinearly as jax.image.resize does."""
    rows = _resize_matrix(x.shape[0], h, x.device)
    cols = _resize_matrix(x.shape[1], w, x.device)
    return (rows @ x.permute(2, 0, 1) @ cols.t()).permute(1, 2, 0)


def wavelet_siren_apply(params, grid: torch.Tensor, cfg: WaveletSirenConfig,
                        precision: str = "fp32") -> torch.Tensor:
    """Forward -> (H, W, 3) RGB. The grid is read for its shape and device
    only: each sub-SIREN runs on its own DWT lattice."""
    h, w = grid.shape[:2]
    assert (h, w) == (cfg.height, cfg.width), (
        f"grid {h}x{w} != configured {cfg.height}x{cfg.width}"
    )
    lf_params = params[: cfg.n_lf_layers]
    hf_params = params[cfg.n_lf_layers :]
    lf_h, lf_w = cfg.lf_shape
    hf_h, hf_w = cfg.hf_shape

    lf_img = siren_apply_flat(lf_params, _grid_flat(lf_h, lf_w, grid.device), cfg.lf_config,
                              precision).reshape(lf_h, lf_w, cfg.output_size)
    hf_img = siren_apply_flat(hf_params, _grid_flat(hf_h, hf_w, grid.device), cfg.hf_config,
                              precision).reshape(hf_h, hf_w, 3)
    return _compose(lf_img, hf_img, h, w)


def _compose(lf_img: torch.Tensor, hf_img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The two sub-SIRENs' lattices -> (h, w, 3) RGB."""
    # Y: the inverse DWT of (LL from the LF SIREN, the bands from the HF SIREN)
    y = idwt2(lf_img[:, :, 0], hf_img[:, :, 0], hf_img[:, :, 1], hf_img[:, :, 2], (h, w))
    cbcr = _upsample(lf_img[:, :, 1:], h, w)
    return ycbcr_to_rgb(torch.cat([y[:, :, None], cbcr], dim=-1))


def wavelet_siren_apply_members(params, grid: torch.Tensor, cfg: WaveletSirenConfig,
                                precision: str = "fp32") -> torch.Tensor:
    """The member-axis forward (params whose leaves carry a leading member
    axis) -> (M, H, W, 3), differentiable: each sub-SIREN through
    siren_apply_flat_members (one K1 and one K2 launch over the member axis
    per sub-SIREN on the card), then the inverse DWT, the chroma resize and
    the colour transform under torch.func.vmap over the stacked lattices."""
    h, w = grid.shape[:2]
    assert (h, w) == (cfg.height, cfg.width), (
        f"grid {h}x{w} != configured {cfg.height}x{cfg.width}"
    )
    lf_h, lf_w = cfg.lf_shape
    hf_h, hf_w = cfg.hf_shape
    lf = siren_apply_flat_members(params[: cfg.n_lf_layers], _grid_flat(lf_h, lf_w, grid.device),
                                  cfg.lf_config, precision)
    hf = siren_apply_flat_members(params[cfg.n_lf_layers :], _grid_flat(hf_h, hf_w, grid.device),
                                  cfg.hf_config, precision)
    m = lf.shape[0]
    return torch.func.vmap(lambda a, b: _compose(a, b, h, w))(
        lf.reshape(m, lf_h, lf_w, cfg.output_size), hf.reshape(m, hf_h, hf_w, 3))


def wavelet_siren_apply_flat_members(params, coords: torch.Tensor, cfg: WaveletSirenConfig,
                                     precision: str = "fp32") -> torch.Tensor:
    """(N, 2) -> (M, N, 3); N must be height * width (the full grid)."""
    n = coords.shape[0]
    assert n == cfg.height * cfg.width, (
        f"wavelet_siren is a full-grid model: N={n} != H*W={cfg.height * cfg.width}"
    )
    out = wavelet_siren_apply_members(params, coords.reshape(cfg.height, cfg.width, -1), cfg,
                                      precision)
    return out.reshape(out.shape[0], n, -1)


def wavelet_siren_apply_flat(params, coords: torch.Tensor, cfg: WaveletSirenConfig,
                             precision: str = "fp32") -> torch.Tensor:
    """(N, 2) -> (N, 3); N must be height * width (the full grid)."""
    n = coords.shape[0]
    assert n == cfg.height * cfg.width, (
        f"wavelet_siren is a full-grid model: N={n} != H*W={cfg.height * cfg.width}"
    )
    out = wavelet_siren_apply(params, coords.reshape(cfg.height, cfg.width, -1), cfg,
                              precision)
    return out.reshape(n, -1)


def lattice_share(rows: int, part: int, parts: int) -> slice:
    """Share `part` of `parts` of a lattice's rows: [part rows / parts,
    (part + 1) rows / parts), contiguous, in order, differing by at most one
    row."""
    return slice(part * rows // parts, (part + 1) * rows // parts)


def _share_coords(cfg: WaveletSirenConfig, part: int, parts: int, device) -> torch.Tensor:
    """The flat coordinates of share `part` of the DWT lattice's rows."""
    lf_h, lf_w = cfg.lf_shape
    rows = lattice_share(lf_h, part, parts)
    return _grid_flat(lf_h, lf_w, device)[rows.start * lf_w: rows.stop * lf_w]


def wavelet_siren_apply_split(params, grid: torch.Tensor, cfg: WaveletSirenConfig,
                              precision: str, part: int, parts: int, gather) -> torch.Tensor:
    """The forward of one of `parts` ranks -> the whole (H, W, 3) RGB: each
    sub-SIREN on share `part` of its lattice's rows (`lattice_share`);
    `gather(t, counts)` returns every rank's share of t (rows on dim 0,
    counts[r] on rank r) in rank order, differentiably (its gradient on this
    rank's share is that share's slice). With parts = 1 it is
    wavelet_siren_apply's image."""
    h, w = grid.shape[:2]
    assert (h, w) == (cfg.height, cfg.width), (
        f"grid {h}x{w} != configured {cfg.height}x{cfg.width}"
    )
    lf_h, lf_w = cfg.lf_shape
    counts = [lattice_share(lf_h, r, parts).stop - lattice_share(lf_h, r, parts).start
              for r in range(parts)]
    coords = _share_coords(cfg, part, parts, grid.device)
    lf = siren_apply_flat(params[: cfg.n_lf_layers], coords, cfg.lf_config, precision)
    hf = siren_apply_flat(params[cfg.n_lf_layers :], coords, cfg.hf_config, precision)
    lf_img = gather(lf.reshape(-1, lf_w, cfg.output_size), counts)
    hf_img = gather(hf.reshape(-1, lf_w, 3), counts)
    return _compose(lf_img, hf_img, h, w)


def wavelet_siren_apply_members_split(params, grid: torch.Tensor, cfg: WaveletSirenConfig,
                                      precision: str, part: int, parts: int,
                                      gather) -> torch.Tensor:
    """wavelet_siren_apply_split over a member axis (params whose leaves
    carry one) -> (M, H, W, 3): the member-axis kernels on the share, the
    gather on dim 1 (`gather(t, counts, 1)`), then wavelet_siren_apply_members'
    composition."""
    h, w = grid.shape[:2]
    assert (h, w) == (cfg.height, cfg.width), (
        f"grid {h}x{w} != configured {cfg.height}x{cfg.width}"
    )
    lf_h, lf_w = cfg.lf_shape
    counts = [lattice_share(lf_h, r, parts).stop - lattice_share(lf_h, r, parts).start
              for r in range(parts)]
    coords = _share_coords(cfg, part, parts, grid.device)
    lf = siren_apply_flat_members(params[: cfg.n_lf_layers], coords, cfg.lf_config, precision)
    hf = siren_apply_flat_members(params[cfg.n_lf_layers :], coords, cfg.hf_config, precision)
    m = lf.shape[0]
    lf_img = gather(lf.reshape(m, -1, lf_w, cfg.output_size), counts, 1)
    hf_img = gather(hf.reshape(m, -1, lf_w, 3), counts, 1)
    return torch.func.vmap(lambda a, b: _compose(a, b, h, w))(lf_img, hf_img)
