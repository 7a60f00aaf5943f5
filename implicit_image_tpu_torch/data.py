"""Image ingestion and coordinate grids.

Counterpart of implicit_image_tpu/data.py. Ingestion is host-side numpy and
re-implemented here line for line (the JAX module imports jax at module
level), so `synthetic_image`, `stable_seed` and `load_img` give the same
arrays in both packages. `get_grid` builds the grid as a torch tensor on an
explicit device with the same float32 values as `jnp.linspace`.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

__all__ = [
    "load_img",
    "get_grid",
    "get_grid_window",
    "unit_linspace",
    "synthetic_image",
    "synthetic_video",
    "stable_seed",
    "save_img",
    "resolve_benchmark_path",
]


def resolve_benchmark_path(path: Optional[str]) -> Optional[str]:
    """Resolve a configured image path against the benchmark drop-in dirs:
    the path itself, then under `data/`, then its basename under `data/`
    and `data/rgb16bit/` — CWD-relative first, then repo-anchored.
    Returns the first existing path, else None."""
    if not path:
        return None
    base = os.path.basename(path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rels = (path, os.path.join("data", path), os.path.join("data", base),
            os.path.join("data", "rgb16bit", base))
    for cand in rels + tuple(os.path.join(repo, r) for r in rels[1:]):
        if os.path.exists(cand):
            return cand
    return None


def _read_image(path: str) -> np.ndarray:
    """Read an image file to an RGB numpy array at its native bit depth
    (OpenCV when installed, else the binary-P6 PPM reader)."""
    try:
        import cv2
    except ImportError:
        return _read_ppm(path)
    img = cv2.imread(path, -1)
    if img is None:
        raise FileNotFoundError(f"Could not read image at {path}")
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[:, :, ::-1]  # BGR -> RGB


def _read_ppm(path: str) -> np.ndarray:
    """Minimal binary P6 PPM reader (8- or 16-bit big-endian)."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        start = i
        while i < len(data) and not data[i : i + 1].isspace():
            i += 1
        tokens.append(data[start:i])
    i += 1  # single whitespace after maxval
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic != b"P6":
        raise ValueError(f"Unsupported PPM magic {magic!r}")
    dtype = np.dtype(">u2") if maxval > 255 else np.uint8
    arr = np.frombuffer(data, dtype=dtype, count=w * h * 3, offset=i)
    return arr.reshape(h, w, 3).astype(np.uint16 if maxval > 255 else np.uint8)


def stable_seed(name: str) -> int:
    """Deterministic 31-bit seed from a name (built-in hash() is salted per
    process)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little") % (
        2**31
    )


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize with half-pixel centers (align_corners=False)."""
    try:
        import cv2
    except ImportError:
        t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
        out = torch.nn.functional.interpolate(
            t, size=(out_h, out_w), mode="bilinear", align_corners=False
        )
        return out[0].permute(1, 2, 0).numpy()
    return cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)


def _center_crop(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """kornia.center_crop-faithful crop: an odd size difference samples at
    half-pixel offsets, i.e. the 0.5/0.5 average of two neighbours."""
    h, w = img.shape[:2]
    start_y = max((h - out_h) / 2.0, 0.0)
    start_x = max((w - out_w) / 2.0, 0.0)
    iy, ix = int(start_y), int(start_x)
    fy, fx = start_y - iy, start_x - ix
    if fy == 0.0 and fx == 0.0:
        return img[iy : iy + out_h, ix : ix + out_w]
    out = img
    if fy > 0.0:
        hi = np.minimum(np.arange(iy, iy + out_h) + 1, h - 1)
        out = (1.0 - fy) * out[iy : iy + out_h] + fy * out[hi]
    else:
        out = out[iy : iy + out_h]
    if fx > 0.0:
        hi = np.minimum(np.arange(ix, ix + out_w) + 1, w - 1)
        out = (1.0 - fx) * out[:, ix : ix + out_w] + fx * out[:, hi]
    else:
        out = out[:, ix : ix + out_w]
    return out.astype(img.dtype, copy=False)


def load_img(
    path: str,
    height: int = 256,
    width: int = 256,
    bits: int = 8,
    crop_mode: str = "centre-crop",
    save_gt: bool = False,
    **kwargs,
) -> np.ndarray:
    """Load an image normalized to [0, 1] float32, shaped (H, W, 3): read at
    native bit depth, divide by 2^bits - 1, optionally resize the smaller
    side ('resize-crop', long side truncated), then centre-crop."""
    img = _read_image(path).astype(np.float32) / float(2**bits - 1)
    if crop_mode == "resize-crop":
        smaller_side = min(height, width)
        h, w = img.shape[:2]
        if not ((w <= h and w == smaller_side) or (h <= w and h == smaller_side)):
            if w < h:
                new_w = smaller_side
                new_h = int(smaller_side * h / w)
            else:
                new_h = smaller_side
                new_w = int(smaller_side * w / h)
            img = _resize_bilinear(img, new_h, new_w)
    img = _center_crop(img, height, width)
    if save_gt:
        save_img("gt.png", img)
    return np.ascontiguousarray(img, dtype=np.float32)


def save_img(path: str, img: np.ndarray) -> None:
    """Save a [0,1] float image as 8-bit."""
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        from PIL import Image

        Image.fromarray(arr).save(path)
        return
    cv2.imwrite(path, arr[:, :, ::-1])


def unit_linspace(n: int, device="cpu", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """linspace(0, 1, n) with jnp.linspace's arithmetic as XLA runs it: iota
    times the reciprocal of n - 1 (rounded to `dtype`), endpoint exactly 1."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    inv = float(np_dtype(1.0) / np_dtype(n - 1))
    step = torch.arange(n - 1, dtype=dtype, device=device) * inv
    return torch.cat([step, torch.ones(1, dtype=dtype, device=device)])


def get_grid(height: int, width: int, device="cpu") -> torch.Tensor:
    """Unit-square pixel-coordinate grid, shape (H, W, 2); channel 0 is the
    row coordinate, channel 1 the column ('ij' indexing)."""
    ch = unit_linspace(height, device)
    cw = unit_linspace(width, device)
    gh = ch[:, None].expand(height, width)
    gw = cw[None, :].expand(height, width)
    return torch.stack([gh, gw], dim=-1)


def get_grid_window(height: int, width: int, row0: int, row1: int, col0: int, col1: int,
                    device="cpu") -> torch.Tensor:
    """The grid of the window [row0, row1) x [col0, col1) of the H x W lattice:
    bit-identical to `get_grid(height, width)[row0:row1, col0:col1]` without
    building the full grid, and still a tensor product (separable models keep
    their grid path on windows)."""
    if not (0 <= row0 < row1 <= height and 0 <= col0 < col1 <= width):
        raise ValueError(f"window [{row0},{row1})x[{col0},{col1}) out of bounds for "
                         f"{height}x{width}")
    ch = unit_linspace(height, device)[row0:row1]
    cw = unit_linspace(width, device)[col0:col1]
    hh, ww = row1 - row0, col1 - col0
    return torch.stack([ch[:, None].expand(hh, ww), cw[None, :].expand(hh, ww)], dim=-1)


def synthetic_image(
    height: int = 512, width: int = 512, seed: int = 0, complexity: int = 6
) -> np.ndarray:
    """Deterministic multi-frequency synthetic test image in [0,1], (H,W,3);
    bit-identical to implicit_image_tpu.data.synthetic_image."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(0, 1, height, dtype=np.float32)[:, None]
    xs = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    img = np.zeros((height, width, 3), dtype=np.float32)
    for c in range(3):
        acc = np.zeros((height, width), dtype=np.float32)
        for k in range(1, complexity + 1):
            fy, fx = rng.uniform(0.5, 3.0 * k, size=2)
            py, px = rng.uniform(0, 2 * np.pi, size=2)
            amp = 1.0 / k
            acc += amp * np.sin(2 * np.pi * fy * ys + py) * np.cos(
                2 * np.pi * fx * xs + px
            )
        img[:, :, c] = acc
    img -= img.min()
    img /= img.max() + 1e-12
    return img


def synthetic_video(
    height: int = 256,
    width: int = 256,
    frames: int = 8,
    seed: int = 0,
    complexity: int = 6,
    motion: float = 0.01,
) -> np.ndarray:
    """Deterministic temporally coherent synthetic sequence, (T, H, W, 3) in
    [0, 1]; bit-identical to implicit_image_tpu.data.synthetic_video.

    synthetic_image's multi-frequency field, drawn in the same order,
    translated by a constant per-channel phase velocity (`motion`: the
    per-frame shift as a fraction of the extent, with wrap-around) under a
    slow amplitude drift. Normalised jointly over the whole sequence (per
    frame it would flicker)."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(0, 1, height, dtype=np.float32)[:, None]
    xs = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    vid = np.zeros((frames, height, width, 3), dtype=np.float32)
    for c in range(3):
        terms = []
        for k in range(1, complexity + 1):
            fy, fx = rng.uniform(0.5, 3.0 * k, size=2)
            py, px = rng.uniform(0, 2 * np.pi, size=2)
            terms.append((fy, fx, py, px, 1.0 / k))
        vy, vx = rng.uniform(-1.0, 1.0, size=2) * motion
        drift = rng.uniform(0, 2 * np.pi)
        for t in range(frames):
            acc = np.zeros((height, width), dtype=np.float32)
            gain = 1.0 + 0.05 * np.sin(0.4 * t + drift)
            for fy, fx, py, px, amp in terms:
                acc += (amp * gain) * np.sin(
                    2 * np.pi * fy * (ys + vy * t) + py
                ) * np.cos(2 * np.pi * fx * (xs + vx * t) + px)
            vid[t, :, :, c] = acc
    vid -= vid.min()
    vid /= vid.max() + 1e-12
    return vid
