"""Programmatic API (counterpart of implicit_image_tpu/api.py): the CLIs'
pipelines in process, for library users.

    import implicit_image_tpu_torch as iit

    result = iit.compress_image(img_array, overrides=[
        "quant=kmeans", "entropy_coding=auto", "train.num_steps=2000",
    ])
    result.psnr, result.nbytes      # the (PSNR, bytes) the CLI reports
    decoded = result.decode()       # (H, W, 3) float32 via the bitstream
    big = result.decode(scale=2.0)  # the INR renders at any lattice

Every option is a dotted config override of the compress CLI; there is no
second options schema. The functions run on the card (`device="cuda"`:
RuntimeError without one; "cpu" runs the plain versions); a `device=`
override wins over the argument, as an `output_dir=` override wins over
`out_dir`.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

__all__ = ["CompressedImage", "compress_image", "compress_images", "decompress_image"]


@dataclasses.dataclass(frozen=True)
class CompressedImage:
    """Result of `compress_image`: a compress run dir (config.json,
    model_quantized/ bitstream, summary.json) and the (PSNR, bytes) pair
    the CLI returns; `device` is where `decode` renders by default."""

    psnr: float
    nbytes: int
    run_dir: Path
    device: str = "cuda"

    def decode(self, **kwargs) -> np.ndarray:
        """Decode the bitstream back to an image. Takes decode_run's geometry
        options (scale=, size=, roi=, tile_rows=, base=) and device=."""
        kwargs.setdefault("device", self.device)
        return decompress_image(self.run_dir, **kwargs)

    @property
    def bitstream(self) -> bytes:
        return (self.run_dir / "model_quantized" / "compressed_weights.data").read_bytes()

    def save(self, path: Union[str, Path, None] = None) -> Path:
        """Pack the run dir into one .iic file (coding/container_file.py);
        decompress_image and the decompress CLI decode it directly."""
        from implicit_image_tpu_torch.coding.container_file import pack_run

        return pack_run(self.run_dir, path)


def _validate_array(image) -> np.ndarray:
    arr = np.asarray(image, np.float32)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) image array, got shape {arr.shape}")
    if not np.isfinite(arr).all():
        raise ValueError("image contains NaN/inf values")
    if float(arr.min()) < 0.0 or float(arr.max()) > 1.0:
        raise ValueError(f"image values must be in [0, 1] (got [{arr.min():.3g}, {arr.max():.3g}])")
    return arr


def _unique_run_dir(base: Path, stem: str = "run") -> Path:
    """The first free base/stem[_k]: successive calls must not overwrite
    each other's artifacts while earlier results still point at them."""
    d = base / stem
    k = 0
    while d.exists():
        k += 1
        d = base / f"{stem}_{k}"
    return d


def _compose(overrides, seed: int, device: str, what: str):
    """The composed config of an API call: seed, the overrides, and `device`
    unless an override names one. Raises ValueError for a config without a
    stream (no decode path)."""
    from implicit_image_tpu_torch.config import compose

    ov = [f"seed={int(seed)}", *map(str, overrides)]
    cfg = compose(ov)
    if not any(o.startswith("device=") for o in ov):
        cfg["device"] = str(device)
    if cfg.get("entropy_coding", {}).get("stream_name", "none") == "none":
        raise ValueError(f"{what} produces a decodable bitstream; entropy_coding=none has no "
                         "decode path: pick a backend (e.g. 'entropy_coding=auto' in overrides)")
    return cfg


def compress_image(
    image: Union[np.ndarray, str, Path],
    overrides: Sequence[str] = (),
    out_dir: Union[str, Path, None] = None,
    seed: int = 0,
    device: str = "cuda",
) -> CompressedImage:
    """Compress one image through the full pipeline (fit, sparsify,
    quantize, entropy-code) with compress.main, in process.

    image: an (H, W, 3) float array in [0, 1], or an image file path (read
        by the compress loader: img.height / img.width overrides resize and
        crop it as in the CLI).
    overrides: dotted config overrides, as the compress CLI takes them.
    out_dir: the run dir; default the first free outputs/api/run[_k] (an
        `output_dir=` override wins over it).
    """
    from implicit_image_tpu_torch.compress import main

    arr = None if isinstance(image, (str, Path)) else _validate_array(image)
    cfg = _compose(overrides, seed, device, "compress_image")
    if arr is None:
        # set directly: an img.path override would go through YAML value
        # parsing, which mangles paths holding '#', ',' or scalar-like names
        cfg["img"]["path"] = str(image)
    else:
        # config.json sets the decoder's lattice: it must be the array's
        cfg["img"]["height"] = int(arr.shape[0])
        cfg["img"]["width"] = int(arr.shape[1])
    if any(str(o).startswith("output_dir=") for o in overrides):
        run_dir = Path(str(cfg["output_dir"]))
    elif out_dir is not None:
        run_dir = Path(str(out_dir))
    else:
        run_dir = _unique_run_dir(Path("outputs/api"))
    cfg["output_dir"] = str(run_dir)
    psnr, nbytes = main(cfg, run_dir=str(run_dir), image=arr)
    return CompressedImage(psnr=float(psnr), nbytes=int(nbytes), run_dir=run_dir,
                           device=str(cfg["device"]))


def compress_images(
    images: Sequence[np.ndarray],
    overrides: Sequence[str] = (),
    out_dir: Union[str, Path, None] = None,
    seed: int = 0,
    names: Optional[Sequence[str]] = None,
    device: str = "cuda",
) -> list:
    """Compress B same-shape images together: one fit over the member axis
    (fleet.encode_fleet), then each member's finetune, container and
    decode. Returns one CompressedImage per input, each a run dir under
    out_dir (default the first free outputs/api/fleet[_k])."""
    from implicit_image_tpu_torch.fleet import encode_fleet

    arrs = [_validate_array(im) for im in images]
    if not arrs:
        raise ValueError("compress_images needs at least one image")
    if len({a.shape for a in arrs}) != 1:
        raise ValueError("all images must share one shape (the fleet is one fit over a member "
                         "axis); got " + ", ".join(str(a.shape) for a in arrs))
    names = [str(n) for n in names] if names is not None else [f"img{i}" for i in range(len(arrs))]
    if len(names) != len(arrs):
        raise ValueError(f"{len(names)} names for {len(arrs)} images")
    if len(set(names)) != len(names):
        raise ValueError("member names must be unique (they become dirs)")
    cfg = _compose(overrides, seed, device, "compress_images")
    h, w = arrs[0].shape[:2]
    cfg["img"]["height"], cfg["img"]["width"] = int(h), int(w)
    root = Path(str(out_dir)) if out_dir is not None else _unique_run_dir(Path("outputs/api"),
                                                                          "fleet")
    member_cfgs = []
    for name in names:
        m = dict(cfg)
        m["img"] = dict(cfg["img"]) | {"name": name, "path": None}
        member_cfgs.append(m)
    rows = encode_fleet(cfg, arrs, names, member_cfgs, root=root)
    return [CompressedImage(psnr=float(p), nbytes=int(b), run_dir=root / n,
                            device=str(cfg["device"])) for n, p, b in rows]


def decompress_image(run_dir: Union[str, Path], device: str = "cuda", **kwargs) -> np.ndarray:
    """Decode a run dir's (or a packed .iic file's) bitstream to an (H, W, 3)
    float32 array on `device`. kwargs pass to decompress.decode_run: scale=,
    size=(H, W), roi=(r0, r1, c0, c1), tile_rows=, base= (the progressive
    prefix), delta_artifact= (a relocated shared artifact)."""
    from implicit_image_tpu_torch.decompress import decode_run
    from implicit_image_tpu_torch.ops.cuda_build import open_device

    img, _ = decode_run(run_dir, device=open_device(device), **kwargs)
    return np.asarray(img, np.float32)
