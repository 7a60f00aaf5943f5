"""The weight container and the decoder (counterpart of
implicit_image_tpu/coding/__init__.py).

The container is the contract between the two packages: the same state dict
gives the same `compressed_weights.data` and `meta_data.json` bytes in
both, and each package reads the other's. The byte layout is the JAX
package's default, format 3: the plane-k bytes (k-th byte of every
element) of every tensor before any plane-(k+1) bytes.

Only format 3 and the `plain` stream (raw bytes) are ported; formats 1, 2
and 4 (progressive), delta containers and the entropy backends (zstd, lzma,
huffman, range, rans, auto) raise NotImplementedError. `decode_and_render` renders the decoded
params through the fused SIREN chain (the CUDA kernel on the card) in fp32.
"""
from __future__ import annotations

import json
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch

from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.training.fit import synchronize

__all__ = [
    "linear_state_dict",
    "compress_state_dict",
    "decompress_state_dict",
    "read_raw_container",
    "params_from_state_dict",
    "decode_and_render",
]

_PORTED_STREAMS = ("plain",)


def _check_stream(name: str) -> None:
    if name not in _PORTED_STREAMS:
        raise NotImplementedError(
            f"stream backend {name!r} is not ported yet (ROADMAP.md); "
            "use entropy_coding=plain"
        )


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def linear_state_dict(params, codebooks=None, half: Union[bool, str] = True
                      ) -> "OrderedDict[str, np.ndarray]":
    """Flatten params to an ordered name -> array dict (layer by layer, keys
    sorted):
    `layers.{i}.weight` / `.bias`, or `.labeled_weight` (uint8 when the
    labels fit, else uint16) + `.centroids` for quantized layers.

    `half`: True — every float fp16 (the reference protocol); "auto" —
    unquantized tensors fp32, centroids fp16; False — every float fp32."""
    fdtype = np.float16 if half is True else np.float32
    cdtype = np.float32 if half is False else np.float16
    state: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for i, layer in enumerate(params):
        book = codebooks[i] if codebooks is not None else None
        # keys in sorted order ("b" before "w"), the order in which the JAX
        # package's pytree flattening hands them over, so both packages lay
        # out the same container
        for key in sorted(layer):
            arr = _to_numpy(layer[key])
            if key == "w" and book is not None:
                labels = _to_numpy(book.labels)
                dtype = np.uint8 if labels.max(initial=0) < 256 else np.uint16
                state[f"layers.{i}.labeled_weight"] = labels.astype(dtype)
                state[f"layers.{i}.centroids"] = _to_numpy(book.centroids).astype(cdtype)
            elif key == "w":
                state[f"layers.{i}.weight"] = arr.astype(fdtype)
            elif key == "b":
                state[f"layers.{i}.bias"] = arr.astype(fdtype)
            else:
                state[f"layers.{i}.{key}"] = arr.astype(fdtype)
    return state


def _tensor_planes(arr: np.ndarray) -> list:
    """Byte planes of one tensor (plane k = k-th byte of every element)."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    if flat.size == 0:
        return [b""]
    if flat.dtype.itemsize == 1:
        return [flat.tobytes()]
    mat = flat.view(np.uint8).reshape(-1, flat.dtype.itemsize).T
    return [np.ascontiguousarray(row).tobytes() for row in mat]


def _unshuffle_tensor_bytes(buf: bytes, dtype: np.dtype, size: int) -> np.ndarray:
    if dtype.itemsize == 1 or size == 0:
        return np.frombuffer(buf, dtype=dtype, count=size)
    planes = np.frombuffer(buf, dtype=np.uint8, count=size * dtype.itemsize)
    return planes.reshape(dtype.itemsize, size).T.copy().view(dtype).reshape(size)


def _plane_group_payload(arrays) -> bytes:
    """Format 3: the plane-k bytes of every tensor before any plane-(k+1)."""
    all_planes = [_tensor_planes(a) for a in arrays]
    max_planes = max((len(p) for p in all_planes), default=1)
    return b"".join(
        b"".join(p[k] for p in all_planes if len(p) > k) for k in range(max_planes)
    )


def _plane_ungroup(dec: bytes, infos) -> Dict[str, np.ndarray]:
    """Inverse of _plane_group_payload; infos = (name, dtype, shape) triples."""
    sizes = [int(np.prod(shape, dtype=np.int64)) if shape else 1 for _, _, shape in infos]
    itemsizes = [np.dtype(dt).itemsize for _, dt, _ in infos]
    max_planes = max(itemsizes, default=1)
    planes: Dict[int, list] = {i: [] for i in range(len(infos))}
    offset = 0
    for k in range(max_planes):
        for i, (sz, isz) in enumerate(zip(sizes, itemsizes)):
            if isz > k and sz > 0:
                planes[i].append(dec[offset : offset + sz])
                offset += sz
    out: Dict[str, np.ndarray] = {}
    for i, (name, dt, shape) in enumerate(infos):
        dtype = np.dtype(dt)
        if sizes[i] == 0:
            out[name] = np.zeros(shape, dtype)
            continue
        arr = _unshuffle_tensor_bytes(b"".join(planes[i]), dtype, sizes[i])
        out[name] = arr.reshape(shape)
    return out


def compress_state_dict(
    state_dict: Dict[str, np.ndarray],
    dir_name: Union[str, Path],
    stream_name: str = "plain",
) -> int:
    """Write a format-3 container (compressed_weights.data + meta_data.json);
    return the payload bytes."""
    _check_stream(stream_name)
    dir_name = Path(dir_name)
    dir_name.mkdir(exist_ok=True, parents=True)
    binary_file = dir_name / "compressed_weights.data"

    meta = OrderedDict()
    arrays = []
    for order, (name, arr) in enumerate(state_dict.items()):
        arr = np.ascontiguousarray(arr)
        arrays.append(arr)
        meta[str(order)] = {"shape": list(arr.shape), "dtype": str(arr.dtype), "name": name}
    meta["__meta__"] = {"format": 3, "shuffle": True, "plane_group": True}
    binary_file.write_bytes(_plane_group_payload(arrays))
    (dir_name / "meta_data.json").write_text(json.dumps(meta, indent=2, sort_keys=True))
    return binary_file.stat().st_size


def read_raw_container(dir_name: Union[str, Path], stream_name: str = "plain"
                       ) -> "OrderedDict[str, np.ndarray]":
    """Read a container back to the STORED per-tensor arrays."""
    _check_stream(stream_name)
    dir_name = Path(dir_name)
    meta = json.loads((dir_name / "meta_data.json").read_text())
    fmt = meta.pop("__meta__", {"format": 1})
    if int(fmt.get("format", 1)) != 3 or "delta" in fmt:
        raise NotImplementedError(
            f"container format {fmt} is not ported yet; the port reads format 3"
        )
    meta = {int(k): v for k, v in meta.items()}
    infos = [(meta[o]["name"], meta[o]["dtype"], meta[o]["shape"]) for o in sorted(meta)]
    expected = sum(
        (int(np.prod(shape, dtype=np.int64)) if shape else 1) * np.dtype(dt).itemsize
        for _, dt, shape in infos
    )
    blob = (dir_name / "compressed_weights.data").read_bytes()
    if len(blob) != expected:
        raise ValueError(
            f"corrupt plain stream: {len(blob)} bytes, container manifest expects {expected}"
        )
    grouped = _plane_ungroup(blob, infos)
    return OrderedDict((name, grouped[name]) for name, _, _ in infos)


def decompress_state_dict(dir_name: Union[str, Path], stream_name: str = "plain"
                          ) -> Dict[str, np.ndarray]:
    """Read the container; re-materialize weight = centroids[labels].
    Returns float32 arrays keyed by `layers.{i}.weight` etc."""
    raw = read_raw_container(dir_name, stream_name)
    out: Dict[str, np.ndarray] = {}
    for name, arr in raw.items():
        if "centroids" in name:
            continue
        if "qscale" in name:
            raise NotImplementedError("per-channel QAT containers are not ported yet")
        if "labeled_weight" in name:
            centroids = raw[name.replace("labeled_weight", "centroids")]
            out[name.replace("labeled_weight", "weight")] = centroids[arr].astype(np.float32)
        else:
            out[name] = np.asarray(arr, dtype=np.float32)
    return out


def params_from_state_dict(state_dict: Dict[str, np.ndarray], device="cpu"
                           ) -> Tuple[dict, ...]:
    """Rebuild the params tuple (torch tensors on `device`)."""
    layers: Dict[int, dict] = {}
    for name, arr in state_dict.items():
        _, idx, key = name.split(".", 2)
        key = {"weight": "w", "bias": "b"}.get(key, key)
        layers.setdefault(int(idx), {})[key] = torch.as_tensor(np.array(arr)).to(device)
    return tuple(layers[i] for i in sorted(layers))


def decode_and_render(dir_name: Union[str, Path], stream_name: str, mdef, mcfg,
                      height: int, width: int, device="cuda", precision: str = "fp32"):
    """Full decoder: container -> params -> rendered (H, W, 3) numpy image.
    Returns (image, stats) with host decode, upload and render seconds."""
    t0 = time.perf_counter()
    state = decompress_state_dict(dir_name, stream_name)
    t1 = time.perf_counter()
    params = params_from_state_dict(state, device)
    synchronize(device)
    t2 = time.perf_counter()
    with torch.no_grad():
        img = mdef.apply(params, get_grid(height, width, device), mcfg, precision)
        img = img.cpu().numpy()
    t3 = time.perf_counter()
    return img, {"decode_s": t1 - t0, "upload_s": t2 - t1, "render_s": t3 - t2}
