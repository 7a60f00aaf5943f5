"""The weight container and the decoder (counterpart of
implicit_image_tpu/coding/__init__.py).

The container is the contract between the two packages: the same state dict
and stream give the same `compressed_weights.data` and `meta_data.json`
bytes in both, and each package reads the other's. Byte layouts:

  * format 3 (the default): the plane-k bytes (k-th byte of every element)
    of every tensor before any plane-(k+1) bytes;
  * format 2 (`plane_group=False`): each tensor's bytes split into planes;
  * format 1 (`shuffle=False`): the tensors' bytes as they lie, no
    `__meta__` entry (readable by the original torch code).

The payload goes through one stream backend (coding/parsers.py: plain,
zstd, lzma, huffman, range, rans, auto).

Delta containers (quant.delta) record a shared artifact, the meta-init
.npz the fit started from, by path and sha256: the quantized layers hold
residual codebooks, decoded as w = (offset + centroids[labels]) *
(labels != 0), and the unquantized tensors named under `xor` hold the
bit-pattern XOR against the artifact (`apply_xor_residual`, lossless).

Format 4, the progressive container (coding/progressive.py): a base
prefix that decodes on its own (`base_only=True`) and a refinement after
it; read_raw_container hands either back under the flat names.

QAT's per-channel layers (quant.qscheme=per_channel) store int8 codes as
`labeled_weight` and the per-output-channel scales as `qscale` (in the
centroids' dtype); they decode to codes * scales[None, :]. Per-tensor QAT
layers are labels + a 2^b-entry codebook like k-means'.

Inter-frame delta containers (sequence.py's P-frames) record `prev`, the
previous frame's container dir relative to this one, its payload's sha256
and its stream, in place of an artifact: the offsets are the previous
frame's decoded weights, and the XOR residuals are against its decoded
state. A P-frame decodes on its own by walking its verified chain back to
the I-frame (`_resolve_prev_offsets`), or from the state just decoded
(`prev_state`, the sequence decoder's O(T) walk).
`decode_and_render` renders the decoded params through the model registry
(the fused SIREN chain, the CUDA kernel on the card, for SIREN) in fp32;
`render_region` renders any H x W lattice, a window of it, or row bands of
it one launch after another.
"""
from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from implicit_image_tpu_torch.coding.parsers import backend_names, decode_stream, encode_stream
from implicit_image_tpu_torch.data import get_grid, get_grid_window
from implicit_image_tpu_torch.training.fit import synchronize

__all__ = [
    "linear_state_dict",
    "state_ref_map",
    "apply_xor_residual",
    "delta_meta_entry",
    "compress_state_dict",
    "decompress_state_dict",
    "read_raw_container",
    "params_from_state_dict",
    "decode_and_render",
    "render_region",
    "backend_names",
]


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def linear_state_dict(params, codebooks=None, half: Union[bool, str] = True
                      ) -> "OrderedDict[str, np.ndarray]":
    """Flatten params to an ordered name -> array dict (layer by layer, keys
    sorted):
    `layers.{i}.weight` / `.bias`, or `.labeled_weight` (uint8 when the
    labels fit, else uint16) + `.centroids` for quantized layers, or for a
    PerChannelCodebook (QAT per channel) `.labeled_weight` as int8 codes +
    `.qscale`, its scales.

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
            if key == "w" and book is not None and hasattr(book, "scales"):
                state[f"layers.{i}.labeled_weight"] = _to_numpy(book.codes).astype(np.int8)
                state[f"layers.{i}.qscale"] = _to_numpy(book.scales).astype(cdtype)
            elif key == "w" and book is not None:
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


def state_ref_map(params) -> Dict[str, np.ndarray]:
    """A params tuple (tensors or arrays) -> {state name: fp32 array}, the
    naming of linear_state_dict without quantization: the encoder's
    reference map for the XOR residuals of a delta container."""
    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(params):
        for key, val in layer.items():
            name = {"w": "weight", "b": "bias"}.get(key, key)
            out[f"layers.{i}.{name}"] = np.asarray(_to_numpy(val), np.float32)
    return out


def _xor_arrays(arr: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Bitwise XOR of two same-shape float arrays in arr's dtype (its own
    inverse)."""
    u = {2: np.uint16, 4: np.uint32, 8: np.uint64}[arr.dtype.itemsize]
    a = np.ascontiguousarray(arr)
    r = np.ascontiguousarray(ref.astype(arr.dtype))
    return (a.view(u) ^ r.view(u)).view(arr.dtype)


def apply_xor_residual(state, ref_map) -> Tuple["OrderedDict[str, np.ndarray]", list]:
    """Lossless delta transform of the unquantized tensors: each float
    tensor with a same-shape reference is stored as its bit-pattern XOR
    against it. Near-identical floats share their high bits, so the XOR is
    mostly zero bytes. Quantized layers (labeled_weight, centroids) have no
    reference entry and stay as they are. Returns (state, XORed names)."""
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    xored = []
    for name, arr in state.items():
        ref = ref_map.get(name)
        if ref is not None and arr.dtype.kind == "f" and tuple(np.shape(ref)) == tuple(arr.shape):
            out[name] = _xor_arrays(arr, np.asarray(ref))
            xored.append(name)
        else:
            out[name] = arr
    return out, xored


def delta_meta_entry(delta: Dict[str, Any], stream_name: str) -> Dict[str, Any]:
    """The manifest's __meta__.delta entry for a `delta` argument
    {"artifact", "sha256", "layers"[, "xor"]}, or for an inter-frame one
    {"prev", "sha256", "layers"[, "xor", "stream"]}: `prev` is the previous
    frame's container dir relative to this one, `sha256` its
    compressed_weights.data's, `stream` its backend (default: this one's)."""
    entry = {"sha256": str(delta["sha256"]), "layers": [int(i) for i in delta["layers"]]}
    if delta.get("xor"):
        entry["xor"] = [str(n) for n in delta["xor"]]
    if "prev" in delta:
        entry["prev"] = str(delta["prev"])
        entry["stream"] = str(delta.get("stream", stream_name))
    else:
        entry["artifact"] = str(delta["artifact"])
    return entry


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
    shuffle: bool = True,
    plane_group: bool = True,
    delta: Optional[Dict[str, Any]] = None,
    level: int = 22,
) -> int:
    """Write compressed_weights.data + meta_data.json; return the payload
    bytes. Format 3 by default, 2 with plane_group=False, 1 with
    shuffle=False. `delta` records the shared artifact of a delta container
    (delta_meta_entry)."""
    dir_name = Path(dir_name)
    dir_name.mkdir(exist_ok=True, parents=True)
    binary_file = dir_name / "compressed_weights.data"

    meta = OrderedDict()
    arrays = []
    for order, (name, arr) in enumerate(state_dict.items()):
        arr = np.ascontiguousarray(arr)
        arrays.append(arr)
        meta[str(order)] = {"shape": list(arr.shape), "dtype": str(arr.dtype), "name": name}
    if shuffle and plane_group:
        raw = _plane_group_payload(arrays)
        meta["__meta__"] = {"format": 3, "shuffle": True, "plane_group": True}
    elif shuffle:
        raw = b"".join(b"".join(_tensor_planes(a)) for a in arrays)
        meta["__meta__"] = {"format": 2, "shuffle": True}
    else:
        # format 1 writes no __meta__, so the original torch reader takes it
        raw = b"".join(a.tobytes() for a in arrays)
    if delta is not None:
        meta.setdefault("__meta__", {"format": 1, "shuffle": False})
        meta["__meta__"]["delta"] = delta_meta_entry(delta, stream_name)
    binary_file.write_bytes(encode_stream(stream_name, raw, level=level))
    (dir_name / "meta_data.json").write_text(json.dumps(meta, indent=2, sort_keys=True))
    return binary_file.stat().st_size


def read_raw_container(dir_name: Union[str, Path], stream_name: str = "plain",
                       base_only: bool = False) -> "OrderedDict[str, np.ndarray]":
    """Read a container back to the STORED per-tensor arrays (labels,
    centroids, fp16/fp32 tensors, XOR residuals as stored). A progressive
    (format-4) container comes back under the flat names, its base prefix
    alone with `base_only` (ignored by the other formats)."""
    dir_name = Path(dir_name)
    meta = json.loads((dir_name / "meta_data.json").read_text())
    fmt = meta.pop("__meta__", {"format": 1, "shuffle": False})
    if int(fmt.get("format", 1)) == 4:
        from implicit_image_tpu_torch.coding.progressive import read_progressive

        return read_progressive(dir_name, stream_name, base_only=base_only)
    shuffle = bool(fmt.get("shuffle", False))
    plane_group = bool(fmt.get("plane_group", False))
    meta = {int(k): v for k, v in meta.items()}
    infos = [(meta[o]["name"], meta[o]["dtype"], meta[o]["shape"]) for o in sorted(meta)]
    # the manifest pins the raw payload size: truncation or corruption raises
    expected = sum(
        (int(np.prod(shape, dtype=np.int64)) if shape else 1) * np.dtype(dt).itemsize
        for _, dt, shape in infos
    )
    try:
        dec = decode_stream(stream_name, (dir_name / "compressed_weights.data").read_bytes(),
                            expected_size=expected)
    except (ValueError, NotImplementedError, RuntimeError, OSError):
        raise  # corruption found by the backend, or a codec that cannot load
    except Exception as e:  # zlib.error, ZstdError, LZMAError, ...
        raise ValueError(f"corrupt container {dir_name} (backend {stream_name}): {e!r}") from e
    if plane_group:
        grouped = _plane_ungroup(dec, infos)
        return OrderedDict((name, grouped[name]) for name, _, _ in infos)
    raw: "OrderedDict[str, np.ndarray]" = OrderedDict()
    offset = 0
    for name, dt, shape in infos:
        dtype = np.dtype(dt)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = size * dtype.itemsize
        if shuffle:
            arr = _unshuffle_tensor_bytes(dec[offset : offset + nbytes], dtype, size)
        else:
            arr = np.frombuffer(dec, dtype=dtype, count=size, offset=offset)
        raw[name] = arr.reshape(shape)
        offset += nbytes
    return raw


def _resolve_delta_offsets(dir_name: Path, info: Dict[str, Any],
                           override: Optional[Union[str, Path]] = None
                           ) -> Dict[str, np.ndarray]:
    """Find and hash-check the shared delta artifact; returns its tensors
    under state names ({"layers.{i}.weight": fp32 array, ...}).

    Search order: `override`, the path recorded at encode time, that path
    under the repo root, the artifact's file name next to the container and
    next to the run dir, and the repo's assets/meta/. A sha256 that differs
    from the manifest's raises."""
    repo = Path(__file__).resolve().parents[2]
    rec = Path(info["artifact"])
    candidates = [Path(override)] if override is not None else []
    candidates += [rec, repo / rec, dir_name / rec.name, dir_name.parent / rec.name,
                   repo / "assets" / "meta" / rec.name]
    path = next((c for c in candidates if c.is_file()), None)
    if path is None:
        raise FileNotFoundError(
            f"delta artifact {info['artifact']!r} not found (searched "
            f"{[str(c) for c in candidates]}); pass delta_artifact=<path> "
            "or place the file in assets/meta/"
        )
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != info["sha256"]:
        raise ValueError(
            f"delta artifact {path} sha256 mismatch: stream was encoded "
            f"against {info['sha256'][:12]}…, file is {digest[:12]}…"
        )
    npz = np.load(path)
    out: Dict[str, np.ndarray] = {}
    for k in npz.files:
        if not k.startswith("params."):
            continue
        _, idx, key = k.split(".", 2)
        name = {"w": "weight", "b": "bias"}.get(key, key)
        out[f"layers.{int(idx)}.{name}"] = np.asarray(npz[k], np.float32)
    return out


def _resolve_prev_offsets(dir_name: Path, info: Dict[str, Any],
                          prev_state: Optional[Dict[str, np.ndarray]] = None
                          ) -> Dict[str, np.ndarray]:
    """The reference map of an inter-frame container: the previous frame's
    decoded state. Its container dir is `info["prev"]` relative to
    `dir_name`; a missing payload raises FileNotFoundError, a sha256 other
    than the manifest's ValueError. Without `prev_state` (the state the
    sequence decoder has just decoded for that frame) the previous frame is
    decoded here, walking the chain back to its I-frame."""
    prev_dir = (dir_name / info["prev"]).resolve()
    payload = prev_dir / "compressed_weights.data"
    if not payload.is_file():
        raise FileNotFoundError(
            f"inter-frame delta container {dir_name} references previous frame "
            f"{info['prev']!r} -> {prev_dir}, which has no compressed_weights.data; decode "
            "the sequence in place or through sequence.decode_sequence")
    digest = hashlib.sha256(payload.read_bytes()).hexdigest()
    if digest != info["sha256"]:
        raise ValueError(
            f"previous frame {prev_dir} sha256 mismatch: this stream was encoded against "
            f"{info['sha256'][:12]}…, file is {digest[:12]}… (broken sequence chain)")
    if prev_state is None:
        prev_state = decompress_state_dict(prev_dir, str(info.get("stream", "zstd")))
    return {k: np.asarray(v, np.float32) for k, v in prev_state.items()}


def decompress_state_dict(dir_name: Union[str, Path], stream_name: str = "plain",
                          delta_artifact: Optional[Union[str, Path]] = None,
                          base_only: bool = False,
                          prev_state: Optional[Dict[str, np.ndarray]] = None
                          ) -> Dict[str, np.ndarray]:
    """Read the container; re-materialize weight = centroids[labels] (codes
    * scales[None, :] where the layer has a `qscale`), and for a delta
    container w = (offset + centroids[labels]) * (labels != 0)
    and the XOR residuals undone (`delta_artifact` overrides where the
    artifact is looked for). An inter-frame container takes its offsets and
    XOR references from the previous frame's decoded state: `prev_state`
    when given, else the verified chain is walked (_resolve_prev_offsets).
    `base_only`: a progressive container's base prefix alone. Returns
    float32 arrays keyed by `layers.{i}.weight` etc."""
    dir_name = Path(dir_name)
    raw = read_raw_container(dir_name, stream_name, base_only=base_only)
    fmt = json.loads((dir_name / "meta_data.json").read_text()).get("__meta__", {})
    refs: Dict[str, np.ndarray] = {}
    delta_layers: set = set()
    if "delta" in fmt:
        if "prev" in fmt["delta"]:
            refs = _resolve_prev_offsets(dir_name, fmt["delta"], prev_state)
        else:
            refs = _resolve_delta_offsets(dir_name, fmt["delta"], delta_artifact)
        delta_layers = {int(i) for i in fmt["delta"]["layers"]}
        for name in fmt["delta"].get("xor", []):
            raw[name] = _xor_arrays(raw[name], refs[name])

    out: Dict[str, np.ndarray] = {}
    for name, arr in raw.items():
        if "centroids" in name or "qscale" in name:
            continue
        if "labeled_weight" in name:
            qscale_name = name.replace("labeled_weight", "qscale")
            if qscale_name in raw:  # QAT per channel: codes * scales
                scales = np.asarray(raw[qscale_name], np.float32)
                out[name.replace("labeled_weight", "weight")] = arr.astype(np.float32) * scales
                continue
            weight = raw[name.replace("labeled_weight", "centroids")][arr]
            layer_i = int(name.split(".", 2)[1])
            if layer_i in delta_layers:
                weight = (weight.astype(np.float32) + refs[f"layers.{layer_i}.weight"]) * (arr != 0)
            out[name.replace("labeled_weight", "weight")] = weight.astype(np.float32)
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
                      height: int, width: int, device="cuda", precision: str = "fp32",
                      delta_artifact: Optional[Union[str, Path]] = None,
                      base_only: bool = False):
    """Full decoder: container -> params -> rendered (H, W, 3) numpy image,
    through `mdef.apply` (the model registry's grid forward). Returns
    (image, stats) with host decode, upload and render seconds."""
    t0 = time.perf_counter()
    state = decompress_state_dict(dir_name, stream_name, delta_artifact, base_only=base_only)
    t1 = time.perf_counter()
    params = params_from_state_dict(state, device)
    synchronize(device)
    t2 = time.perf_counter()
    with torch.no_grad():
        img = mdef.apply(params, get_grid(height, width, device), mcfg, precision)
        img = img.cpu().numpy()
    t3 = time.perf_counter()
    return img, {"decode_s": t1 - t0, "upload_s": t2 - t1, "render_s": t3 - t2}


def render_region(mdef, mcfg, params, height: int, width: int,
                  roi: Optional[Tuple[int, int, int, int]] = None, tile_rows: int = 0,
                  precision: str = "fp32") -> np.ndarray:
    """Render decoded params (tensors on their device) on any H x W lattice,
    not only the fitted one; `roi = (row0, row1, col0, col1)` renders that
    window of it, and `tile_rows > 0` renders row bands of at most that many
    rows, one launch after another, stitched on the host (at most two bands'
    outputs on the device at once). On the kernels every row's result is
    independent of its place in a launch, so a window or a band equals the
    slice of the full render bit for bit. A full-grid model (wavelet-SIREN)
    renders its fitted lattice only and raises on any other grid."""
    r0, r1, c0, c1 = roi if roi is not None else (0, height, 0, width)
    if not (0 <= r0 < r1 <= height and 0 <= c0 < c1 <= width):
        raise ValueError(f"roi {roi} out of bounds for {height}x{width}")
    device = next(v for layer in params for v in layer.values()).device

    def render(y0, y1):
        with torch.no_grad():
            return mdef.apply(params, get_grid_window(height, width, y0, y1, c0, c1, device),
                              mcfg, precision)

    if tile_rows <= 0 or tile_rows >= r1 - r0:
        return render(r0, r1).cpu().numpy()
    bands, pending = [], []
    for y in range(r0, r1, tile_rows):
        if len(pending) == 2:
            bands.append(pending.pop(0).cpu().numpy())
        pending.append(render(y, min(y + tile_rows, r1)))
    bands.extend(b.cpu().numpy() for b in pending)
    return np.concatenate(bands, axis=0)
