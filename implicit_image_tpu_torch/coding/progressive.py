"""Progressive (quality-scalable) container, format 4 (counterpart of
implicit_image_tpu/coding/progressive.py): a prefix of the payload decodes
to a usable image, the whole payload to the flat container's weights, bit
for bit. Both packages write the same bytes for the same state dict and
read each other's containers.

Rank nesting: each per-tensor scalar codebook (uint8 labels, at most 256
centroids) is sorted, every weight relabelled by its centroid's rank, and
the 8-bit rank split into nibbles. The hi nibble (which of the 16 sorted
runs) with a 16-entry usage-weighted run-mean codebook is the base layer;
the lo nibble with the sorted codebook is the refinement. A full read
rebuilds rank = hi * 16 + lo against the sorted codebook: the flat
container's values, reordered.

The lo plane is stored grouped by its hi context (a stable sort by hi,
header flag `ctx_lo`), which the decoder inverts from the hi plane it has
already read; containers written without the flag decode unchanged.

Delta containers (quant.delta): label 0 of a quantized layer is the pruned
slot, so the permutation pins label 0 to rank 0 and sorts only labels 1..,
keeping the decoder's `labels != 0` test meaning "pruned" on ranks.

Layout: `compressed_weights.data` = base_blob || refine_blob, each its own
`encode_stream` payload (format 3's plane grouping inside); every tensor's
manifest entry carries its section (`sec`), and `__meta__.base_bytes` the
prefix length. Unquantized tensors live in the base section (every render
needs them), and so do quantized tensors that do not split (uint16 labels).
"""
from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Union

import numpy as np

from implicit_image_tpu_torch.coding import (
    _plane_group_payload,
    _plane_ungroup,
    delta_meta_entry,
)
from implicit_image_tpu_torch.coding.parsers import decode_stream, encode_stream

__all__ = ["compress_progressive", "read_progressive", "base_bytes"]

_RUN = 16  # ranks per base group (the hi nibble)


def _split_entries(state_dict, pinned_layers=frozenset()):
    """(base_entries, refine_entries), both ordered name -> array, with rank
    nesting applied to every flat uint8-label codebook tensor; on
    `pinned_layers` label 0 stays rank 0."""
    base: "OrderedDict[str, np.ndarray]" = OrderedDict()
    refine: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for name, arr in state_dict.items():
        if name.endswith(".labeled_weight"):
            book = state_dict.get(name.replace("labeled_weight", "centroids"))
            if book is not None and arr.dtype == np.uint8 and book.ndim == 1 and book.size <= 256:
                layer_i = int(name.split(".", 2)[1])
                if layer_i in pinned_layers and book.size > 1:
                    order = np.concatenate([[0], 1 + np.argsort(book[1:], kind="stable")])
                else:
                    order = np.argsort(book, kind="stable")
                rank_of = np.empty(book.size, np.uint8)
                rank_of[order] = np.arange(book.size, dtype=np.uint8)
                ranks = rank_of[arr]
                sorted_book = np.ascontiguousarray(book[order])
                counts = np.bincount(ranks.reshape(-1), minlength=book.size)
                n_groups = -(-book.size // _RUN)
                base_book = np.empty(n_groups, book.dtype)
                for g in range(n_groups):
                    lo, hi = g * _RUN, min((g + 1) * _RUN, book.size)
                    c = counts[lo:hi].astype(np.float64)
                    vals = sorted_book[lo:hi].astype(np.float64)
                    base_book[g] = (vals * c).sum() / c.sum() if c.sum() else vals.mean()
                stem = name[: -len(".labeled_weight")]
                hi = (ranks >> 4).astype(np.uint8)
                lo = (ranks & 15).astype(np.uint8)
                perm = np.argsort(hi.reshape(-1), kind="stable")  # ctx_lo: lo grouped by hi
                base[f"{stem}.labels_hi"] = hi
                base[f"{stem}.base_centroids"] = base_book
                refine[f"{stem}.labels_lo"] = lo.reshape(-1)[perm].reshape(lo.shape)
                refine[f"{stem}.centroids"] = sorted_book
                continue
        if name.endswith(".centroids") and f"{name[: -len('.centroids')]}.labels_lo" in refine:
            continue  # consumed by its labeled_weight above
        base[name] = arr
    return base, refine


def compress_progressive(state_dict: Dict[str, np.ndarray], dir_name: Union[str, Path],
                         stream_name: str = "auto", base_finetune=None, delta=None,
                         level: int = 22) -> int:
    """Write the format-4 container; returns the payload bytes (the rate, as
    compress_state_dict's).

    `base_finetune(base_entries) -> {name: array}` may replace
    `.base_centroids` entries (same shapes; stored in their dtype): the
    encoder's output-distortion finetune (quant/base_layer.py). The
    refinement never reads them, so the full stream is untouched. `delta`:
    compress_state_dict's argument; its layers' label 0 is pinned to rank 0."""
    dir_name = Path(dir_name)
    dir_name.mkdir(exist_ok=True, parents=True)
    base, refine = _split_entries(
        OrderedDict((k, np.ascontiguousarray(v)) for k, v in state_dict.items()),
        pinned_layers=frozenset(int(i) for i in delta["layers"]) if delta else frozenset())
    if base_finetune is not None:
        for name, book in (base_finetune(base) or {}).items():
            if not name.endswith(".base_centroids") or name not in base:
                raise ValueError(f"base_finetune may only replace .base_centroids entries, "
                                 f"got {name!r}")
            if np.asarray(book).shape != base[name].shape:
                raise ValueError(f"base_finetune changed the shape of {name}")
            base[name] = np.ascontiguousarray(np.asarray(book, base[name].dtype))
    meta = OrderedDict()
    order = 0
    for sec, entries in ((0, base), (1, refine)):
        for name, arr in entries.items():
            meta[str(order)] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                                "name": name, "sec": sec}
            order += 1
    base_blob = encode_stream(stream_name, _plane_group_payload(list(base.values())), level=level)
    refine_blob = encode_stream(stream_name, _plane_group_payload(list(refine.values())),
                                level=level)
    meta["__meta__"] = {"format": 4, "plane_group": True, "shuffle": True, "ctx_lo": True,
                        "base_bytes": len(base_blob)}
    if delta is not None:
        meta["__meta__"]["delta"] = delta_meta_entry(delta, stream_name)
    (dir_name / "compressed_weights.data").write_bytes(base_blob + refine_blob)
    (dir_name / "meta_data.json").write_text(json.dumps(meta, indent=2, sort_keys=True))
    return (dir_name / "compressed_weights.data").stat().st_size


def base_bytes(dir_name: Union[str, Path]) -> int:
    """Length of the prefix that decodes on its own at base quality."""
    meta = json.loads((Path(dir_name) / "meta_data.json").read_text())
    return int(meta["__meta__"]["base_bytes"])


def read_progressive(dir_name: Union[str, Path], stream_name: str = "auto",
                     base_only: bool = False) -> "OrderedDict[str, np.ndarray]":
    """Read a format-4 container back to stored arrays under the flat names
    (labeled_weight + centroids), so decompress_state_dict materializes them
    as it does a flat container.

    base_only=True reads only the first base_bytes of the payload (the file
    may be cut there): labels are the hi nibbles against the 16-entry
    run-mean codebooks. A full read merges the refinement: rank = hi * 16 +
    lo against the sorted codebook."""
    dir_name = Path(dir_name)
    meta = json.loads((dir_name / "meta_data.json").read_text())
    hdr = meta.pop("__meta__")
    if int(hdr.get("format", 1)) != 4:
        raise ValueError(f"{dir_name} is not a progressive (format-4) container")
    nbase = int(hdr["base_bytes"])
    meta = {int(k): v for k, v in meta.items()}
    infos_all = [(meta[o]["name"], meta[o]["dtype"], meta[o]["shape"], meta[o]["sec"])
                 for o in sorted(meta)]
    payload = (dir_name / "compressed_weights.data").read_bytes()
    if len(payload) < nbase:
        raise ValueError(f"payload truncated below the base layer ({len(payload)} < {nbase} "
                         "bytes)")

    def section(sec: int, blob: bytes):
        infos = [(n, d, s) for n, d, s, se in infos_all if se == sec]
        expected = sum((int(np.prod(s, dtype=np.int64)) if s else 1) * np.dtype(d).itemsize
                       for _, d, s in infos)
        try:
            dec = decode_stream(stream_name, blob, expected_size=expected)
        except (ValueError, NotImplementedError, RuntimeError, OSError):
            raise
        except Exception as e:  # zlib.error, ZstdError, LZMAError, ...
            raise ValueError(f"corrupt progressive container {dir_name} section {sec} "
                             f"(backend {stream_name}): {e!r}") from e
        return _plane_ungroup(dec, infos)

    base = section(0, payload[:nbase])
    out: "OrderedDict[str, np.ndarray]" = OrderedDict()
    if base_only:
        for name, arr in base.items():
            if name.endswith(".labels_hi"):
                out[f"{name[: -len('.labels_hi')]}.labeled_weight"] = arr
            elif name.endswith(".base_centroids"):
                out[f"{name[: -len('.base_centroids')]}.centroids"] = arr
            else:
                out[name] = arr
        return out

    refine = section(1, payload[nbase:])
    ctx_lo = bool(hdr.get("ctx_lo", False))
    for name, arr in base.items():
        if name.endswith(".labels_hi"):
            stem = name[: -len(".labels_hi")]
            lo = refine[f"{stem}.labels_lo"]
            if ctx_lo:
                # invert the encoder's stable group-by-hi permutation
                perm = np.argsort(arr.reshape(-1), kind="stable")
                lo_flat = np.empty(lo.size, lo.dtype)
                lo_flat[perm] = lo.reshape(-1)
                lo = lo_flat.reshape(lo.shape)
            out[f"{stem}.labeled_weight"] = (
                (arr.astype(np.uint16) << 4) | lo.astype(np.uint16)).astype(np.uint8)
            out[f"{stem}.centroids"] = refine[f"{stem}.centroids"]
        elif not name.endswith(".base_centroids"):
            out[name] = arr
    return out
