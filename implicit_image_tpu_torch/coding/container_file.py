"""Single-file containers (counterpart of
implicit_image_tpu/coding/container_file.py): one run in an .iic file, one
sequence in an .iiv file.

`pack_run` bundles a run dir's config.json and model_quantized/{meta_data.json,
compressed_weights.data} into a zip with fixed member metadata, the JSON
deflated and the entropy-coded payload stored, so identical runs pack to
identical bytes, and both packages pack a run to the same file. The port's
`decompress.decode_run` and its CLI take a packed file wherever they take a
run dir. A delta container (quant.delta) packs too: its artifact is shared
encoder/decoder state, referenced by path and sha256, not in the file. An
inter-frame (P) container does not: one file cannot carry its chain.

A whole sequence (a seq_* dir of sequence.py) packs into one .iiv file
(`pack_sequence`): every frame dir's config.json, summary.json and
container, after a sequence.json GOP index (each frame's name, its kind, I
or P, and its `prev` link), with the same member order, timestamps and
compression as the JAX package, so both pack a seq dir to the same bytes.
The `prev` links are relative frame names inside the archive, so the chain
ships whole; an I-frame's quant.delta artifact stays outside, as in .iic.
`sequence.decode_sequence` reads an .iiv directly; a seek to frame t reads
the index and extracts only the nearest I-frame and the P-chain to t
(`unpack_sequence(..., frames=...)`).

    python -m implicit_image_tpu_torch.coding.container_file pack <run_dir> [out.iic]
    python -m implicit_image_tpu_torch.coding.container_file unpack <file.iic> [dest_dir]
    python -m implicit_image_tpu_torch.decompress <file.iic>
    python -m implicit_image_tpu_torch.coding.container_file pack-seq <seq_dir> [out.iiv]
    python -m implicit_image_tpu_torch.coding.container_file unpack-seq <file.iiv> [dest_dir]
    python -m implicit_image_tpu_torch.sequence decode <file.iiv> [frame=t]
"""
from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Optional, Sequence, Union

__all__ = [
    "pack_run", "unpack_run", "is_packed_container", "MEMBERS",
    "pack_sequence", "unpack_sequence", "is_packed_sequence", "read_sequence_index",
    "sequence_index",
]

MEMBERS = (
    "config.json",
    "model_quantized/meta_data.json",
    "model_quantized/compressed_weights.data",
)
# a fixed timestamp: identical runs pack to identical bytes
_EPOCH = (1980, 1, 1, 0, 0, 0)


def pack_run(run_dir: Union[str, Path], out_path: Union[str, Path, None] = None) -> Path:
    """Bundle a decodable run dir into one .iic file; returns its path
    (default: the run dir's path with the suffix .iic)."""
    run_dir = Path(run_dir)
    for name in MEMBERS:
        if not (run_dir / name).is_file():
            raise FileNotFoundError(f"{run_dir} is not a decodable run dir (missing {name})")
    meta = json.loads((run_dir / "model_quantized" / "meta_data.json").read_text())
    delta = meta.get("__meta__", {}).get("delta", {})
    if "prev" in delta:
        raise ValueError(
            f"{run_dir} is an inter-frame (P) container chained to {delta['prev']!r}: a single "
            "file cannot carry the decode chain")
    out_path = Path(out_path) if out_path else run_dir.with_suffix(".iic")
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as z:
        for name in MEMBERS:
            z.writestr(zipfile.ZipInfo(name, date_time=_EPOCH), (run_dir / name).read_bytes(),
                       compress_type=_member_compression(name), compresslevel=9)
    return out_path


def _member_compression(name: str) -> int:
    """Deflate (level 9, deterministic for a given zlib) the JSON manifests;
    store the payload, which is entropy-coded already."""
    return zipfile.ZIP_DEFLATED if name.endswith(".json") else zipfile.ZIP_STORED


def is_packed_container(path: Union[str, Path]) -> bool:
    path = Path(path)
    if not path.is_file() or not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
    return all(m in names for m in MEMBERS)


def unpack_run(path: Union[str, Path], dest: Union[str, Path, None] = None) -> Path:
    """Extract a packed container to a run dir (default: beside the file,
    named after its stem); returns the run dir. Only the MEMBERS are read,
    each to its fixed path under `dest`."""
    path = Path(path)
    if not is_packed_container(path):
        raise ValueError(f"{path} is not a packed .iic container "
                         f"(expected a zip holding {', '.join(MEMBERS)})")
    dest = Path(dest) if dest else path.parent / path.stem
    with zipfile.ZipFile(path) as z:
        for name in MEMBERS:
            target = dest / name
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_bytes(z.read(name))
    return dest


# ---- the sequence container (.iiv): an I+P chain in one file ----

_FRAME_MEMBERS = (
    "config.json",
    "summary.json",
    "model_quantized/meta_data.json",
    "model_quantized/compressed_weights.data",
)
_SEQ_INDEX = "sequence.json"


def sequence_index(seq_root: Union[str, Path]) -> dict:
    """The .iiv index of a seq_* dir: its frame dirs in order, each with its
    kind (I: standalone, P: chained to `prev`) read from its manifest. A
    chain whose first frame is a P-frame has no decode root and raises
    ValueError."""
    seq_root = Path(seq_root)
    frame_dirs = sorted(d for d in seq_root.iterdir()
                        if d.is_dir() and d.name.startswith("frame_"))
    if not frame_dirs:
        raise FileNotFoundError(f"no frame_* dirs under {seq_root}")
    frames = []
    for d in frame_dirs:
        meta = json.loads((d / "model_quantized" / "meta_data.json").read_text())
        delta = meta.get("__meta__", {}).get("delta", {})
        frames.append({"name": d.name, "kind": "P" if "prev" in delta else "I",
                       "prev": delta.get("prev")})
    if frames[0]["kind"] != "I":
        raise ValueError(f"{seq_root}: first frame {frames[0]['name']} is not an I-frame — "
                         "the chain has no decode root")
    return {"format": "iiv-1", "frames": frames}


def pack_sequence(seq_root: Union[str, Path], out_path: Union[str, Path, None] = None) -> Path:
    """Bundle a seq_* dir into one .iiv file (default: the dir's path with
    the suffix .iiv); returns its path."""
    seq_root = Path(seq_root)
    index = sequence_index(seq_root)
    out_path = Path(out_path) if out_path else seq_root.with_suffix(".iiv")
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(zipfile.ZipInfo(_SEQ_INDEX, date_time=_EPOCH),
                   json.dumps(index, indent=2, sort_keys=True),
                   compress_type=zipfile.ZIP_DEFLATED, compresslevel=9)
        for fr in index["frames"]:
            for name in _FRAME_MEMBERS:
                src = seq_root / fr["name"] / name
                if not src.is_file():
                    raise FileNotFoundError(f"{seq_root / fr['name']} is not a decodable frame "
                                            f"dir (missing {name})")
                z.writestr(zipfile.ZipInfo(f"{fr['name']}/{name}", date_time=_EPOCH),
                           src.read_bytes(), compress_type=_member_compression(name),
                           compresslevel=9)
    return out_path


def is_packed_sequence(path: Union[str, Path]) -> bool:
    path = Path(path)
    if not path.is_file() or not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return _SEQ_INDEX in set(z.namelist())


def read_sequence_index(path: Union[str, Path]) -> dict:
    """The sequence.json GOP index of an .iiv, read without extracting any
    frame (the zip's central directory and one small member)."""
    path = Path(path)
    if not is_packed_sequence(path):
        raise ValueError(f"{path} is not a packed .iiv sequence container "
                         f"(expected a zip with a {_SEQ_INDEX} index)")
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read(_SEQ_INDEX))


def unpack_sequence(path: Union[str, Path], dest: Union[str, Path, None] = None,
                    frames: Optional[Sequence[str]] = None) -> Path:
    """Extract an .iiv file to a seq dir (default: beside the file, named
    after its stem); returns that dir. `frames`: extract only the named
    frame dirs (a GOP seek needs the nearest I-frame and the P-chain to its
    frame; the other payloads are never read). A frame name holding "/" or
    starting with "." raises ValueError; member paths are rebuilt from the
    fixed member tuple under `dest`."""
    path = Path(path)
    index = read_sequence_index(path)
    dest = Path(dest) if dest else path.parent / path.stem
    want = None if frames is None else set(frames)
    with zipfile.ZipFile(path) as z:
        dest.mkdir(parents=True, exist_ok=True)
        (dest / _SEQ_INDEX).write_text(json.dumps(index, indent=2, sort_keys=True))
        for fr in index["frames"]:
            if "/" in fr["name"] or fr["name"].startswith("."):
                raise ValueError(f"suspicious frame name {fr['name']!r}")
            if want is not None and fr["name"] not in want:
                continue
            for name in _FRAME_MEMBERS:
                target = dest / fr["name"] / name
                target.parent.mkdir(parents=True, exist_ok=True)
                target.write_bytes(z.read(f"{fr['name']}/{name}"))
    return dest


def main(argv: Optional[list] = None) -> None:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) >= 2 and argv[0] == "pack":
        out = pack_run(argv[1], argv[2] if len(argv) > 2 else None)
        print(f"packed {argv[1]} -> {out} ({out.stat().st_size} bytes)")
        return
    if len(argv) >= 2 and argv[0] == "unpack":
        out = unpack_run(argv[1], argv[2] if len(argv) > 2 else None)
        print(f"unpacked {argv[1]} -> {out}")
        return
    if len(argv) >= 2 and argv[0] == "pack-seq":
        out = pack_sequence(argv[1], argv[2] if len(argv) > 2 else None)
        print(f"packed {argv[1]} -> {out} ({out.stat().st_size} bytes)")
        return
    if len(argv) >= 2 and argv[0] == "unpack-seq":
        out = unpack_sequence(argv[1], argv[2] if len(argv) > 2 else None)
        print(f"unpacked {argv[1]} -> {out}")
        return
    raise SystemExit("usage: python -m implicit_image_tpu_torch.coding.container_file "
                     "pack <run_dir> [out.iic] | unpack <file.iic> [dest_dir] | "
                     "pack-seq <seq_dir> [out.iiv] | unpack-seq <file.iiv> [dest_dir]")


if __name__ == "__main__":
    main()
