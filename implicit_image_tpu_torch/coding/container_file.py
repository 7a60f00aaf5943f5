"""Single-file container (.iic): one run dir in one file (counterpart of
implicit_image_tpu/coding/container_file.py, its single-run half).

`pack_run` bundles a run dir's config.json and model_quantized/{meta_data.json,
compressed_weights.data} into a zip with fixed member metadata, the JSON
deflated and the entropy-coded payload stored, so identical runs pack to
identical bytes, and both packages pack a run to the same file. The port's
`decompress.decode_run` and its CLI take a packed file wherever they take a
run dir. A delta container (quant.delta) packs too: its artifact is shared
encoder/decoder state, referenced by path and sha256, not in the file. An
inter-frame (P) container does not: one file cannot carry its chain.

    python -m implicit_image_tpu_torch.coding.container_file pack <run_dir> [out.iic]
    python -m implicit_image_tpu_torch.coding.container_file unpack <file.iic> [dest_dir]
    python -m implicit_image_tpu_torch.decompress <file.iic>

The sequence half (.iiv: `pack_sequence`, `unpack_sequence`,
`is_packed_sequence`, `read_sequence_index`, `sequence_index`) waits for the
sequence port and raises NotImplementedError.
"""
from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Optional, Union

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


def _sequences_not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"container_file.{name}: packed sequences (.iiv) are not ported yet (ROADMAP.md, "
            "M15)")

    fn.__name__ = name
    return fn


pack_sequence = _sequences_not_ported("pack_sequence")
unpack_sequence = _sequences_not_ported("unpack_sequence")
is_packed_sequence = _sequences_not_ported("is_packed_sequence")
read_sequence_index = _sequences_not_ported("read_sequence_index")
sequence_index = _sequences_not_ported("sequence_index")


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
    if argv and argv[0] in ("pack-seq", "unpack-seq"):
        _sequences_not_ported(argv[0].replace("-seq", "_sequence"))()
    raise SystemExit("usage: python -m implicit_image_tpu_torch.coding.container_file "
                     "pack <run_dir> [out.iic] | unpack <file.iic> [dest_dir]")


if __name__ == "__main__":
    main()
