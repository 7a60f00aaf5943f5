"""Build-on-first-use ctypes loader for the native entropy codecs
(counterpart of implicit_image_tpu/coding/native_loader.py).

The sources are the port's own copies under coding/native/. Each library is
built at first use, never at import, with

    g++ -O3 -shared -fPIC coding/native/<src> -o build/native/<lib>_<hash>.so

into `build/native/` at the root of the checkout; the file name carries a
hash of the source, so an edited source triggers a rebuild. Concurrent
processes may race to build: each compiles to its own temporary name and
renames it into place (atomic).

A failed build or load raises: the codecs never drop silently to their
pure-Python versions (those are reachable only through the codecs'
explicit `native=False` argument).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["NATIVE_SRC", "BUILD_DIR", "load_or_build", "codec_protos"]

NATIVE_SRC = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

# fn name -> (restype, argtypes)
Prototypes = Dict[str, Tuple[object, Sequence[object]]]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _build(src: Path, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native codec {src.name} failed: {e!r}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) building {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)


def load_or_build(lib_name: str, src_name: str, protos: Prototypes) -> ctypes.CDLL:
    """Build (when the source changed) and load one codec library, binding
    its prototypes; raises RuntimeError or OSError when it cannot. Threads
    (the multirun launcher's) build it once."""
    with _lock:
        return _load_or_build(lib_name, src_name, protos)


def _load_or_build(lib_name: str, src_name: str, protos: Prototypes) -> ctypes.CDLL:
    if lib_name in _loaded:
        return _loaded[lib_name]
    src = NATIVE_SRC / src_name
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"{lib_name}_{digest}.so"
    if not path.is_file():
        _build(src, path)
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in protos.items():
        sym = getattr(lib, fn)
        sym.restype = restype
        sym.argtypes = list(argtypes)
    _loaded[lib_name] = lib
    return lib


def codec_protos(prefix: str) -> Prototypes:
    """The common codec signature: bound(u64) -> u64,
    encode/decode(buf, u64, buf, u64) -> u64."""
    u64 = ctypes.c_uint64
    buf = ctypes.c_char_p
    return {
        f"{prefix}_bound": (u64, [u64]),
        f"{prefix}_encode": (u64, [buf, u64, buf, u64]),
        f"{prefix}_decode": (u64, [buf, u64, buf, u64]),
    }
