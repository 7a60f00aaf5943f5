"""Build and load the package's CUDA kernels (nvcc into a shared library with a
plain C interface, loaded with ctypes).

The library is built at first use, never at import, from the sources under
`implicit_image_tpu_torch/csrc/` only, into `build/kernels/` at the root of
the checkout. Its file name carries a hash of the sources, so an edited
source triggers a rebuild and a stale library is never loaded.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/libiit_<hash>.so csrc/sine_mlp.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "load_library", "ptxas_report"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("sine_mlp.cu", "fast_math.cuh")
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sine_mlp_hidden": ([], _I),
    "sine_mlp_tile_rows": ([], _I),
    "sine_mlp_max_io": ([], _I),
    # x, w0, wm, wl, bs, bl, out, n, in, out, depth, omega0, omega_h, bf16, stream
    "sine_mlp_fwd": ([_P] * 7 + [_I] * 4 + [_F, _F, _I, _P], _I),
    # x, g, w0, wm, wl, bs, dx, z_scratch, partials, grid, n_part, n, in, out,
    # depth, omega0, omega_h, bf16, stream
    "sine_mlp_bwd": ([_P] * 9 + [_I] * 6 + [_F, _F, _I, _P], _I),
    "sum_partials_groups": ([], _I),
    # partials, out, n_blocks, n_part, stream
    "sum_partials": ([_P, _P, _I, _I, _P], _I),
}

_state = {"lib": None, "ptxas": ""}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")  # the toolkit's default home
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "implicit_image_tpu_torch are built from source at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(_ARCH.encode())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), _ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(tmp), str(CSRC / "sine_mlp.cu"),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    _state["ptxas"] = proc.stderr
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """Build (when the sources changed) and load the kernel library."""
    if _state["lib"] is not None:
        return _state["lib"]
    path = BUILD_DIR / f"libiit_{_source_hash()}.so"
    if not path.is_file():
        _build(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _state["lib"] = lib
    return lib


def ptxas_report() -> str:
    """ptxas's register / shared-memory / spill report of the last build in
    this process ("" when the library was already built)."""
    return _state["ptxas"]
