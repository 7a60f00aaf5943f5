"""Build and load the package's CUDA kernels (nvcc into a shared library with a
plain C interface, loaded with ctypes).

The library is built at first use, never at import, from the sources under
`implicit_image_tpu_torch/csrc/` only, into `build/kernels/` at the root of
the checkout. Its file name carries a hash of the sources and of the build
commands, so an edited source triggers a rebuild and a stale library is
never loaded. sine_mlp.cu is compiled in parts, one nvcc each, all started
together, then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         [-DSINE_MLP_WIDE=192 -DSINE_MLP_PART=0|1 | -DSINE_MLP_LAYER=0|1|2] \
         -c -o <part>.o csrc/sine_mlp.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libiit_<hash>.so *.o
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from implicit_image_tpu_torch.ops.sine_mlp import KERNEL_WIDTHS

__all__ = ["CSRC", "BUILD_DIR", "LayerArgs", "build", "load_library", "open_device",
           "ptxas_report", "ptxas_table"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("sine_mlp.cu", "fast_math.cuh", "hopper.cuh")
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# the parts of sine_mlp.cu: the width-128 kernels, sum_partials and the C
# interface; then the width-192 forward and backward; then the layer-wise
# kernels (every width above 192): forward, backward, dW
_PARTS = {"base": []} | {
    f"{part}{w}": [f"-DSINE_MLP_WIDE={w}", f"-DSINE_MLP_PART={i}"]
    for w in KERNEL_WIDTHS[1:] for i, part in enumerate(("fwd", "bwd"))} | {
    f"layer_{part}": [f"-DSINE_MLP_LAYER={i}"] for i, part in enumerate(("fwd", "bwd", "dw"))}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


class LayerArgs(ctypes.Structure):
    """One launch of a layer-wise kernel: csrc/sine_mlp.cu's LayerArgs, field
    for field (pointers as ints from data_ptr(), None for null; *_m the
    floats from one member's matrix to the next)."""

    _fields_ = ([(k, _P) for k in ("src", "g", "w", "b", "dst", "z", "x", "part")]
                + [(f"{k}_m", _L) for k in ("src", "g", "w", "b", "dst", "z", "x", "part")]
                + [(k, _L) for k in ("n", "n_part", "off_db", "off_dw0", "off_dwl", "off_dbl",
                                     "off_dw")]
                + [(k, _I) for k in ("in_size", "hidden", "out_size", "slices")]
                + [("omega", _F), ("members", _I)])


_A = ctypes.POINTER(LayerArgs)
_SIGNATURES = {
    "sine_mlp_kernel_width": ([_I], _I),
    "sine_mlp_tile_rows": ([_I], _I),
    "sine_mlp_max_io": ([], _I),
    # x, w0, wm, wp (W's planes), wl, bs, bl, out, members,
    # x_stride, n, in, out, depth, hidden, omega0, omega_h, bf16, stream (one
    # member: the single launch)
    "sine_mlp_fwd_batched": ([_P] * 8 + [_I, ctypes.c_longlong] + [_I] * 5
                             + [_F, _F, _I, _P], _I),
    "sine_mlp_max_rows": ([], _I),
    # x, g, w0, wm, wmt (W's planes), wl, bs, dx, z_scratch, partials,
    # members, x_stride, grid, n_part, n, in, out, depth, hidden, omega0,
    # omega_h, bf16, stream (one member: the single launch)
    "sine_mlp_bwd_batched": ([_P] * 10 + [_I, ctypes.c_longlong] + [_I] * 7
                             + [_F, _F, _I, _P], _I),
    # the layer-wise kernels (widths above 192): args, kind (0 first, 1
    # hidden, 2 last), bf16, stream; dW: args, bf16, stream
    "sine_mlp_layer_fwd": ([_A, _I, _I, _P], _I),
    "sine_mlp_layer_bwd": ([_A, _I, _I, _P], _I),
    "sine_mlp_layer_dw": ([_A, _I, _P], _I),
    "sum_partials_groups": ([], _I),
    # partials, out, n_blocks, n_part, stream
    "sum_partials": ([_P, _P, _I, _I, _P], _I),
    # partials, out, members, n_blocks, n_part, stream
    "sum_partials_batched": ([_P, _P, _I, _I, _I, _P], _I),
}

_state = {"lib": None, "ptxas": ""}
_lock = threading.Lock()


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
    h.update(repr(sorted(_PARTS.items())).encode())
    return h.hexdigest()[:16]


def _run(cmd) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return proc


def build(src_dir: Path, out: Path) -> str:
    """Compile src_dir/sine_mlp.cu (with its headers) in its parts, all at
    once, and link them into the shared library `out`; returns ptxas's
    report. The tools build their copies of the source with it too."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = {name: tmp.with_name(f"{tmp.name}.{name}.o") for name in _PARTS}
    cmds = [[_nvcc(), _ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             *flags, "-c", "-o", str(objs[name]), str(src_dir / "sine_mlp.cu")]
            for name, flags in _PARTS.items()]
    try:
        with ThreadPoolExecutor(len(cmds)) as ex:
            report = "".join(p.stderr for p in ex.map(_run, cmds))
        _run([_nvcc(), _ARCH, "-shared", "-o", str(tmp), *map(str, objs.values())])
    finally:
        for obj in objs.values():
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return report


def load_library() -> ctypes.CDLL:
    """Build (when the sources changed) and load the kernel library; threads
    (the multirun launcher's) build it once."""
    if _state["lib"] is not None:
        return _state["lib"]
    with _lock:
        return _state["lib"] or _load()


def open_device(device):
    """The device of an entry point, as a torch.device. "cuda" raises
    RuntimeError when no CUDA device is present, else builds (or loads) the
    kernels: set-up, kept out of the caller's timed wall. Either way TF32
    products are switched off (`tensorfloat32` means fp32 here, never
    1-pass TF32). "cpu" runs the plain versions."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device} but no CUDA device is available")
        load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def _load() -> ctypes.CDLL:
    path = BUILD_DIR / f"libiit_{_source_hash()}.so"
    if not path.is_file():
        _state["ptxas"] = build(CSRC, path)
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


def ptxas_table(report: str) -> dict:
    """A ptxas -v report -> {function: {"registers", "spill_stores",
    "spill_loads"}}, each function under its demangled name (cu++filt from
    the toolkit; the mangled name where it is absent)."""
    table, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            table.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            table[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name]["registers"] = int(m[1])
    names = list(table)
    filt = Path(_nvcc()).with_name("cu++filt")
    if names and filt.is_file():
        out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        if len(out) == len(names):
            return {d: table[n] for n, d in zip(names, out)}
    return table
