"""Static 2-way interleaved rANS codec (counterpart of
implicit_image_tpu/coding/rans.py): fractional-bit rate at table-driven
decode speed.

The codec is the native C++ one (native/rans.cpp, built at first use by
coding/native_loader.py, which raises when it cannot); the pure-Python
version below emits the bit-identical container and is reached only with
`native=False`:

  u32 magic 'IIRA' | u64 raw_size | u16 n_syms
  | n_syms x { u8 symbol, u16 freq }   (freqs sum to 1<<14 exactly)
  | u32 state0 | u32 state1 | renorm byte stream
"""
from __future__ import annotations

import ctypes
import struct
from typing import List, Optional

import numpy as np

from implicit_image_tpu_torch.coding.native_loader import codec_protos, load_or_build

__all__ = ["rans_encode", "rans_decode", "load_native"]

_MAGIC = 0x41524949  # "IIRA"
_SCALE_BITS = 14
_SCALE = 1 << _SCALE_BITS
_RANS_L = 1 << 23


def load_native() -> ctypes.CDLL:
    return load_or_build("libiirans", "rans.cpp", codec_protos("iirans"))


# ---------------------------------------------------------------- reference


def _normalize_freqs(freq: List[int], total: int) -> List[int]:
    """Cumulative rounding to sum 1<<14; mirrors rans.cpp normalize()."""
    scaled = [0] * 256
    acc = 0
    cum = 0
    for s in range(256):
        acc += freq[s]
        new_cum = acc * _SCALE // total
        scaled[s] = new_cum - cum
        cum = new_cum
    deficit = 0
    for s in range(256):
        if freq[s] and scaled[s] == 0:
            scaled[s] = 1
            deficit += 1
    while deficit > 0:  # steal from the largest bin (lowest index wins ties)
        big = -1
        for s in range(256):
            if scaled[s] > 1 and (big < 0 or scaled[s] > scaled[big]):
                big = s
        scaled[big] -= 1
        deficit -= 1
    return scaled


def _py_encode(data: bytes) -> bytes:
    n = len(data)
    freq = [0] * 256
    for b in data:
        freq[b] += 1
    scaled = _normalize_freqs(freq, n) if n else [0] * 256
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + scaled[s]

    out = bytearray(struct.pack("<IQ", _MAGIC, n))
    present = [s for s in range(256) if scaled[s]]
    out += struct.pack("<H", len(present))
    for s in present:
        out += struct.pack("<BH", s, scaled[s])
    if n == 0:
        return bytes(out)

    renorm = bytearray()  # emitted "backwards": built in reverse order
    x0 = x1 = _RANS_L
    for j in range(n - 1, -1, -1):
        b = data[j]
        f = scaled[b]
        x = x1 if j & 1 else x0
        x_max = ((_RANS_L >> _SCALE_BITS) << 8) * f
        while x >= x_max:
            renorm.append(x & 0xFF)
            x >>= 8
        x = ((x // f) << _SCALE_BITS) + (x % f) + cum[b]
        if j & 1:
            x1 = x
        else:
            x0 = x
    out += struct.pack("<II", x0, x1)
    out += bytes(reversed(renorm))
    return bytes(out)


def _py_decode(blob: bytes) -> bytes:
    if len(blob) < 14:
        raise ValueError("truncated rans stream")
    magic, raw = struct.unpack_from("<IQ", blob, 0)
    if magic != _MAGIC:
        raise ValueError("bad rans magic")
    if raw == 0:
        return b""
    (n_syms,) = struct.unpack_from("<H", blob, 12)
    hp = 14
    if len(blob) < hp + 3 * n_syms + 8:
        raise ValueError("truncated rans stream")
    scaled = [0] * 256
    for _ in range(n_syms):
        s, f = struct.unpack_from("<BH", blob, hp)
        hp += 3
        scaled[s] = f
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + scaled[s]
    if cum[256] != _SCALE:
        raise ValueError("corrupt rans frequency table")
    slot = np.zeros(_SCALE, np.uint8)
    for s in range(256):
        if scaled[s]:
            slot[cum[s] : cum[s + 1]] = s

    x0, x1 = struct.unpack_from("<II", blob, hp)
    p = hp + 8
    out = bytearray()
    for i in range(raw):
        x = x1 if i & 1 else x0
        lo = x & (_SCALE - 1)
        s = int(slot[lo])
        out.append(s)
        x = scaled[s] * (x >> _SCALE_BITS) + lo - cum[s]
        while x < _RANS_L:
            if p >= len(blob):
                raise ValueError("truncated rans stream")
            x = (x << 8) | blob[p]
            p += 1
        if i & 1:
            x1 = x
        else:
            x0 = x
    return bytes(out)


# ---------------------------------------------------------------- public


def rans_encode(data: bytes, native: bool = True) -> bytes:
    if not native:
        return _py_encode(data)
    lib = load_native()
    cap = lib.iirans_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.iirans_encode(data, len(data), out, cap)
    if n == 0:
        raise RuntimeError(f"native rans encode failed on {len(data)} bytes")
    return out.raw[:n]


def rans_decode(blob: bytes, expected_size: Optional[int] = None,
                native: bool = True) -> bytes:
    # validate the header first so every corrupt path raises ValueError
    # before any allocation
    if len(blob) < 14:
        raise ValueError("truncated rans stream")
    magic, raw = struct.unpack_from("<IQ", blob, 0)
    if magic != _MAGIC:
        raise ValueError("bad rans magic")
    if expected_size is not None and raw != expected_size:
        # rANS can legitimately expand arbitrarily, so only the manifest's
        # size bounds the allocation
        raise ValueError(
            f"corrupt rans stream: declares {raw} bytes, container "
            f"manifest expects {expected_size}"
        )
    if raw == 0:
        return b""
    if raw > 1 << 40:  # a corrupt size field would drive the allocation
        raise ValueError(f"implausible rans raw size {raw}")
    if not native:
        return _py_decode(blob)
    lib = load_native()
    out = ctypes.create_string_buffer(raw)
    got = lib.iirans_decode(blob, len(blob), out, raw)
    if got != raw:
        raise ValueError(f"corrupt rans stream: decoded {got} of {raw} bytes")
    return out.raw[:raw]
