"""Canonical byte-wise Huffman codec (counterpart of
implicit_image_tpu/coding/huffman.py).

The codec is the native C++ one (native/huffman.cpp, built at first use by
coding/native_loader.py, which raises when it cannot). The pure-Python
version below emits the bit-identical container and is the reference the
tests hold the native codec to; only `native=False` reaches it.

  u32 magic 'IIHF' | u64 raw_size | u8 code_length[256] | packed MSB-first
  canonical-Huffman bitstream (symbols ranked by (length, byte value)).
"""
from __future__ import annotations

import ctypes
import heapq
import struct
from typing import Dict, List, Optional

from implicit_image_tpu_torch.coding.native_loader import codec_protos, load_or_build

__all__ = ["huffman_encode", "huffman_decode", "load_native"]

_MAGIC = 0x46484949  # "IIHF"
_HEADER = 4 + 8 + 256


def load_native() -> ctypes.CDLL:
    return load_or_build("libiihuff", "huffman.cpp", codec_protos("iihuff"))


# ---------------------------------------------------------------- reference


def _build_lengths(freq: List[int]) -> List[int]:
    lens = [0] * 256
    heap = [(f, s, ("leaf", s)) for s, f in enumerate(freq) if f]
    heapq.heapify(heap)
    if not heap:
        return lens
    if len(heap) == 1:
        lens[heap[0][1]] = 1
        return lens
    counter = 256  # deterministic tie-break mirroring native node order
    while len(heap) > 1:
        fa, _, ta = heapq.heappop(heap)
        fb, _, tb = heapq.heappop(heap)
        heapq.heappush(heap, (fa + fb, counter, ("node", ta, tb)))
        counter += 1
    stack = [(heap[0][2], 0)]
    while stack:
        tree, depth = stack.pop()
        if tree[0] == "leaf":
            lens[tree[1]] = max(depth, 1)
        else:
            stack.append((tree[1], depth + 1))
            stack.append((tree[2], depth + 1))
    return lens


def _canonical_codes(lens: List[int]) -> Dict[int, "tuple[int, int]"]:
    codes = {}
    code = 0
    for bits in range(1, 33):
        for s in range(256):
            if lens[s] == bits:
                codes[s] = (code, bits)
                code += 1
        code <<= 1
    return codes


def _py_encode(data: bytes) -> bytes:
    freq = [0] * 256
    for b in data:
        freq[b] += 1
    lens = _build_lengths(freq)
    codes = _canonical_codes(lens)
    out = bytearray(struct.pack("<IQ", _MAGIC, len(data)))
    out += bytes(lens)
    bitbuf = 0
    bitcnt = 0
    for b in data:
        c, n = codes[b]
        bitbuf = (bitbuf << n) | c
        bitcnt += n
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8
        bitbuf &= (1 << bitcnt) - 1  # keep the int small (O(N) encode)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _validate_header(blob: bytes) -> int:
    """Check magic/length and return the declared raw size, bounding it
    against the body length: the shortest code is 1 bit, so a body byte
    can never decode to more than 8 output bytes."""
    if len(blob) < _HEADER:
        raise ValueError("truncated huffman stream (no header)")
    magic, raw = struct.unpack_from("<IQ", blob, 0)
    if magic != _MAGIC:
        raise ValueError("bad huffman magic")
    body = len(blob) - _HEADER
    if raw > body * 8:
        raise ValueError(f"corrupt huffman stream: declares {raw} bytes, body is {body}")
    return raw


def _py_decode(blob: bytes) -> bytes:
    raw = _validate_header(blob)
    if raw == 0:
        return b""
    lens = list(blob[12:_HEADER])
    first_code = [0] * 33
    first_sym = [0] * 33
    count_at = [0] * 33
    sym_by_rank = []
    code = 0
    for bits in range(1, 33):
        first_code[bits] = code
        first_sym[bits] = len(sym_by_rank)
        for s in range(256):
            if lens[s] == bits:
                sym_by_rank.append(s)
                code += 1
                count_at[bits] += 1
        code <<= 1
    out = bytearray()
    code = 0
    bits = 0
    for byte in blob[_HEADER:]:
        for k in range(7, -1, -1):
            code = (code << 1) | ((byte >> k) & 1)
            bits += 1
            if count_at[bits] and code - first_code[bits] < count_at[bits]:
                out.append(sym_by_rank[first_sym[bits] + code - first_code[bits]])
                code = 0
                bits = 0
                if len(out) == raw:
                    return bytes(out)
    if len(out) != raw:
        raise ValueError("truncated huffman stream")
    return bytes(out)


# ---------------------------------------------------------------- public


def huffman_encode(data: bytes, native: bool = True) -> bytes:
    if not native:
        return _py_encode(data)
    lib = load_native()
    cap = lib.iihuff_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.iihuff_encode(data, len(data), out, cap)
    if n == 0:
        raise RuntimeError(f"native huffman encode failed on {len(data)} bytes")
    return out.raw[:n]


def huffman_decode(blob: bytes, expected_size: Optional[int] = None,
                   native: bool = True) -> bytes:
    # validate the header first so every corrupt path raises ValueError
    # before any size-raw allocation
    raw = _validate_header(blob)
    if expected_size is not None and raw != expected_size:
        raise ValueError(
            f"corrupt huffman stream: declares {raw} bytes, container "
            f"manifest expects {expected_size}"
        )
    if raw == 0:
        return b""
    if not native:
        return _py_decode(blob)
    lib = load_native()
    out = ctypes.create_string_buffer(raw)
    got = lib.iihuff_decode(blob, len(blob), out, raw)
    if got != raw:
        raise ValueError(f"corrupt huffman stream: decoded {got} of {raw} bytes")
    return out.raw[:raw]
