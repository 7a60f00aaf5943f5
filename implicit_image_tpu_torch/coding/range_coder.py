"""Adaptive order-1 binary range coder (counterpart of
implicit_image_tpu/coding/range_coder.py).

Bytes are coded bit by bit through a 255-node probability tree with the
previous byte as context, probabilities adapting online (LZMA-style 12-bit
probs, shift-5 update). The codec is the native C++ one
(native/range_coder.cpp, built at first use by coding/native_loader.py,
which raises when it cannot); the pure-Python version below emits the
bit-identical container and is reached only with `native=False`. Both
decoders count the body bytes they read and raise ValueError unless that is
the body's length: a stream cut short, or one with bytes appended, does not
decode (the JAX package's decoders read zeros past the end instead):

  u32 magic 'IIRC' | u64 raw_size | carryless-range-coder bytes
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

from implicit_image_tpu_torch.coding.native_loader import codec_protos, load_or_build

__all__ = ["range_encode", "range_decode", "load_native"]

_MAGIC = 0x43524949  # "IIRC"
_TOP = 1 << 24
_PROB_BITS = 12
_PROB_INIT = 1 << (_PROB_BITS - 1)
_ADAPT = 5
_MASK32 = 0xFFFFFFFF


def load_native() -> ctypes.CDLL:
    return load_or_build("libiirange", "range_coder.cpp", codec_protos("iirange"))


# ---------------------------------------------------------------- reference


def _py_encode(data: bytes) -> bytes:
    out = bytearray(struct.pack("<IQ", _MAGIC, len(data)))
    probs = [_PROB_INIT] * (256 * 256)
    low = 0
    rng = _MASK32
    cache = 0
    cache_size = 1
    body = bytearray()

    def shift_low():
        nonlocal low, cache, cache_size
        if (low & _MASK32) < 0xFF000000 or (low >> 32) != 0:
            carry = (low >> 32) & 0xFF
            temp = cache
            while True:
                body.append((temp + carry) & 0xFF)
                temp = 0xFF
                cache_size -= 1
                if cache_size == 0:
                    break
            cache = (low >> 24) & 0xFF
        cache_size += 1
        low = (low << 8) & _MASK32

    def encode_bit(idx, bit):
        nonlocal low, rng
        p = probs[idx]
        bound = (rng >> _PROB_BITS) * p
        if not bit:
            rng = bound
            probs[idx] = p + (((1 << _PROB_BITS) - p) >> _ADAPT)
        else:
            low += bound
            rng -= bound
            probs[idx] = p - (p >> _ADAPT)
        while rng < _TOP:
            rng = (rng << 8) & _MASK32
            shift_low()

    ctx = 0
    for b in data:
        node = 1
        for k in range(7, -1, -1):
            bit = (b >> k) & 1
            encode_bit(ctx * 256 + node, bit)
            node = (node << 1) | bit
        ctx = b
    for _ in range(5):
        shift_low()
    return bytes(out) + bytes(body)


def _py_decode(blob: bytes) -> bytes:
    magic, raw = struct.unpack_from("<IQ", blob, 0)
    if magic != _MAGIC:
        raise ValueError("bad range-coder magic")
    probs = [_PROB_INIT] * (256 * 256)
    data = blob[12:]
    pos = 0
    rng = _MASK32
    code = 0

    def get():  # pos counts every read, those past the end (taken as 0) too
        nonlocal pos
        b = data[pos] if pos < len(data) else 0
        pos += 1
        return b

    # mirror the C++ uint32_t register: truncate to 32 bits each shift (the
    # encoder's first emitted byte is always 0, so the truncation drops nothing)
    for _ in range(5):
        code = ((code << 8) | get()) & _MASK32

    def decode_bit(idx):
        nonlocal rng, code
        p = probs[idx]
        bound = (rng >> _PROB_BITS) * p
        if code < bound:
            rng = bound
            probs[idx] = p + (((1 << _PROB_BITS) - p) >> _ADAPT)
            bit = 0
        else:
            code -= bound
            rng -= bound
            probs[idx] = p - (p >> _ADAPT)
            bit = 1
        while rng < _TOP:
            rng = (rng << 8) & _MASK32
            code = ((code << 8) | get()) & _MASK32
        return bit

    out = bytearray()
    ctx = 0
    for _ in range(raw):
        node = 1
        for _ in range(8):
            node = (node << 1) | decode_bit(ctx * 256 + node)
        b = node & 0xFF
        out.append(b)
        ctx = b
    if pos != len(data):
        raise ValueError(_misread(len(data), pos))
    return bytes(out)


def _misread(body: int, read: int = None) -> str:
    said = "" if read is None else f", the decoder read {read}"
    return (f"corrupt range-coder stream: the body is {body} bytes{said}; an intact "
            f"stream is read exactly to its end (cut short or bytes appended?)")


def _validate_header(blob: bytes) -> int:
    """Check magic and return the declared raw size, bounding it against the
    body length (saturated probabilities cost ~0.011 bit per bit, ~92x; 256x
    bounds the allocation and never rejects a real stream)."""
    if len(blob) < 12:
        raise ValueError("truncated range-coder stream (no header)")
    magic, raw = struct.unpack_from("<IQ", blob, 0)
    if magic != _MAGIC:
        raise ValueError("bad range-coder magic")
    body = len(blob) - 12
    if raw > 0 and (body == 0 or raw > body * 256 + 64):
        raise ValueError(f"corrupt range-coder stream: declares {raw} bytes, body is {body}")
    return raw


# ---------------------------------------------------------------- public


def range_encode(data: bytes, native: bool = True) -> bytes:
    if not native:
        return _py_encode(data)
    lib = load_native()
    cap = lib.iirange_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.iirange_encode(data, len(data), out, cap)
    if n == 0:
        raise RuntimeError(f"native range-coder encode failed on {len(data)} bytes")
    return out.raw[:n]


def range_decode(blob: bytes, expected_size: Optional[int] = None,
                 native: bool = True) -> bytes:
    raw = _validate_header(blob)
    if expected_size is not None and raw != expected_size:
        raise ValueError(
            f"corrupt range-coder stream: declares {raw} bytes, container "
            f"manifest expects {expected_size}"
        )
    if raw == 0:
        return b""
    if not native:
        return _py_decode(blob)
    lib = load_native()
    out = ctypes.create_string_buffer(raw)
    got = lib.iirange_decode(blob, len(blob), out, raw)
    if got != raw:  # the header was checked above: the body was misread
        raise ValueError(_misread(len(blob) - 12))
    return out.raw[:raw]
