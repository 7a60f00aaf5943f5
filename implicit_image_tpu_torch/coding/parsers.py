"""Stream backends for the weight bitstream (counterpart of
implicit_image_tpu/coding/parsers.py); both packages write the same bytes
for the same payload, and each decodes the other's streams.

  * plain   — raw bytes
  * zstd    — level 22 with the `zstandard` package when it imports, else
              zlib level 9; the decoder picks the codec by the stream's
              magic bytes, not by what imports, so a stream written either
              way decodes wherever its codec is present
  * lzma    — the standard library's xz container
  * huffman — canonical Huffman (native C++)
  * range   — adaptive order-1 binary range coder (native C++)
  * rans    — static 2-way interleaved rANS (native C++)
  * auto    — encodes with every backend of `_AUTO_ORDER`, keeps the
              smallest, and prefixes its index as a 1-byte tag
"""
from __future__ import annotations

import lzma
import zlib
from typing import Optional

from implicit_image_tpu_torch.coding import huffman, range_coder, rans

__all__ = ["encode_stream", "decode_stream", "backend_names", "load_native_codecs"]

backend_names = ("plain", "zstd", "lzma", "huffman", "range", "rans", "auto")

# Candidate set of `auto`; the tag byte is the index in this tuple. Tags are
# burned into containers: the order is the JAX package's and append-only.
_AUTO_ORDER = ("zstd", "lzma", "huffman", "range", "plain", "rans")

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def load_native_codecs(name: str) -> bool:
    """Build (at first use) and load the native codecs that stream `name`
    runs; returns whether it runs any. Raises when one cannot be built."""
    if name not in ("huffman", "range", "rans", "auto"):
        return False
    for codec in (huffman, range_coder, rans):
        codec.load_native()
    return True


def encode_stream(name: str, raw: bytes, level: int = 22) -> bytes:
    if name == "plain":
        return raw
    if name == "zstd":
        try:
            import zstandard
        except ImportError:  # the stream self-describes: zlib has no zstd magic
            return zlib.compress(raw, 9)
        return zstandard.ZstdCompressor(level=level).compress(raw)
    if name == "lzma":
        return lzma.compress(raw)
    if name == "huffman":
        return huffman.huffman_encode(raw)
    if name == "range":
        return range_coder.range_encode(raw)
    if name == "rans":
        return rans.rans_encode(raw)
    if name == "auto":
        best_tag, best = 0, None
        for tag, backend in enumerate(_AUTO_ORDER):
            blob = encode_stream(backend, raw, level=level)
            if best is None or len(blob) < len(best):
                best_tag, best = tag, blob
        return bytes([best_tag]) + best
    raise NotImplementedError(f"stream writer {name} not found.")


def decode_stream(name: str, blob: bytes, expected_size: Optional[int] = None) -> bytes:
    """Decode one backend stream. `expected_size` (the raw payload size the
    container manifest implies) turns truncation or corruption into a
    ValueError and bounds the native decoders' output allocation."""
    if name == "plain":
        if expected_size is not None and len(blob) != expected_size:
            raise ValueError(
                f"corrupt plain stream: {len(blob)} bytes, container "
                f"manifest expects {expected_size}"
            )
        return blob
    if name in ("huffman", "range", "rans"):
        dec = {"huffman": huffman.huffman_decode, "range": range_coder.range_decode,
               "rans": rans.rans_decode}[name](blob, expected_size=expected_size)
        if expected_size is not None and len(dec) != expected_size:
            raise ValueError(
                f"corrupt {name} stream: decoded {len(dec)} bytes, "
                f"container manifest expects {expected_size}"
            )
        return dec
    if name == "zstd":
        if blob[:4] == _ZSTD_MAGIC:
            try:
                import zstandard
            except ImportError as e:
                raise RuntimeError(
                    "stream is zstd-compressed but the zstandard package "
                    "is unavailable in this environment"
                ) from e
            # decompressobj also takes frames without a content-size header
            dec = zstandard.ZstdDecompressor().decompressobj().decompress(blob)
        else:
            dec = zlib.decompress(blob)
    elif name == "lzma":
        dec = lzma.decompress(blob)
    elif name == "auto":
        if not blob:
            raise ValueError("empty auto-coded stream")
        tag = blob[0]
        if tag >= len(_AUTO_ORDER):
            raise ValueError(f"corrupt auto-coded stream: unknown backend tag {tag}")
        return decode_stream(_AUTO_ORDER[tag], blob[1:], expected_size=expected_size)
    else:
        raise NotImplementedError(f"stream reader {name} not found.")
    if expected_size is not None and len(dec) != expected_size:
        raise ValueError(
            f"corrupt {name} stream: decoded {len(dec)} bytes, container "
            f"manifest expects {expected_size}"
        )
    return dec
