"""Port parity: the stream backends (coding/parsers.py) and the native codecs.

For every backend and a seeded payload both packages write identical bytes
(the `auto` tag byte included) and each decodes the other's stream; the
port's native codecs equal its pure-Python versions; corrupt streams raise
ValueError, and so does a `range` stream cut short or with bytes appended
(the port's decoders read the body exactly to its end); a codec that cannot
be built raises instead of dropping to Python.
"""
from pathlib import Path

import numpy as np
import pytest

from implicit_image_tpu.coding import parsers as jparsers
from implicit_image_tpu.coding import range_coder as jrange
from implicit_image_tpu_torch.coding import huffman, native_loader, range_coder, rans
from implicit_image_tpu_torch.coding import parsers as tparsers

CODECS = {
    "huffman": (huffman.huffman_encode, huffman.huffman_decode),
    "range": (range_coder.range_encode, range_coder.range_decode),
    "rans": (rans.rans_encode, rans.rans_decode),
}


def _payload(seed, n=4000):
    """fp16 weights' bytes, then k-means labels: the container's mix."""
    rng = np.random.default_rng(seed)
    weights = rng.normal(0, 0.02, n).astype(np.float16).tobytes()
    labels = np.clip(rng.normal(128, 12, 2 * n), 0, 255).astype(np.uint8).tobytes()
    return weights + labels


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", tparsers.backend_names)
def test_backend_bytes_identical_and_cross_decodable(name, seed):
    raw = _payload(seed)
    ours, theirs = tparsers.encode_stream(name, raw), jparsers.encode_stream(name, raw)
    assert ours == theirs
    assert tparsers.decode_stream(name, theirs, expected_size=len(raw)) == raw
    assert jparsers.decode_stream(name, ours, expected_size=len(raw)) == raw


def test_auto_order_and_tag():
    assert tparsers._AUTO_ORDER == jparsers._AUTO_ORDER
    assert tparsers.backend_names == jparsers.backend_names
    raw = _payload(2)
    blob = tparsers.encode_stream("auto", raw)
    sizes = [len(tparsers.encode_stream(b, raw)) for b in tparsers._AUTO_ORDER]
    assert blob[0] == int(np.argmin(sizes))
    assert len(blob) == 1 + min(sizes)


@pytest.mark.parametrize("raw", [b"", b"\x07", b"\x00" * 500, bytes(range(256)) * 3])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_native_equals_python(codec, raw):
    enc, dec = CODECS[codec]
    blob = enc(raw)
    assert blob == enc(raw, native=False)
    assert dec(blob) == raw
    assert dec(blob, native=False) == raw


def test_native_equals_python_on_container_payload():
    raw = _payload(3, n=1500)
    for enc, dec in CODECS.values():
        blob = enc(raw)
        assert blob == enc(raw, native=False)
        assert dec(blob, native=False) == raw


def test_zstd_codec_chosen_by_magic():
    """A zlib stream (what `zstd` writes where the zstandard package is
    missing) decodes in both packages under the name `zstd`."""
    import zlib

    raw = _payload(4)
    blob = zlib.compress(raw, 9)
    assert tparsers.decode_stream("zstd", blob, expected_size=len(raw)) == raw
    assert jparsers.decode_stream("zstd", blob, expected_size=len(raw)) == raw


@pytest.mark.parametrize("name", ["plain", "zstd", "lzma", "huffman", "range", "rans", "auto"])
def test_wrong_expected_size_raises(name):
    raw = _payload(5, n=300)
    blob = tparsers.encode_stream(name, raw)
    with pytest.raises(ValueError):
        tparsers.decode_stream(name, blob, expected_size=len(raw) + 1)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_corrupt_native_streams_raise(codec):
    enc, dec = CODECS[codec]
    raw = _payload(6, n=300)
    blob = enc(raw)
    with pytest.raises(ValueError):
        dec(b"XXXX" + blob[4:])  # bad magic
    with pytest.raises(ValueError):
        dec(blob[:10])  # truncated header


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("edit", ["cut 1 byte", "append 1 byte"])
def test_misread_range_body_raises(native, edit):
    """A range stream one byte short, or one byte long, raises ValueError in
    the native and the Python decoder (both read zeros past the end before
    the repair and returned wrong bytes without error)."""
    blob = jrange.range_encode(_payload(7, n=300))
    bad = blob[:-1] if edit == "cut 1 byte" else blob + b"\x00"
    with pytest.raises(ValueError, match="read exactly to its end"):
        range_coder.range_decode(bad, native=native)


@pytest.mark.parametrize("native", [True, False])
def test_intact_range_streams_read_to_their_end(native):
    """Streams the JAX package writes (sizes 1 to 3,000 bytes; random,
    skewed and constant data) still decode in both of the port's decoders:
    each body is read exactly to its end."""
    rng = np.random.default_rng(8)
    for n in (1, 2, 5, 17, 256, 999, 3000):
        for raw in (rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
                    np.clip(rng.normal(128, 3, n), 0, 255).astype(np.uint8).tobytes(),
                    bytes([n % 256]) * n):
            assert range_coder.range_decode(jrange.range_encode(raw), len(raw),
                                            native=native) == raw


def test_unknown_backend_and_tag_raise():
    with pytest.raises(NotImplementedError):
        tparsers.encode_stream("brotli", b"abc")
    with pytest.raises(ValueError):
        tparsers.decode_stream("auto", bytes([len(tparsers._AUTO_ORDER)]) + b"abc")


def test_failed_build_raises(tmp_path, monkeypatch):
    """A codec library that does not build raises; nothing falls back."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_loader, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on the path
    with pytest.raises(RuntimeError):
        huffman.huffman_encode(b"abc")
    with pytest.raises(RuntimeError):
        tparsers.encode_stream("auto", b"abc")
    assert not (tmp_path / "native").exists() or not any((tmp_path / "native").iterdir())


def test_libraries_build_from_the_port_sources():
    for mod in (huffman, range_coder, rans):
        lib = mod.load_native()
        assert native_loader.BUILD_DIR in Path(lib._name).parents
    srcs = sorted(p.name for p in native_loader.NATIVE_SRC.glob("*.cpp"))
    assert srcs == ["huffman.cpp", "range_coder.cpp", "rans.cpp"]
