"""Port parity: the container. For the same numpy state dict both packages
write the same bytes, and each package's reader decodes the other's
container to identical arrays."""
import hashlib
import json
from collections import OrderedDict

import numpy as np
import pytest
import torch

from implicit_image_tpu import coding as jcoding
from implicit_image_tpu.quant.kmeans import LayerCodebook as JBook
from implicit_image_tpu_torch import coding as tcoding
from implicit_image_tpu_torch.quant.kmeans import LayerCodebook as TBook

torch.set_num_threads(1)


def _params_and_books(seed=0, depth=4, h=16):
    rng = np.random.default_rng(seed)
    dims = [(2, h)] + [(h, h)] * (depth - 2) + [(h, 3)]
    params = [{"w": rng.normal(0, 0.1, d).astype(np.float32),
               "b": rng.normal(0, 0.1, d[1]).astype(np.float32)} for d in dims]
    books = [None] + [
        (rng.integers(0, 16, d).astype(np.int32),
         np.concatenate([[0.0], np.sort(rng.normal(0, 0.1, 15))]).astype(np.float32))
        for d in dims[1:-1]
    ] + [None]
    return params, books


@pytest.mark.parametrize("half", [True, "auto", False])
def test_linear_state_dict_matches(half):
    params, books = _params_and_books()
    jstate = jcoding.linear_state_dict(
        params, [JBook(centroids=b[1], labels=b[0]) if b else None for b in books], half=half)
    tparams = [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in params]
    tbooks = [TBook(centroids=torch.from_numpy(b[1]), labels=torch.from_numpy(b[0]))
              if b else None for b in books]
    tstate = tcoding.linear_state_dict(tparams, tbooks, half=half)
    assert list(tstate) == list(jstate)
    for k in jstate:
        assert tstate[k].dtype == jstate[k].dtype
        np.testing.assert_array_equal(tstate[k], jstate[k])


@pytest.mark.parametrize("half", [True, "auto", False])
def test_container_bytes_identical_and_cross_decodable(tmp_path, half):
    params, books = _params_and_books(seed=1)
    state = jcoding.linear_state_dict(
        params, [JBook(centroids=b[1], labels=b[0]) if b else None for b in books], half=half)
    nj = jcoding.compress_state_dict(state, tmp_path / "jax", "plain")
    nt = tcoding.compress_state_dict(state, tmp_path / "torch", "plain")
    assert nj == nt == sum(a.nbytes for a in state.values())
    for name in ("compressed_weights.data", "meta_data.json"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()
    for reader_dir, writer_dir in (("torch", "jax"), ("jax", "torch")):
        t = tcoding.decompress_state_dict(tmp_path / writer_dir, "plain")
        j = jcoding.decompress_state_dict(tmp_path / reader_dir, "plain")
        assert list(t) == list(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])


def test_params_from_state_dict_round_trip():
    params, _ = _params_and_books(seed=2)
    state = OrderedDict(
        (f"layers.{i}.{name}", layer[k]) for i, layer in enumerate(params)
        for k, name in (("w", "weight"), ("b", "bias")))
    back = tcoding.params_from_state_dict(state)
    for a, b in zip(back, params):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k].numpy(), b[k])


@pytest.mark.parametrize("stream", ["zstd", "lzma", "auto"])
def test_unported_streams_raise(tmp_path, stream):
    """These streams round-trip now (the name dates from before their
    port): the same bytes as the JAX package's, decoded by both."""
    state = {"layers.0.bias": np.linspace(-1, 1, 37, dtype=np.float32),
             "layers.1.labeled_weight": np.arange(64, dtype=np.uint8).reshape(8, 8)}
    nt = tcoding.compress_state_dict(state, tmp_path / "torch", stream)
    nj = jcoding.compress_state_dict(state, tmp_path / "jax", stream)
    assert nt == nj
    assert ((tmp_path / "torch" / "compressed_weights.data").read_bytes()
            == (tmp_path / "jax" / "compressed_weights.data").read_bytes())
    for reader in (tcoding.read_raw_container, jcoding.read_raw_container):
        back = reader(tmp_path / "torch", stream)
        for k, v in state.items():
            np.testing.assert_array_equal(back[k], v)


def test_other_container_formats_raise(tmp_path):
    """Format 2 (the name dates from before its port) written by the JAX
    package decodes in the port."""
    from implicit_image_tpu import coding as jc

    state = {"layers.0.bias": np.arange(3, dtype=np.float32)}
    jc.compress_state_dict(state, tmp_path, "plain", plane_group=False)
    np.testing.assert_array_equal(tcoding.decompress_state_dict(tmp_path, "plain")
                                  ["layers.0.bias"], state["layers.0.bias"])


def _delta_setup(tmp_path, seed=3):
    """A meta-init artifact written by the JAX package, fit params near it,
    residual codebooks for the hidden layers and the delta manifest entry."""
    from implicit_image_tpu.models import build_model as jbuild
    from implicit_image_tpu.training.metainit import save_meta_init

    rng = np.random.default_rng(seed)
    init, _ = _params_and_books(seed=seed)
    save_meta_init(tmp_path / "meta.npz", init, "siren", jbuild("siren", depth=4, hidden_size=16)[1])
    params = [{k: (v + rng.normal(0, 1e-3, v.shape)).astype(np.float32) for k, v in layer.items()}
              for layer in init]
    books = [None] + [
        (rng.integers(0, 16, layer["w"].shape).astype(np.int32),
         np.concatenate([[0.0], np.sort(rng.normal(0, 1e-3, 15))]).astype(np.float32))
        for layer in init[1:-1]] + [None]
    state = jcoding.linear_state_dict(
        params, [JBook(centroids=b[1], labels=b[0]) if b else None for b in books], half="auto")
    import hashlib

    delta = {"artifact": str(tmp_path / "meta.npz"),
             "sha256": hashlib.sha256((tmp_path / "meta.npz").read_bytes()).hexdigest(),
             "layers": [i for i, b in enumerate(books) if b is not None]}
    return init, state, delta


@pytest.mark.parametrize("xor", [False, True])
@pytest.mark.parametrize("layout", [dict(), dict(plane_group=False), dict(shuffle=False)])
@pytest.mark.parametrize("stream", ["plain", "auto"])
def test_containers_decode_across_packages(tmp_path, layout, xor, stream):
    """Formats 3, 2 and 1, absolute or delta (with or without the XOR
    residual): both packages write the same bytes and manifest, and each
    decodes the other's container to identical arrays."""
    init, state, delta = _delta_setup(tmp_path)
    if xor:
        ref = tcoding.state_ref_map([{k: torch.from_numpy(v) for k, v in layer.items()}
                                     for layer in init])
        jstate, jx = jcoding.apply_xor_residual(state, jcoding.state_ref_map(init))
        state, tx = tcoding.apply_xor_residual(state, ref)
        assert tx == jx and len(tx) > 0
        for k in state:
            np.testing.assert_array_equal(state[k], jstate[k])
        delta = dict(delta, xor=tx)
    deltas = {"absolute": None, "delta": delta}
    for kind, d in deltas.items():
        tdir, jdir = tmp_path / f"t_{kind}", tmp_path / f"j_{kind}"
        nt = tcoding.compress_state_dict(state, tdir, stream, delta=d, **layout)
        nj = jcoding.compress_state_dict(state, jdir, stream, delta=d, **layout)
        assert nt == nj
        for name in ("compressed_weights.data", "meta_data.json"):
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
        if kind == "absolute" and xor:
            continue  # XORed tensors without the manifest entry decode as stored
        t = tcoding.decompress_state_dict(jdir, stream)
        j = jcoding.decompress_state_dict(tdir, stream)
        assert list(t) == list(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
        if kind == "delta":
            # w = (offset + centroids[labels]) * (labels != 0)
            raw = tcoding.read_raw_container(tdir, stream)
            i = delta["layers"][0]
            lab = raw[f"layers.{i}.labeled_weight"]
            want = (raw[f"layers.{i}.centroids"][lab].astype(np.float32) + init[i]["w"]) * (lab != 0)
            np.testing.assert_array_equal(t[f"layers.{i}.weight"], want.astype(np.float32))


def test_delta_artifact_sha256_and_search(tmp_path):
    """A wrong artifact raises; a missing one raises; `delta_artifact`
    overrides where it is looked for."""
    init, state, delta = _delta_setup(tmp_path, seed=4)
    tcoding.compress_state_dict(state, tmp_path / "c", "plain", delta=delta)
    moved = tmp_path / "elsewhere.npz"
    (tmp_path / "meta.npz").rename(moved)
    with pytest.raises(FileNotFoundError):
        tcoding.decompress_state_dict(tmp_path / "c", "plain")
    good = tcoding.decompress_state_dict(tmp_path / "c", "plain", delta_artifact=moved)
    j = jcoding.decompress_state_dict(tmp_path / "c", "plain", delta_artifact=moved)
    for k in j:
        np.testing.assert_array_equal(good[k], j[k])
    data = dict(np.load(moved))
    data["params.1.w"] = data["params.1.w"] + 1.0
    np.savez(tmp_path / "meta.npz", **data)
    with pytest.raises(ValueError, match="sha256"):
        tcoding.decompress_state_dict(tmp_path / "c", "plain")


def test_unported_containers_raise(tmp_path):
    """Inter-frame (`prev`) deltas are ported: a chain whose previous payload
    changed raises ValueError (sha256) and one whose previous frame is gone
    FileNotFoundError, in both packages. Format 4 (progressive) is ported:
    a JAX-written one reads to the JAX package's arrays."""
    state = {"layers.0.bias": np.arange(3, dtype=np.float32)}
    tcoding.compress_state_dict(state, tmp_path / "f0", "plain")
    sha = hashlib.sha256((tmp_path / "f0" / "compressed_weights.data").read_bytes()).hexdigest()
    delta = {"prev": "../f0", "sha256": sha, "layers": [], "xor": ["layers.0.bias"]}
    xored, _ = tcoding.apply_xor_residual({"layers.0.bias": state["layers.0.bias"] + 1},
                                          state)
    tcoding.compress_state_dict(xored, tmp_path / "p1", "plain", delta=delta)
    assert (json.loads((tmp_path / "p1" / "meta_data.json").read_text())["__meta__"]["delta"]
            == {**delta, "stream": "plain"})
    for coding in (tcoding, jcoding):
        np.testing.assert_array_equal(
            coding.decompress_state_dict(tmp_path / "p1", "plain")["layers.0.bias"],
            state["layers.0.bias"] + 1)
    (tmp_path / "f0" / "compressed_weights.data").write_bytes(b"\0" * 12)
    for coding in (tcoding, jcoding):
        with pytest.raises(ValueError, match="sha256 mismatch"):
            coding.decompress_state_dict(tmp_path / "p1", "plain")
    (tmp_path / "f0" / "compressed_weights.data").unlink()
    for coding in (tcoding, jcoding):
        with pytest.raises(FileNotFoundError, match="previous frame"):
            coding.decompress_state_dict(tmp_path / "p1", "plain")
    from implicit_image_tpu.coding.progressive import compress_progressive

    compress_progressive(state, tmp_path / "f4", "plain")
    np.testing.assert_array_equal(tcoding.read_raw_container(tmp_path / "f4", "plain")
                                  ["layers.0.bias"], state["layers.0.bias"])


def test_truncated_plain_stream_raises(tmp_path):
    state = {"layers.0.bias": np.arange(4, dtype=np.float32)}
    tcoding.compress_state_dict(state, tmp_path, "plain")
    data = tmp_path / "compressed_weights.data"
    data.write_bytes(data.read_bytes()[:-1])
    with pytest.raises(ValueError):
        tcoding.decompress_state_dict(tmp_path, "plain")


@pytest.mark.parametrize("edit", [None, "cut", "append"])
def test_jax_range_container_decodes_in_the_port(tmp_path, edit):
    """A container the JAX package writes with the `range` stream decodes in
    the port to the weights it holds; cut by one byte or with one byte
    appended, it raises ValueError."""
    params, books = _params_and_books(seed=3)
    state = jcoding.linear_state_dict(
        params, [JBook(centroids=b[1], labels=b[0]) if b else None for b in books], half="auto")
    jcoding.compress_state_dict(state, tmp_path, "range")
    want = jcoding.decompress_state_dict(tmp_path, "range")
    data = tmp_path / "compressed_weights.data"
    if edit is None:
        got = tcoding.decompress_state_dict(tmp_path, "range")
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        return
    blob = data.read_bytes()
    data.write_bytes(blob[:-1] if edit == "cut" else blob + b"\x01")
    with pytest.raises(ValueError):
        tcoding.decompress_state_dict(tmp_path, "range")
