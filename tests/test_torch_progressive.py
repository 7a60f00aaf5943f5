"""Port parity: the progressive (format-4) container and its base-layer
codebook finetune (coding/progressive.py, quant/base_layer.py).

For one numpy state dict both packages write the same bytes and the same
base prefix; a container written by either package, flat or delta, with or
without the `ctx_lo` grouping, decodes in the other to the same arrays,
full and base-only (exact); the port's full decode equals its flat decode
bit for bit. The base finetune: from one JAX fit's quantized state, both
packages' books agree within 1e-4 (absolute) after the same steps (the port
in its fp32 mode: JAX on the CPU computes fp32), and the base render's MSE
improves. Then the JAX package's own progressive tests, on the port.
"""
import hashlib
import json
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from implicit_image_tpu import coding as jcoding
from implicit_image_tpu import decompress as jdecompress
from implicit_image_tpu.coding import progressive as jprog
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.quant import QuantConfig as JQuant
from implicit_image_tpu.quant import quantize_weight as jquantize
from implicit_image_tpu.quant.base_layer import finetune_base_codebooks as j_finetune
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu.training.fit import fit as jfit
from implicit_image_tpu.training.metainit import save_meta_init
from implicit_image_tpu.training.quant_phase import make_quant_fit_fn
from implicit_image_tpu_torch import coding as tcoding
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch import decompress as tdecompress
from implicit_image_tpu_torch.coding import progressive as tprog
from implicit_image_tpu_torch.data import get_grid
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.quant.base_layer import finetune_base_codebooks

torch.set_num_threads(1)


def _vq_state(seed=0, k=256, n=4096):
    """One flat-VQ uint8 label tensor (its centroids unsorted), one fp
    tensor, one fp16 bias."""
    rng = np.random.default_rng(seed)
    centroids = np.sort(rng.normal(size=k).astype(np.float16))
    rng.shuffle(centroids)
    labels = rng.integers(0, k, size=(64, n // 64), dtype=np.uint8)
    return OrderedDict([
        ("layers.0.weight", rng.normal(size=(2, 16)).astype(np.float32)),
        ("layers.1.labeled_weight", labels),
        ("layers.1.centroids", centroids),
        ("layers.1.bias", rng.normal(size=16).astype(np.float16)),
    ])


def _delta_problem(tmp_path):
    """A sparse delta-quantized layer against a JAX-written meta-init
    artifact (the JAX package's own delta fixture)."""
    mdef, mcfg = jbuild("siren", depth=3, hidden_size=16)
    meta_params = mdef.init(jax.random.PRNGKey(5), mcfg)
    art = tmp_path / "meta.npz"
    save_meta_init(art, meta_params, mdef.name, mcfg)
    params = mdef.init(jax.random.PRNGKey(1), mcfg)
    rng = np.random.default_rng(0)
    w = np.asarray(params[1]["w"]).copy()
    w[rng.random(w.shape) < 0.4] = 0.0
    snapped, book = jquantize(w, bits=8, offset=meta_params[1]["w"])
    labels = np.asarray(book.labels).astype(np.uint8)
    state = OrderedDict([
        ("layers.0.weight", np.asarray(params[0]["w"], np.float32)),
        ("layers.1.labeled_weight", labels),
        ("layers.1.centroids", np.asarray(book.centroids, np.float32)),
        ("layers.2.weight", np.asarray(params[2]["w"], np.float32)),
    ])
    info = {"artifact": str(art), "sha256": hashlib.sha256(art.read_bytes()).hexdigest(),
            "layers": [1]}
    return state, info, np.asarray(snapped), labels


def _legacy_container(d, state, stream="zstd"):
    """A pre-ctx_lo format-4 container (the lo plane stored ungrouped, no
    flag), built as the JAX package's legacy test builds it."""
    book, labels = state["layers.1.centroids"], state["layers.1.labeled_weight"]
    order = np.argsort(book, kind="stable")
    rank_of = np.empty(book.size, np.uint8)
    rank_of[order] = np.arange(book.size, dtype=np.uint8)
    ranks = rank_of[labels]
    sorted_book = np.ascontiguousarray(book[order])
    counts = np.bincount(ranks.reshape(-1), minlength=book.size)
    base_book = np.empty(16, book.dtype)
    for g in range(16):
        c = counts[g * 16:(g + 1) * 16].astype(np.float64)
        v = sorted_book[g * 16:(g + 1) * 16].astype(np.float64)
        base_book[g] = (v * c).sum() / c.sum() if c.sum() else v.mean()
    base = OrderedDict([("layers.0.weight", state["layers.0.weight"]),
                        ("layers.1.labels_hi", (ranks >> 4).astype(np.uint8)),
                        ("layers.1.base_centroids", base_book),
                        ("layers.1.bias", state["layers.1.bias"])])
    refine = OrderedDict([("layers.1.labels_lo", (ranks & 15).astype(np.uint8)),
                          ("layers.1.centroids", sorted_book)])
    meta, i = OrderedDict(), 0
    for sec, entries in ((0, base), (1, refine)):
        for name, arr in entries.items():
            meta[str(i)] = {"shape": list(arr.shape), "dtype": str(arr.dtype), "name": name,
                            "sec": sec}
            i += 1
    base_blob = tcoding.encode_stream(stream, tcoding._plane_group_payload(list(base.values())))
    refine_blob = tcoding.encode_stream(stream,
                                        tcoding._plane_group_payload(list(refine.values())))
    meta["__meta__"] = {"format": 4, "plane_group": True, "shuffle": True,
                        "base_bytes": len(base_blob)}
    d.mkdir(parents=True)
    (d / "compressed_weights.data").write_bytes(base_blob + refine_blob)
    (d / "meta_data.json").write_text(json.dumps(meta, indent=2, sort_keys=True))
    return ranks


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in b:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("stream", ["zstd", "plain", "huffman"])
@pytest.mark.parametrize("kind", ["flat", "delta"])
def test_same_bytes_as_jax(tmp_path, kind, stream):
    if kind == "flat":
        state, info = _vq_state(seed=1), None
    else:
        state, info, _, _ = _delta_problem(tmp_path)
    nj = jprog.compress_progressive(state, tmp_path / "j", stream,
                                    delta=dict(info) if info else None)
    nt = tprog.compress_progressive(state, tmp_path / "t", stream,
                                    delta=dict(info) if info else None)
    assert nt == nj
    for name in ("compressed_weights.data", "meta_data.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert tprog.base_bytes(tmp_path / "t") == jprog.base_bytes(tmp_path / "j")
    assert 0 < tprog.base_bytes(tmp_path / "t") < nt


@pytest.mark.parametrize("base_only", [False, True])
@pytest.mark.parametrize("kind", ["flat", "delta", "legacy"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_decode(tmp_path, writer, kind, base_only):
    """A container written by either package (the legacy one has no
    ctx_lo flag) decodes in both to the same stored arrays and weights."""
    d = tmp_path / "c"
    if kind == "legacy":
        state = _vq_state(seed=7)
        _legacy_container(d, state)
    else:
        state, info = ((_vq_state(seed=2), None) if kind == "flat"
                       else _delta_problem(tmp_path)[:2])
        mod = jprog if writer == "jax" else tprog
        mod.compress_progressive(state, d, "zstd", delta=dict(info) if info else None)
    _assert_same(tcoding.read_raw_container(d, "zstd", base_only=base_only),
                 jcoding.read_raw_container(d, "zstd", base_only=base_only))
    _assert_same(tcoding.decompress_state_dict(d, "zstd", base_only=base_only),
                 jcoding.decompress_state_dict(d, "zstd", base_only=base_only))


@pytest.mark.parametrize("kind", ["flat", "delta"])
def test_full_decode_bit_exact_vs_flat(tmp_path, kind):
    if kind == "flat":
        state, info = _vq_state(), None
    else:
        state, info, snapped, labels = _delta_problem(tmp_path)
    tprog.compress_progressive(state, tmp_path / "prog", "zstd",
                               delta=dict(info) if info else None)
    tcoding.compress_state_dict(state, tmp_path / "flat", "zstd",
                                delta=dict(info) if info else None)
    full = tcoding.decompress_state_dict(tmp_path / "prog", "zstd")
    _assert_same(full, tcoding.decompress_state_dict(tmp_path / "flat", "zstd"))
    if kind == "delta":
        np.testing.assert_allclose(full["layers.1.weight"], snapped, atol=1e-6)
        assert (full["layers.1.weight"][labels == 0] == 0.0).all()


def test_base_decode_from_truncated_file(tmp_path):
    state = _vq_state()
    d = tmp_path / "prog"
    tprog.compress_progressive(state, d, "zstd")
    nbase = tprog.base_bytes(d)
    payload = (d / "compressed_weights.data").read_bytes()
    (d / "compressed_weights.data").write_bytes(payload[:nbase])
    base = tcoding.decompress_state_dict(d, "zstd", base_only=True)
    book = np.sort(state["layers.1.centroids"])
    w = base["layers.1.weight"]
    assert np.unique(w).size <= 16
    assert float(book[0]) - 1e-6 <= w.min() and w.max() <= float(book[-1]) + 1e-6
    np.testing.assert_array_equal(base["layers.0.weight"], state["layers.0.weight"])
    with pytest.raises(ValueError):
        tcoding.decompress_state_dict(d, "zstd")
    # and the truncated file's base decodes the same in the JAX package
    _assert_same(base, jcoding.decompress_state_dict(d, "zstd", base_only=True))


def test_delta_base_prefix_keeps_pruned_zero(tmp_path):
    state, info, snapped, labels = _delta_problem(tmp_path)
    d = tmp_path / "prog"
    total = tprog.compress_progressive(state, d, "zstd", delta=dict(info))
    nbase = tprog.base_bytes(d)
    assert 0 < nbase < total
    blob = (d / "compressed_weights.data").read_bytes()
    (d / "compressed_weights.data").write_bytes(blob[:nbase])
    wb = tcoding.decompress_state_dict(d, "zstd", base_only=True)["layers.1.weight"]
    assert np.isfinite(wb).all() and (wb[labels == 0] == 0.0).all()
    nz = (wb != 0) & (snapped != 0)
    assert nz.sum() > 0.5 * (snapped != 0).sum()
    assert np.corrcoef(wb[nz], snapped[nz])[0, 1] > 0.9


def test_base_quality_below_full(tmp_path):
    state = _vq_state(seed=3)
    d = tmp_path / "prog"
    tprog.compress_progressive(state, d, "zstd")
    true_w = state["layers.1.centroids"][state["layers.1.labeled_weight"]].astype(np.float64)
    full = tcoding.decompress_state_dict(d, "zstd")["layers.1.weight"]
    base = tcoding.decompress_state_dict(d, "zstd", base_only=True)["layers.1.weight"]
    assert np.mean((full - true_w) ** 2) == 0.0
    assert np.mean((base - true_w) ** 2) > 0.0


def test_uint16_and_qscale_tensors_stay_unsplit(tmp_path):
    rng = np.random.default_rng(0)
    state = OrderedDict([
        ("layers.0.labeled_weight", rng.integers(0, 300, (8, 8)).astype(np.uint16)),
        ("layers.0.centroids", rng.normal(size=300).astype(np.float16)),
        ("layers.1.labeled_weight", rng.integers(-127, 127, (4, 4)).astype(np.int8)),
        ("layers.1.qscale", rng.random(4).astype(np.float16)),
    ])
    d = tmp_path / "prog"
    tprog.compress_progressive(state, d, "zstd")
    meta = json.loads((d / "meta_data.json").read_text())
    assert all(v["sec"] == 0 for k, v in meta.items() if k != "__meta__")
    _assert_same(tcoding.read_raw_container(d, "zstd"), state)


def test_ctx_lo_grouping_round_trips_peaked_labels(tmp_path):
    rng = np.random.default_rng(11)
    centroids = rng.normal(size=256).astype(np.float16)
    labels = np.clip(rng.normal(64, 12, size=(128, 64)), 0, 255).astype(np.uint8)
    state = OrderedDict([("layers.1.labeled_weight", labels), ("layers.1.centroids", centroids)])
    d = tmp_path / "prog"
    tprog.compress_progressive(state, d, "zstd")
    assert json.loads((d / "meta_data.json").read_text())["__meta__"]["ctx_lo"] is True
    full = tprog.read_progressive(d, "zstd")
    np.testing.assert_array_equal(full["layers.1.centroids"][full["layers.1.labeled_weight"]],
                                  centroids[labels])


def test_base_finetune_validation(tmp_path):
    state = _vq_state()
    with pytest.raises(ValueError, match="base_centroids"):
        tprog.compress_progressive(state, tmp_path / "x", "zstd",
                                   base_finetune=lambda e: {"layers.1.labels_hi": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tprog.compress_progressive(
            state, tmp_path / "y", "zstd",
            base_finetune=lambda e: {"layers.1.base_centroids": np.zeros(3, np.float16)})


# ---- the base-layer finetune ----

SIDE = 24


@pytest.fixture(scope="module")
def quantized():
    """A JAX fit and codebook finetune (d4/w16, 24²), its half=auto state."""
    mdef, mcfg = jbuild("siren", depth=4, hidden_size=16)
    grid = jgrid(SIDE, SIDE)
    img = synthetic_image(SIDE, SIDE, seed=1, complexity=3)
    res = jfit(jax.random.PRNGKey(0), mdef, mcfg, grid, img, JTrain(num_steps=60, log_steps=60),
               JOptim())
    qfn = jax.jit(make_quant_fit_fn(mdef, mcfg, grid,
                                    JQuant(name="KMeans", bits=8, num_steps=3, log_steps=3),
                                    JOptim(), None))
    params_q, books, _ = qfn(res.params, img)
    return img, jcoding.linear_state_dict(params_q, books, half="auto")


def _base_render_mse(state, base_ft, d, img):
    tprog.compress_progressive(dict(state), d, "zstd", base_finetune=base_ft)
    dec = tcoding.decompress_state_dict(d, "zstd", base_only=True)
    mdef, mcfg = build_model("siren", depth=4, hidden_size=16)
    pred = mdef.apply(tcoding.params_from_state_dict(dec), get_grid(SIDE, SIDE), mcfg, "fp32")
    return float(np.mean((pred.detach().numpy().astype(np.float64) - img) ** 2))


@pytest.mark.parametrize("steps", [1, 25])
def test_base_finetune_matches_jax(quantized, steps):
    img, state = quantized
    base, _ = jprog._split_entries(state)
    jmdef, jmcfg = jbuild("siren", depth=4, hidden_size=16)
    jbooks = j_finetune(jmdef, jmcfg, jgrid(SIDE, SIDE), img, base, steps=steps)
    mdef, mcfg = build_model("siren", depth=4, hidden_size=16)
    tbooks = finetune_base_codebooks(mdef, mcfg, get_grid(SIDE, SIDE), img, base, steps=steps,
                                     precision="fp32")
    assert sorted(tbooks) == sorted(jbooks) == ["layers.1.base_centroids",
                                                "layers.2.base_centroids"]
    for name, jb in jbooks.items():
        assert tbooks[name].dtype == jb.dtype == np.float16
        np.testing.assert_allclose(tbooks[name].astype(np.float32), jb.astype(np.float32),
                                   rtol=0, atol=1e-4)
        assert not np.array_equal(tbooks[name], base[name])  # the books moved


def test_base_finetune_improves_base_render_and_keeps_full_stream(quantized, tmp_path):
    img, state = quantized
    mdef, mcfg = build_model("siren", depth=4, hidden_size=16)

    def ft(entries):
        return finetune_base_codebooks(mdef, mcfg, get_grid(SIDE, SIDE), img, entries,
                                       steps=60, precision="fp32")

    assert (_base_render_mse(state, ft, tmp_path / "ft", img)
            < _base_render_mse(state, None, tmp_path / "plain", img))
    _assert_same(tcoding.decompress_state_dict(tmp_path / "ft", "zstd"),
                 tcoding.decompress_state_dict(tmp_path / "plain", "zstd"))


def test_delta_base_finetune_matches_jax(tmp_path):
    """Residual books against the base decode's rule w = (book[hi] + offset)
    * (hi != 0), in both packages."""
    state, info, _, _ = _delta_problem(tmp_path)
    state["layers.0.bias"] = np.zeros(16, np.float32)
    state["layers.1.bias"] = np.zeros(16, np.float32)
    state["layers.2.bias"] = np.zeros(3, np.float32)
    state = OrderedDict(sorted(state.items(), key=lambda kv: (int(kv[0].split(".")[1]),
                                                              kv[0])))
    img = synthetic_image(16, 16, seed=2, complexity=2)
    base, _ = jprog._split_entries(state, pinned_layers=frozenset([1]))
    offsets = {1: np.asarray(np.load(info["artifact"])["params.1.w"], np.float32)}
    jmdef, jmcfg = jbuild("siren", depth=3, hidden_size=16)
    jbooks = j_finetune(jmdef, jmcfg, jgrid(16, 16), img, base, steps=10, delta_layers=[1],
                        delta_offsets=offsets)
    mdef, mcfg = build_model("siren", depth=3, hidden_size=16)
    tbooks = finetune_base_codebooks(mdef, mcfg, get_grid(16, 16), img, base, steps=10,
                                     delta_layers=[1], delta_offsets=offsets, precision="fp32")
    np.testing.assert_allclose(tbooks["layers.1.base_centroids"],
                               jbooks["layers.1.base_centroids"], rtol=0, atol=1e-4)


# ---- through compress.main and the decoders ----

RUN = ["img=synthetic", "img.height=24", "img.width=24", "mlp.depth=3", "mlp.hidden_size=16",
       "train.num_steps=20", "train.log_steps=20", "masking=none", "quant=kmeans",
       "quant.num_steps=2", "entropy_coding=zstd", "entropy_coding.progressive=true",
       "device=cpu"]


@pytest.mark.parametrize("base_finetune", [True, False])
def test_cli_progressive_round_trip_across_packages(tmp_path, base_finetune):
    run = tmp_path / "run"
    psnr, nbytes = tcompress.main(tcompress.compose(
        RUN + [f"entropy_coding.base_finetune={str(base_finetune).lower()}"]), run_dir=str(run))
    assert np.isfinite(psnr) and nbytes > 0
    hdr = json.loads((run / "model_quantized" / "meta_data.json").read_text())["__meta__"]
    assert hdr["format"] == 4 and hdr["ctx_lo"] is True
    summary = json.loads((run / "summary.json").read_text())
    assert summary["base_bytes"] == hdr["base_bytes"]
    assert ("base_finetune_wall_s" in summary) == base_finetune
    full, _ = tdecompress.decode_run(run, device="cpu")
    base, stats = tdecompress.decode_run(run, device="cpu", base=True)
    assert stats["out"].endswith("decoded_base.png")
    assert base.shape == full.shape and not np.allclose(base, full)
    for ours, kw in ((full, {}), (base, {"base": True})):
        theirs, _ = jdecompress.decode_run(run, out_path=tmp_path / "j.png", **kw)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-5)


def test_cli_delta_progressive_round_trip(tmp_path):
    mdef, mcfg = jbuild("siren", depth=3, hidden_size=16)
    art = tmp_path / "meta.npz"
    save_meta_init(art, mdef.init(jax.random.PRNGKey(5), mcfg), mdef.name, mcfg)
    run = tmp_path / "run"
    psnr, nbytes = tcompress.main(tcompress.compose(
        [o for o in RUN if o != "masking=none"]
        + ["masking=RigL", "masking.density=0.5", "quant.delta=true", "train.num_steps=5",
           f"train.init_path={art}"]), run_dir=str(run))
    assert np.isfinite(psnr) and nbytes > 0
    hdr = json.loads((run / "model_quantized" / "meta_data.json").read_text())["__meta__"]
    assert hdr["format"] == 4 and "delta" in hdr and 0 < hdr["base_bytes"] < nbytes
    full, _ = tdecompress.decode_run(run, device="cpu")
    summary = json.loads((run / "summary.json").read_text())
    target = tcompress._load_image(tcompress.compose(RUN).img)
    assert 10 * np.log10(1 / np.mean((full.astype(np.float64) - target) ** 2)) == pytest.approx(
        summary["Decoded PSNR"], abs=1e-6)
    base, _ = tdecompress.decode_run(run, device="cpu", base=True)
    assert np.isfinite(base).all()
    theirs, _ = jdecompress.decode_run(run, out_path=tmp_path / "j.png", base=True)
    np.testing.assert_allclose(base, np.asarray(theirs), rtol=0, atol=1e-5)
