"""Port parity: QAT (quant/uniform.py, the STE finetune of
training/quant_phase.py, its containers).

Tolerances:
  * the fake quantizers and the snap, from the same numpy weights: the
    codes, scales, zero points and snapped weights equal those of JAX's
    compiled functions exactly (both round half to even, and the port
    multiplies by the fp32 reciprocal where XLA rewrites a division by a
    constant); JAX's op-by-op functions divide, so their scales lie within
    1 ulp;
  * torch.fake_quantize_per_channel_affine: the JAX test's rule (the scales
    within 1e-6 relative; the outputs equal but at half-way boundary
    elements, there one step apart), with under 1% of elements at a
    boundary where the JAX test allows 0.5%: torch divides by the scale
    and multiplies by its reciprocal, the port (as XLA's compiled
    programs) takes the scale one ulp off at times;
  * the observer over 3 batches within 1e-6 relative;
  * the STE's latent gradient within 1e-5 of the largest JAX gradient (the
    fp32 parity bound of the chain's gradients);
  * a 5-step finetune from one copied state: its losses within 1e-4
    relative (the fused chain's forward parity); the latent weights move by a
    few Adam steps of 1e-3, so codes may flip only where JAX's latent sits
    within rounding of a half-way point: at most 0.5% of codes differ, by
    one, and the snapped weights within one quantization step of JAX's;
    where the codes agree, within 1e-5 of the layer's largest weight (the
    scales follow the latent's range, a few Adam steps apart in the last
    bits);
  * containers: decoded weights bit for bit across packages, both ways,
    flat and progressive.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import coding as jcoding
from implicit_image_tpu.coding import progressive as jprog
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.quant import QuantConfig as JQuant
from implicit_image_tpu.quant import convert as j_convert
from implicit_image_tpu.quant import quantize_params as j_quantize_params
from implicit_image_tpu.quant import uniform as jq
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.quant_phase import quant_finetune as j_finetune
from implicit_image_tpu_torch import coding as tcoding
from implicit_image_tpu_torch.coding import progressive as tprog
from implicit_image_tpu_torch.convert import params_from_jax
from implicit_image_tpu_torch.data import get_grid, synthetic_image
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.parallel import ladder
from implicit_image_tpu_torch.quant import QuantConfig, convert, uniform as tq
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, make_grad_fn
from implicit_image_tpu_torch.training.quant_phase import _ste, quant_finetune

torch.set_num_threads(1)

SIDE = 16


def _w(seed=0, shape=(24, 20), zeros=0.0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * rng.uniform(0.05, 0.5, size=shape[1])).astype(np.float32)
    w[rng.uniform(size=shape) < zeros] = 0.0
    return w


def _ulp_close(a, b, ulps=1):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert (np.abs(a - b) <= ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))).all(), (
        np.abs(a - b).max())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed,zeros", [(0, 0.0), (1, 0.3)])
def test_per_channel_functions_match_jax(bits, seed, zeros):
    w = _w(seed, zeros=zeros)
    js, jqmax = jax.jit(lambda x: jq._per_channel_qparams(x, bits))(jnp.asarray(w))
    ts, tqmax = tq._per_channel_qparams(torch.from_numpy(w), bits)
    assert tqmax == jqmax
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _ulp_close(ts.numpy(), jq._per_channel_qparams(jnp.asarray(w), bits)[0])
    jsnap, jbook = jax.jit(lambda x: jq.per_channel_quantize_weight(x, bits))(jnp.asarray(w))
    tsnap, tbook = tq.per_channel_quantize_weight(torch.from_numpy(w), bits)
    assert tbook.codes.dtype == torch.int8
    np.testing.assert_array_equal(tbook.codes.numpy(), np.asarray(jbook.codes))
    np.testing.assert_array_equal(tbook.scales.numpy(), np.asarray(jbook.scales))
    np.testing.assert_array_equal(tsnap.numpy(), np.asarray(jsnap))
    np.testing.assert_array_equal(
        tq.fake_quant_per_channel(torch.from_numpy(w), bits).numpy(),
        np.asarray(jax.jit(lambda x: jq.fake_quant_per_channel(x, bits))(jnp.asarray(w))))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed,shift", [(0, 0.0), (1, 0.2), (2, -0.3)])
def test_per_tensor_functions_match_jax(bits, seed, shift):
    """Ranges straddling 0 and one-signed (the range is widened to hold 0)."""
    w = _w(seed) + np.float32(shift)
    jscale, jzp, jqmax = jax.jit(lambda x: jq._qparams(x, bits)[:2] + (0.0,))(jnp.asarray(w))
    tscale, tzp, tqmax = tq._qparams(torch.from_numpy(w), bits)
    assert tqmax == float(2**bits - 1) and float(tzp) == float(jzp)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    _ulp_close(tscale.numpy(), jq._qparams(jnp.asarray(w), bits)[0])
    jsnap, jbook = jax.jit(lambda x: jq.uniform_quantize_weight(x, bits))(jnp.asarray(w))
    tsnap, tbook = tq.uniform_quantize_weight(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(tbook.labels.numpy(), np.asarray(jbook.labels))
    assert tbook.centroids.shape == (2**bits,)
    np.testing.assert_array_equal(tbook.centroids.numpy(), np.asarray(jbook.centroids))
    np.testing.assert_array_equal(tsnap.numpy(), np.asarray(jsnap))
    np.testing.assert_array_equal(
        tq.fake_quant(torch.from_numpy(w), bits).numpy(),
        np.asarray(jax.jit(lambda x: jq.fake_quant(x, bits))(jnp.asarray(w))))


def test_fake_quant_gradients_are_straight_through():
    w = torch.from_numpy(_w(3)).requires_grad_(True)
    for fn in (tq.fake_quant, tq.fake_quant_per_channel):
        (g,) = torch.autograd.grad(fn(w, 8).sum(), w)
        assert torch.equal(g, torch.ones_like(g))


def test_per_channel_fake_quant_matches_torch_fbgemm():
    """fbgemm's weight scheme: the scales equal MovingAveragePerChannel-
    MinMaxObserver's qparams, the outputs torch's fake_quantize_per_channel_
    affine but at half-way boundary elements."""
    torch.manual_seed(0)
    w_t = torch.randn(64, 96) * 0.3  # (out, in), torch's layout
    obs = torch.ao.quantization.MovingAveragePerChannelMinMaxObserver(
        averaging_constant=0.01, ch_axis=0, dtype=torch.qint8,
        qscheme=torch.per_channel_symmetric)
    obs(w_t)
    scales_t, zps_t = obs.calculate_qparams()
    fq_t = torch.fake_quantize_per_channel_affine(w_t, scales_t, zps_t.to(torch.int32), 0,
                                                  -128, 127).numpy()
    w = w_t.t().contiguous()  # (in, out), ours
    scales, _ = tq._per_channel_qparams(w, 8)
    np.testing.assert_allclose(scales.numpy(), scales_t.numpy(), rtol=1e-6)
    d = np.abs(tq.fake_quant_per_channel(w, 8).t().numpy() - fq_t)
    mismatched = d > 1e-7
    assert mismatched.mean() < 0.01
    step = np.repeat(scales_t.numpy()[:, None], 96, 1)
    assert (d[mismatched] <= step[mismatched] * 1.01).all()


def test_observer_matches_jax_over_three_batches():
    rng = np.random.default_rng(0)
    js, ts = jq.observer_init(), tq.observer_init()
    assert not bool(ts.initialized)
    for _ in range(3):
        x = (rng.standard_normal((32, 8)) * rng.uniform(0.5, 2)).astype(np.float32)
        js = jq.observe_minmax(js, jnp.asarray(x), 0.01)
        ts = tq.observe_minmax(ts, torch.from_numpy(x), 0.01)
        np.testing.assert_allclose(float(ts.min_val), float(js.min_val), rtol=1e-6)
        np.testing.assert_allclose(float(ts.max_val), float(js.max_val), rtol=1e-6)
    assert bool(ts.initialized)


def test_quant_config_qat():
    cfg = QuantConfig(name="QAT")
    assert cfg.qscheme == "per_channel"
    with pytest.raises(ValueError):
        QuantConfig(name="QAT", qscheme="per_row")


def _model(seed=0, depth=4, width=16):
    jm, jc = jbuild("siren", depth=depth, hidden_size=width)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jc))
    m, c = build_model("siren", depth=depth, hidden_size=width)
    return jm, jc, p, m, c


def _masks(p, density=0.6, seed=5):
    rng = np.random.default_rng(seed)
    out = [None] + [(rng.uniform(size=layer["w"].shape) < density).astype(np.float32)
                    for layer in p[1:-1]] + [None]
    return out


def _masked(p, masks):
    return tuple({**layer, "w": layer["w"] * m} if m is not None else layer
                 for layer, m in zip(p, masks))


@pytest.mark.parametrize("qscheme", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("masked", [False, True])
def test_ste_latent_gradient_matches_jax(qscheme, masked):
    """The gradient that reaches the latent weights through the snapped
    forward (K2 differentiates with respect to the snapped weights; the STE
    routes that to the latent), against jax.grad of JAX's STE transform."""
    jm, jc, p, m, c = _model(1)
    masks = _masks(p) if masked else [None] * len(p)
    p = _masked(p, masks)
    img = synthetic_image(SIDE, SIDE, seed=2)
    jcfg = JQuant(name="QAT", qscheme=qscheme)
    jmasks = [None if mk is None else jnp.asarray(mk) for mk in masks]

    def jloss(latent):
        snapped = j_quantize_params(latent, jcfg)
        ste = jax.tree_util.tree_map(
            lambda q, w: jax.lax.stop_gradient(q) + w - jax.lax.stop_gradient(w), snapped, latent)
        ste = tuple({**layer, "w": layer["w"] * mk} if mk is not None else layer
                    for layer, mk in zip(ste, jmasks))
        pred = jm.apply_flat(ste, jgrid(SIDE, SIDE).reshape(-1, 2), jc)
        return jnp.mean((pred - img.reshape(-1, 3)) ** 2)

    jg = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, p))
    tmasks = [None if mk is None else torch.from_numpy(mk) for mk in masks]
    latent = params_from_jax(p, "cpu")
    for layer in latent:
        for v in layer.values():
            v.requires_grad_(True)
    grad_fn = make_grad_fn(m, c, get_grid(SIDE, SIDE).reshape(-1, 2),
                           torch.from_numpy(img).reshape(-1, 3), "fp32",
                           transform=lambda lt: _ste(lt, QuantConfig(name="QAT", qscheme=qscheme),
                                                     tmasks))
    _, grads = grad_fn(latent)
    for i, layer in enumerate(grads):
        for k, g in layer.items():
            ref = np.asarray(jg[i][k])
            assert np.abs(g.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), (i, k)


def _finetune_pair(qscheme, masked, steps=5):
    jm, jc, p, m, c = _model(4)
    masks = _masks(p, seed=6) if masked else None
    if masks is not None:
        p = _masked(p, masks)
    img = synthetic_image(SIDE, SIDE, seed=3)
    jres = j_finetune(jax.tree.map(jnp.asarray, p), img, jm, jc, jgrid(SIDE, SIDE),
                      JQuant(name="QAT", qscheme=qscheme, num_steps=steps), JOptim(lr=1e-3),
                      masks=None if masks is None else [None if mk is None else jnp.asarray(mk)
                                                         for mk in masks])
    tres = quant_finetune(params_from_jax(p, "cpu"), img, m, c, get_grid(SIDE, SIDE),
                          QuantConfig(name="QAT", qscheme=qscheme, num_steps=steps),
                          OptimConfig(lr=1e-3), precision="fp32",
                          masks=None if masks is None else [
                              None if mk is None else torch.from_numpy(mk) for mk in masks])
    return jres, tres, masks


@pytest.mark.parametrize("qscheme", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("masked", [False, True])
def test_qat_finetune_matches_jax(qscheme, masked):
    jres, tres, masks = _finetune_pair(qscheme, masked)
    np.testing.assert_allclose(tres.metrics["loss"], np.asarray(jres.metrics["loss"]),
                               rtol=1e-4)
    assert abs(tres.metrics["quant_psnr"] - float(jres.metrics["quant_psnr"])) < 1e-3
    n_books = 0
    for i, (tb, jb) in enumerate(zip(tres.codebooks, jres.codebooks)):
        assert (tb is None) == (jb is None)
        if tb is None:
            continue
        n_books += 1
        codes_t = (tb.codes if qscheme == "per_channel" else tb.labels).numpy().astype(np.int64)
        codes_j = np.asarray(jb.codes if qscheme == "per_channel" else jb.labels, np.int64)
        diff = codes_t != codes_j
        assert diff.mean() <= 0.005 and (np.abs(codes_t - codes_j)[diff] <= 1).all()
        tw, jw = tres.params[i]["w"].numpy(), np.asarray(jres.params[i]["w"])
        step = (tb.scales.numpy()[None, :] if qscheme == "per_channel"
                else np.float32(tb.centroids[1] - tb.centroids[0]))
        assert (np.abs(tw - jw) <= 1.01 * np.broadcast_to(step, tw.shape)).all()
        assert np.abs(tw - jw)[~diff].max() <= 1e-5 * np.abs(jw).max()
        if masks is not None and masks[i] is not None:
            assert not tw[masks[i] == 0].any()  # pruned weights stay exactly 0
    assert n_books == 2


def _qat_state(qscheme, seed=0):
    jm, jc, p, m, c = _model(seed, width=32)
    # compiled, as the JAX package's finetune converts
    jq_params, jbooks = jax.jit(lambda q: j_convert(q, JQuant(name="QAT", qscheme=qscheme)))(
        jax.tree.map(jnp.asarray, p))
    tq_params, tbooks = convert(params_from_jax(p, "cpu"), QuantConfig(name="QAT", qscheme=qscheme))
    return (jq_params, jbooks), (tq_params, tbooks)


@pytest.mark.parametrize("qscheme", ["per_channel", "per_tensor"])
def test_same_state_dict_as_jax(qscheme):
    (jp, jb), (tp, tb) = _qat_state(qscheme)
    js = jcoding.linear_state_dict(jp, jb, half="auto")
    ts = tcoding.linear_state_dict(tp, tb, half="auto")
    assert list(ts) == list(js)
    for k in ts:
        assert ts[k].dtype == js[k].dtype, k
        np.testing.assert_array_equal(ts[k], js[k])
    names = [k for k in ts if k.startswith("layers.1.")]
    if qscheme == "per_channel":
        assert ts["layers.1.labeled_weight"].dtype == np.int8 and "layers.1.qscale" in ts
    else:
        assert ts["layers.1.centroids"].shape == (256,) and "layers.1.qscale" not in names


@pytest.mark.parametrize("qscheme", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("progressive", [False, True])
def test_containers_decode_across_packages(tmp_path, qscheme, writer, progressive):
    """A QAT container written by either package (flat, or the progressive
    format 4) decodes in the other to the same weights bit for bit, and
    those are the snapped params (codes * scales per channel)."""
    (jp, jb), (tp, tb) = _qat_state(qscheme, seed=1)
    d = tmp_path / "c"
    if writer == "jax":
        state = jcoding.linear_state_dict(jp, jb, half="auto")
        (jprog.compress_progressive if progressive else jcoding.compress_state_dict)(
            state, d, "zstd")
    else:
        state = tcoding.linear_state_dict(tp, tb, half="auto")
        (tprog.compress_progressive if progressive else tcoding.compress_state_dict)(
            state, d, "zstd")
    ours = tcoding.decompress_state_dict(d, "zstd")
    theirs = jcoding.decompress_state_dict(d, "zstd")
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
    for i, book in enumerate(tb):
        if book is None:
            continue
        if qscheme == "per_channel":
            expect = book.codes.numpy().astype(np.float32) * book.scales.numpy().astype(
                np.float16).astype(np.float32)
        else:
            expect = book.centroids.numpy().astype(np.float16).astype(np.float32)[
                book.labels.numpy()]
        np.testing.assert_array_equal(ours[f"layers.{i}.weight"], expect)


def test_qat_ladder_containers_decode_in_both_packages(tmp_path):
    """ladder_compress with quant=qat: each member's finetune is the single
    QAT finetune, and its container decodes in both packages to the same
    weights and renders to the same image."""
    m, c = build_model("siren", depth=3, hidden_size=32)
    jm, jc = jbuild("siren", depth=3, hidden_size=32)
    img = synthetic_image(SIDE, SIDE, seed=1)
    results = ladder.ladder_compress(
        torch.Generator().manual_seed(0), m, c, get_grid(SIDE, SIDE), img,
        TrainConfig(num_steps=20, log_steps=10), OptimConfig(lr=1e-3),
        MaskingConfig(density=0.5, end_when=10, interval=5), [0.3, 0.8],
        quant_cfg=QuantConfig(name="QAT", num_steps=5), stream_name="zstd",
        stream_root=str(tmp_path / "ladder"), device="cpu")
    assert len(results) == 2
    for r in results:
        container = f"{r.stream_dir}/model_quantized"
        ours = tcoding.decompress_state_dict(container, "zstd")
        theirs = jcoding.decompress_state_dict(container, "zstd")
        assert any(k.endswith(".qscale") for k in tcoding.read_raw_container(container, "zstd"))
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
        j_img, _ = jcoding.decode_and_render(container, "zstd", jm, jc, SIDE, SIDE,
                                             benchmark=False)
        t_img, _ = tcoding.decode_and_render(container, "zstd", m, c, SIDE, SIDE, device="cpu")
        np.testing.assert_allclose(np.asarray(j_img), t_img, atol=2e-5)
        assert abs(r.decoded_psnr - r.quant_psnr) < 0.5


@pytest.mark.parametrize("layout", ["per_tensor", "per_channel_frozen"])
def test_base_finetune_over_qat_state_matches_jax(layout):
    """The progressive container's base finetune over a QAT state: per
    tensor, the 256-entry codebooks split into base books that train; per
    channel, the int8 codes times their scales stay frozen (here beside a
    k-means layer whose base book trains). The port in its fp32 mode
    against the JAX package on the CPU, the books within 1e-4 (the
    progressive base finetune's parity bound, test_torch_progressive.py)."""
    from implicit_image_tpu.quant.base_layer import finetune_base_codebooks as j_base_ft
    from implicit_image_tpu.quant.kmeans import quantize_weight as j_kmeans
    from implicit_image_tpu_torch.quant.base_layer import finetune_base_codebooks

    (jp, jb), _ = _qat_state("per_tensor" if layout == "per_tensor" else "per_channel", seed=2)
    jb = list(jb)
    if layout == "per_channel_frozen":
        jp = list(jp)
        snapped, book = j_kmeans(jp[2]["w"], 8)
        jp[2], jb[2] = {**jp[2], "w": snapped}, book
    state = jcoding.linear_state_dict(tuple(jp), tuple(jb), half="auto")
    base, _ = jprog._split_entries(state)
    img = synthetic_image(SIDE, SIDE, seed=4)
    jm, jc = jbuild("siren", depth=4, hidden_size=32)
    m, c = build_model("siren", depth=4, hidden_size=32)
    jbooks = j_base_ft(jm, jc, jgrid(SIDE, SIDE), img, base, steps=10)
    tbooks = finetune_base_codebooks(m, c, get_grid(SIDE, SIDE), img, base, steps=10,
                                     precision="fp32")
    expect = (["layers.1.base_centroids", "layers.2.base_centroids"] if layout == "per_tensor"
              else ["layers.2.base_centroids"])
    assert sorted(tbooks) == sorted(jbooks) == expect
    if layout == "per_channel_frozen":
        assert base["layers.1.labeled_weight"].dtype == np.int8 and "layers.1.qscale" in base
    for name, b in jbooks.items():
        np.testing.assert_allclose(tbooks[name].astype(np.float32), b.astype(np.float32),
                                   rtol=0, atol=1e-4)
        assert not np.array_equal(tbooks[name], base[name])
