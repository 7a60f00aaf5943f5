"""Port parity: sequence (video) coding (sequence.py) and the inter-frame
`prev` containers (coding).

The same inputs go through the JAX package (as tests/test_sequence.py runs
it, on the CPU) and the port (device="cpu", the plain versions):
- synthetic_video gives the same frames bit for bit;
- a chain written by either package (I+P+P, then I+P) decodes in the other
  to the writer's own decompress_state_dict arrays exactly, from the state
  just decoded and by the chain walk; each package's decode_sequence renders
  the other's seq dir, and its GOP seeks, within 1e-5 of its own;
- from one JAX-written meta-init artifact with masking=none nothing is
  drawn at random, so both packages' encode_sequence give the same kinds
  and steps, decoded PSNRs within 0.01 dB and bytes within 1% per frame;
- from one JAX-written sparse I-frame (RigL 0.5), the port's P-frame step
  and JAX's pieces (make_fit_segments under the resume masking at
  end_when=-1) give the same masks, P-fit params within 1e-5, and a decoded
  P-frame within 0.01 dB of the JAX package's own;
- the options of JAX's tests/test_sequence.py, on the port.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_image_tpu import coding as jcoding
from implicit_image_tpu import sequence as jseq
from implicit_image_tpu.data import synthetic_video as jvideo
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.training.metainit import save_meta_init
from implicit_image_tpu_torch import coding as tcoding
from implicit_image_tpu_torch import decompress as tdecompress
from implicit_image_tpu_torch import sequence as tseq
from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.data import save_img, stable_seed
from implicit_image_tpu_torch.data import synthetic_video as tvideo

torch.set_num_threads(1)

SEQ = [
    "img=synthetic", "img.height=24", "img.width=24",
    "mlp.depth=3", "mlp.hidden_size=16",
    "train.num_steps=20", "train.log_steps=20",
    "quant=kmeans", "quant.bits=4", "quant.num_steps=4", "quant.log_steps=4",
    "entropy_coding=zstd",
    "sequence.video=unittest", "sequence.frames=3",
    "sequence.steps0=20", "sequence.steps=6",
]
FRAMES = ["frame_0000", "frame_0001", "frame_0002", "frame_0003", "frame_0004"]


def _port(overrides):
    return tseq.encode_sequence(overrides, device="cpu")


def _db(img, ref) -> float:
    mse = float(np.mean((np.asarray(img, np.float64) - np.asarray(ref, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / mse)


def _meta(path):
    mdef, mcfg = jbuild("siren", depth=3, hidden_size=16, input_size=2, output_size=3)
    save_meta_init(path, mdef.init(jax.random.PRNGKey(5), mcfg), mdef.name, mcfg)
    return path


@pytest.mark.parametrize("h,w,frames,seed,motion", [
    (16, 20, 4, 3, 0.01), (24, 24, 3, stable_seed("unittest"), 0.01), (32, 16, 1, 0, 0.0),
    (12, 12, 6, 7, 0.5), (20, 28, 2, stable_seed("scenecut"), 0.02)])
def test_synthetic_video_is_jax_bit_for_bit(h, w, frames, seed, motion):
    ours = tvideo(h, w, frames=frames, seed=seed, motion=motion)
    theirs = jvideo(h, w, frames=frames, seed=seed, motion=motion)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


# ---- a dense sequence from one shared artifact, encoded by both packages ----

def _dense_pair(root):
    """Both packages' encode_sequence of 5 frames with an I-frame every 3
    (I P P I P), masking=none, warm from one JAX-written artifact: (JAX's
    seq dir, the port's, JAX's rows, the port's, the frames)."""
    art = _meta(root / "meta.npz")
    ov = SEQ + ["masking=none", f"train.init_path={art}", "sequence.frames=5",
                "sequence.gop=3"]
    jrows = jseq.encode_sequence(ov + [f"output_dir={root / 'jax'}"])
    trows = _port(ov + [f"output_dir={root / 'port'}"])
    frames = tvideo(24, 24, frames=5, seed=stable_seed("unittest"), motion=0.01)
    return root / "jax" / "seq_unittest", root / "port" / "seq_unittest", jrows, trows, frames


@pytest.fixture(scope="module")
def dense_pair(tmp_path_factory):
    return _dense_pair(tmp_path_factory.mktemp("dense"))


def _dense_gaps(pair):
    """Per frame: |decoded PSNR gap| (dB, each package's own decode) and
    the byte gap as a fraction of JAX's bytes."""
    jdir, tdir, jrows, trows, frames = pair
    jimgs, _ = jseq.decode_sequence(jdir)
    timgs, _ = tseq.decode_sequence(tdir, device="cpu")
    return [(abs(_db(timgs[t], frames[t]) - _db(np.asarray(jimgs[t]), frames[t])),
             abs(tr["bytes"] - jr["bytes"]) / jr["bytes"])
            for t, (jr, tr) in enumerate(zip(jrows, trows))]


def test_dense_encode_matches_jax(dense_pair):
    """Same kinds and steps; decoded PSNR (each package's own decode,
    unrounded) within 0.01 dB and bytes within 1% per frame."""
    jdir, tdir, jrows, trows, frames = dense_pair
    assert [r["kind"] for r in trows] == [r["kind"] for r in jrows] == ["I", "P", "P", "I", "P"]
    assert [r["steps"] for r in trows] == [r["steps"] for r in jrows] == [20, 6, 6, 20, 6]
    assert [r["frame"] for r in trows] == FRAMES
    for t, (db_gap, byte_gap) in enumerate(_dense_gaps(dense_pair)):
        assert db_gap <= 0.01 and byte_gap <= 0.01, (t, db_gap, byte_gap)
    summary = json.loads((tdir / "seq_summary.json").read_text())
    assert set(summary) == set(json.loads((jdir / "seq_summary.json").read_text()))
    assert summary["rows"] == trows and summary["gop"] == 3


def test_port_manifests_and_layout(dense_pair):
    """JAX's layout test on the port: every frame a run dir; P manifests
    record prev + the previous payload's sha256 (+ its stream); I-frames
    have no delta entry."""
    _, tdir, _, _, _ = dense_pair
    for name in FRAMES:
        for f in ("config.json", "summary.json", "model_quantized/compressed_weights.data"):
            assert (tdir / name / f).is_file()
    delta = json.loads((tdir / "frame_0002" / "model_quantized" / "meta_data.json")
                       .read_text())["__meta__"]["delta"]
    assert delta["prev"] == "../../frame_0001/model_quantized"
    assert delta["sha256"] == tseq._payload_sha(tdir / "frame_0001" / "model_quantized")
    assert delta["stream"] == "zstd" and len(delta["layers"]) >= 1 and delta["xor"]
    for name in ("frame_0000", "frame_0003"):
        meta = json.loads((tdir / name / "model_quantized" / "meta_data.json").read_text())
        assert "delta" not in meta.get("__meta__", {})
    cfg = json.loads((tdir / "frame_0001" / "config.json").read_text())
    assert cfg["entropy_coding"]["stream_name"] == "zstd" and cfg["img"]["height"] == 24


def _chain(decompress, seq_dir, names):
    out, state = [], None
    for name in names:
        state = decompress(seq_dir / name / "model_quantized", "zstd", prev_state=state)
        out.append(state)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chain_decodes_across_packages_exactly(dense_pair, writer):
    """A chain written by one package decodes in the other to the writer's
    arrays with atol 0: in order from the state just decoded, and each
    P-frame alone by the verified chain walk."""
    jdir, tdir, _, _, _ = dense_pair
    seq_dir, own, other = ((jdir, jcoding.decompress_state_dict, tcoding.decompress_state_dict)
                           if writer == "jax" else
                           (tdir, tcoding.decompress_state_dict, jcoding.decompress_state_dict))
    for names in (FRAMES[:3], FRAMES[3:]):
        ref = _chain(own, seq_dir, names)
        got = _chain(other, seq_dir, names)
        walked = other(seq_dir / names[-1] / "model_quantized", "zstd")
        for r, g in zip(ref, got):
            assert list(g) == list(r)
            for k in r:
                np.testing.assert_array_equal(g[k], np.asarray(r[k]))
        for k in ref[-1]:
            np.testing.assert_array_equal(walked[k], np.asarray(ref[-1][k]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_decode_sequence_across_packages(dense_pair, writer):
    """Each package's decode_sequence renders the other's seq dir within
    1e-5 of its own (fp32 on the CPU); so do the GOP seeks (frame 2 walks
    from frame 0, frame 4 from the I-frame at 3)."""
    jdir, tdir, _, _, _ = dense_pair
    seq_dir = jdir if writer == "jax" else tdir
    ours, onames = tseq.decode_sequence(seq_dir, device="cpu")
    theirs, jnames = jseq.decode_sequence(seq_dir)
    assert onames == jnames == FRAMES and ours.shape == (5, 24, 24, 3)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-5)
    for t in (2, 4):
        img, name = tseq.decode_sequence(seq_dir, frame=t, device="cpu")
        jimg, jname = jseq.decode_sequence(seq_dir, frame=t)
        assert name == jname == FRAMES[t]
        np.testing.assert_array_equal(img, ours[t])
        np.testing.assert_allclose(img, np.asarray(jimg), rtol=0, atol=1e-5)
    with pytest.raises(IndexError):
        tseq.decode_sequence(seq_dir, frame=5, device="cpu")


def test_broken_chain_fails_loudly(dense_pair, tmp_path):
    """A changed previous payload raises ValueError (sha256), a missing
    previous frame FileNotFoundError, in the port's decoder."""
    _, tdir, _, _, _ = dense_pair
    copy = tmp_path / "seq_copy"
    shutil.copytree(tdir, copy)
    payload = copy / "frame_0000" / "model_quantized" / "compressed_weights.data"
    payload.write_bytes(payload.read_bytes()[:-1] + b"\x00")
    with pytest.raises(ValueError, match="sha256 mismatch"):
        tcoding.decompress_state_dict(copy / "frame_0001" / "model_quantized", "zstd")
    shutil.rmtree(copy / "frame_0000")
    with pytest.raises(FileNotFoundError, match="previous frame"):
        tcoding.decompress_state_dict(copy / "frame_0001" / "model_quantized", "zstd")


def test_pframe_dir_decodes_through_the_decode_cli(dense_pair, tmp_path):
    """A P-frame's run dir is a standard run dir: decode_run and the
    decompress CLI render it standalone, walking the chain themselves, to
    decode_sequence's frame bit for bit."""
    _, tdir, _, _, _ = dense_pair
    frames, _ = tseq.decode_sequence(tdir, device="cpu")
    img, _ = tdecompress.decode_run(tdir / "frame_0001", out_path=tmp_path / "f1.png",
                                    device="cpu")
    np.testing.assert_array_equal(img, frames[1])
    tdecompress.cli([str(tdir / "frame_0004"), "--out", str(tmp_path / "f4.png"),
                     "--device", "cpu"])
    assert (tmp_path / "f4.png").is_file()


# ---- one sparse P-frame from a JAX-written I-frame ----

def _sparse_pframe(tmp_path):
    """From JAX's sparse (RigL 0.5) I-frame, the port's P-frame step and
    JAX's P-fit pieces (as encode_sequence builds them) on frame 1:
    {masks_equal, param_gap, db_port, db_jax, w0, w1}, the decoded PSNRs
    the port's P-frame's and the JAX package's own frame 1's."""
    from implicit_image_tpu.optim import opt_init
    from implicit_image_tpu.parallel.ladder import build_ladder_args as jargs
    from implicit_image_tpu.sparsity import apply_masks, create_mask_state
    from implicit_image_tpu.training.fit import make_fit_segments

    ov = SEQ + ["masking=RigL", "masking.density=0.5", "sequence.frames=2",
                "sequence.max_drop=none"]
    jrows = jseq.encode_sequence(ov + [f"output_dir={tmp_path / 'jax'}"])
    assert [r["kind"] for r in jrows] == ["I", "P"]
    jdir = tmp_path / "jax" / "seq_unittest"
    frames = tvideo(24, 24, frames=2, seed=stable_seed("unittest"), motion=0.01)

    # the port's P-frame step, chained to a copy of JAX's I-frame
    work = tmp_path / "port"
    shutil.copytree(jdir / "frame_0000", work / "frame_0000")
    coder = tseq._FrameCoder(compose(ov + [f"output_dir={work}"]), "cpu")
    state0 = tcoding.decompress_state_dict(work / "frame_0000" / "model_quantized", "zstd")
    prev = tseq._Coded(work / "frame_0000", 0, state0,
                       tcoding.params_from_state_dict(state0), None, 20)
    coded = coder.pframe(frames[1], prev, work / "frame_0001", torch.Generator().manual_seed(1))
    assert coded.steps == 6

    # JAX's pieces: the P-fit's carry as encode_sequence's pframe_init builds it
    a = jargs(jseq.compose(ov))
    p_masking = dataclasses.replace(a["masking"], sparse_init="resume", end_when=-1)
    p_optim = dataclasses.replace(a["optim_cfg"], lr=1e-4)
    _, segment_fn = make_fit_segments(a["mdef"], a["mcfg"], a["grid"],
                                      dataclasses.replace(a["train_cfg"], num_steps=6), p_optim,
                                      p_masking)
    params0 = jcoding.params_from_state_dict(
        jcoding.decompress_state_dict(jdir / "frame_0000" / "model_quantized", "zstd"))
    mask_state = create_mask_state(jax.random.PRNGKey(0), params0, p_masking)
    carry = (apply_masks(params0, mask_state.masks), opt_init(params0, p_optim), mask_state,
             jax.random.PRNGKey(1), ())
    carry, _ = jax.jit(lambda c, im: segment_fn(c, im, jnp.int32(0), length=6))(
        carry, jnp.asarray(frames[1]))

    masks_equal = all(
        (jm is None) == (tm is None) and (jm is None or np.array_equal(tm.numpy(),
                                                                      np.asarray(jm)))
        for jm, tm in zip(carry[2].masks, coded.fit.mask_state.masks))
    param_gap = max(float(np.abs(tl[k].numpy() - np.asarray(jl[k])).max())
                    for jl, tl in zip(carry[0], coded.fit.params) for k in jl)
    jimgs, _ = jseq.decode_sequence(jdir)
    return dict(masks_equal=masks_equal, param_gap=param_gap,
                db_port=_db(coder.render(coded.params), frames[1]),
                db_jax=_db(np.asarray(jimgs[1]), frames[1]),
                w0=state0["layers.1.weight"], w1=coded.state["layers.1.weight"])


def test_sparse_pframe_matches_jax_pieces(tmp_path):
    """The same resume masks, P-fit params within 1e-5, the decoded P-frame
    within 0.01 dB of the JAX package's own frame 1 (its P-frame is
    deterministic under resume masks with no update), the I-frame's zeros
    kept."""
    r = _sparse_pframe(tmp_path)
    assert r["masks_equal"]
    assert r["param_gap"] <= 1e-5
    assert abs(r["db_port"] - r["db_jax"]) <= 0.01
    assert float((r["w0"] == 0).mean()) > 0.3
    np.testing.assert_array_equal(r["w1"] == 0, r["w0"] == 0)


# ---- the options (JAX's tests/test_sequence.py on the port) ----

def test_stop_at_psnr_bounds_the_pframe_budget(tmp_path):
    base = SEQ + [f"output_dir={tmp_path}", "masking=none", "sequence.frames=2",
                  "sequence.steps=40"]
    early = _port(base + ["sequence.stop_at_psnr=5"])
    assert early[1]["kind"] == "P" and early[1]["steps"] < 40
    full = _port(base + ["sequence.stop_at_psnr=99", f"output_dir={tmp_path}/full"])
    assert full[1]["steps"] == 40
    frames, _ = tseq.decode_sequence(tmp_path / "seq_unittest", device="cpu")
    assert frames.shape[0] == 2


def test_lr_retunes_the_pfits_only(tmp_path):
    base = SEQ + ["masking=none"]
    hi = _port(base + [f"output_dir={tmp_path}/hi"])
    lo = _port(base + [f"output_dir={tmp_path}/lo", "sequence.lr=1e-5"])
    assert hi[0]["bytes"] == lo[0]["bytes"] and hi[0]["decoded_psnr"] == lo[0]["decoded_psnr"]
    assert any(a["bytes"] != b["bytes"] or a["decoded_psnr"] != b["decoded_psnr"]
               for a, b in zip(hi[1:], lo[1:]))


def test_requires_kmeans(tmp_path):
    with pytest.raises(ValueError, match="kmeans"):
        _port(["img=synthetic", "img.height=16", "img.width=16", "quant=none",
               "sequence.video=x", "sequence.frames=2", f"output_dir={tmp_path}"])


def test_max_drop_fallback_and_disable(tmp_path):
    """The scene-cut guard: at large motion and a starved P budget the
    frame falls back to a standalone I-frame; max_drop=none ships the P."""
    high = ["sequence.video=scenecut", "sequence.frames=2", "sequence.motion=0.5",
            "sequence.steps=2", "sequence.steps0=400", "img.height=32", "img.width=32"]
    guarded = _port(SEQ + high + [f"output_dir={tmp_path}/a", "masking=none",
                                  "sequence.max_drop=0.5"])
    assert [r["kind"] for r in guarded] == ["I", "I"]
    meta = json.loads((tmp_path / "a" / "seq_scenecut" / "frame_0001" / "model_quantized" /
                       "meta_data.json").read_text())
    assert "prev" not in meta.get("__meta__", {}).get("delta", {})
    assert tseq.decode_sequence(tmp_path / "a" / "seq_scenecut", device="cpu")[0].shape[0] == 2
    unguarded = _port(SEQ + high + [f"output_dir={tmp_path}/b", "masking=none",
                                    "sequence.max_drop=none"])
    assert [r["kind"] for r in unguarded] == ["I", "P"]
    assert guarded[1]["decoded_psnr"] > unguarded[1]["decoded_psnr"] + 0.5


def test_delta_iframes(tmp_path):
    """quant.delta + train.init_path: I-frames record the artifact (with
    XOR residuals), P-frames the previous frame; the mixed chain decodes,
    in the JAX package too."""
    art = _meta(tmp_path / "meta.npz")
    rows = _port(SEQ + [f"output_dir={tmp_path}", "masking=none", "quant.delta=true",
                        f"train.init_path={art}", "sequence.gop=2"])
    assert [r["kind"] for r in rows] == ["I", "P", "I"]
    root = tmp_path / "seq_unittest"
    m0 = json.loads((root / "frame_0000" / "model_quantized" / "meta_data.json").read_text())
    assert m0["__meta__"]["delta"]["artifact"] == str(art) and m0["__meta__"]["delta"]["xor"]
    m1 = json.loads((root / "frame_0001" / "model_quantized" / "meta_data.json").read_text())
    assert "prev" in m1["__meta__"]["delta"]
    ours, _ = tseq.decode_sequence(root, device="cpu")
    theirs, _ = jseq.decode_sequence(root)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-5)


def test_ekfac_pframe_carry(tmp_path):
    rows = _port(SEQ + [f"output_dir={tmp_path}", "masking=none", "optim.preconditioner=ekfac",
                        "sequence.frames=2", "sequence.steps0=10", "sequence.steps=4",
                        "sequence.max_drop=none"])
    assert [r["kind"] for r in rows] == ["I", "P"] and rows[1]["steps"] == 4
    assert tseq.decode_sequence(tmp_path / "seq_unittest", device="cpu")[0].shape[0] == 2


def test_files_input(tmp_path):
    v = tvideo(24, 24, frames=2, seed=7, motion=0.02)
    paths = []
    for t in range(2):
        p = tmp_path / f"f{t}.png"
        save_img(str(p), v[t])
        paths.append(str(p))
    rows = _port(["mlp.depth=3", "mlp.hidden_size=16", "img.height=24", "img.width=24",
                  "img.bits=8", "train.num_steps=20", "train.log_steps=20", "quant=kmeans",
                  "quant.bits=4", "quant.num_steps=4", "quant.log_steps=4",
                  "entropy_coding=zstd", "masking=none", f"sequence.files={paths[0]},{paths[1]}",
                  "sequence.steps0=20", "sequence.steps=6", "sequence.max_drop=none",
                  f"output_dir={tmp_path}"])
    assert [r["kind"] for r in rows] == ["I", "P"]
    frames, _ = tseq.decode_sequence(tmp_path / "seq_f0", device="cpu")
    assert frames.shape == (2, 24, 24, 3)


def test_cli_encode_pack_decode_and_seek(tmp_path, capsys):
    tseq.cli(["encode", *SEQ, "masking=none", "sequence.gop=2", f"output_dir={tmp_path}",
              "device=cpu"])
    root = tmp_path / "seq_unittest"
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["kind"] for r in rows] == ["I", "P", "I"]
    tseq.cli(["pack", str(root)])
    iiv = tmp_path / "seq_unittest.iiv"
    assert iiv.is_file() and "packed" in capsys.readouterr().out
    tseq.cli(["decode", str(root), "device=cpu"])
    assert "decoded 3 frames" in capsys.readouterr().out
    assert all((root / f"frame_000{t}.png").is_file() for t in range(3))
    tseq.cli(["decode", str(iiv), "frame=1", "device=cpu"])
    assert "via GOP seek" in capsys.readouterr().out
    assert (tmp_path / "frame_0001.png").is_file()


def test_entry_points_raise_without_cuda(tmp_path):
    """Without device=cpu the encoder and the decoder look for the card:
    RuntimeError here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tseq.encode_sequence(SEQ + [f"output_dir={tmp_path}", "masking=none"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tseq.decode_sequence(tmp_path)


if __name__ == "__main__":
    # the measured gaps behind the bounds above:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sequence.py
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("dense", "sparse"):
            (Path(tmp) / sub).mkdir()
        pair = _dense_pair(Path(tmp) / "dense")
        for t, (db_gap, byte_gap) in enumerate(_dense_gaps(pair)):
            print(f"dense frame {t} ({pair[3][t]['kind']}): |dB gap| {db_gap:.3e}, "
                  f"bytes {pair[3][t]['bytes']} vs JAX {pair[2][t]['bytes']} "
                  f"({100 * byte_gap:.3f}%)")
        for name, seq_dir in (("JAX's", pair[0]), ("the port's", pair[1])):
            ours, _ = tseq.decode_sequence(seq_dir, device="cpu")
            theirs, _ = jseq.decode_sequence(seq_dir)
            print(f"decode_sequence of {name} seq dir, port vs JAX: max |diff| "
                  f"{float(np.abs(ours - np.asarray(theirs)).max()):.3e}")
        r = _sparse_pframe(Path(tmp) / "sparse")
        print(f"sparse P-frame: masks equal {r['masks_equal']}, P-fit params max |diff| "
              f"{r['param_gap']:.3e}, decoded {r['db_port']:.6f} dB vs JAX's "
              f"{r['db_jax']:.6f} dB")
