"""Port parity: the single-file sequence container (.iiv,
coding/container_file.py's sequence half).

A seq dir encoded by the port (4 frames, an I-frame every 2: I P I P)
packs to the same .iiv bytes in both packages; each package unpacks the
other's archive to the dir's files and reads the same GOP index; the
port's decode_sequence of the file equals its decode of the dir bit for bit
(and the JAX package's within 1e-5), and a seek extracts only the nearest
I-frame and the P-chain to its frame. Rootless chains, suspicious frame
names and files that are not an .iiv are refused in both packages.
"""
import json
import zipfile

import numpy as np
import pytest
import torch

from implicit_image_tpu import sequence as jseq
from implicit_image_tpu.coding import container_file as jcf
from implicit_image_tpu_torch import sequence as tseq
from implicit_image_tpu_torch.coding import container_file as tcf

torch.set_num_threads(1)

SEQ = [
    "img=synthetic", "img.height=24", "img.width=24",
    "mlp.depth=3", "mlp.hidden_size=16",
    "train.num_steps=20", "train.log_steps=20",
    "quant=kmeans", "quant.bits=4", "quant.num_steps=4", "quant.log_steps=4",
    "entropy_coding=zstd", "masking=none",
    "sequence.video=unittest", "sequence.frames=4", "sequence.gop=2",
    "sequence.steps0=20", "sequence.steps=6",
]
NAMES = ["frame_0000", "frame_0001", "frame_0002", "frame_0003"]


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("iiv")
    rows = tseq.encode_sequence(SEQ + [f"output_dir={root}"], device="cpu")
    assert [r["kind"] for r in rows] == ["I", "P", "I", "P"]
    return root / "seq_unittest"


@pytest.fixture(scope="module")
def dir_frames(seq_dir):
    return tseq.decode_sequence(seq_dir, device="cpu")


def test_both_packages_pack_the_same_file(seq_dir, tmp_path):
    ours = tcf.pack_sequence(seq_dir, tmp_path / "t.iiv")
    theirs = jcf.pack_sequence(seq_dir, tmp_path / "j.iiv")
    assert ours.read_bytes() == theirs.read_bytes()
    assert tcf.pack_sequence(seq_dir, tmp_path / "again.iiv").read_bytes() == ours.read_bytes()
    assert tcf.is_packed_sequence(ours) and jcf.is_packed_sequence(ours)
    # the default path: the dir's with the suffix .iiv
    default = tcf.pack_sequence(seq_dir)
    try:
        assert default == seq_dir.with_suffix(".iiv")
        assert default.read_bytes() == ours.read_bytes()
    finally:
        default.unlink()


def test_index_equals_jax(seq_dir, tmp_path):
    idx = tcf.sequence_index(seq_dir)
    assert idx == jcf.sequence_index(seq_dir)
    assert [f["kind"] for f in idx["frames"]] == ["I", "P", "I", "P"]
    assert idx["frames"][3]["prev"] == "../../frame_0002/model_quantized"
    iiv = jcf.pack_sequence(seq_dir, tmp_path / "j.iiv")
    assert tcf.read_sequence_index(iiv) == jcf.read_sequence_index(iiv) == idx


@pytest.mark.parametrize("packer", ["jax", "port"])
def test_each_unpacks_the_others_archive(seq_dir, tmp_path, packer):
    iiv = (jcf if packer == "jax" else tcf).pack_sequence(seq_dir, tmp_path / "a.iiv")
    unpack = tcf.unpack_sequence if packer == "jax" else jcf.unpack_sequence
    out = unpack(iiv, tmp_path / "restored")
    assert sorted(d.name for d in out.iterdir() if d.is_dir()) == NAMES
    for name in NAMES:
        for member in tcf._FRAME_MEMBERS:
            assert (out / name / member).read_bytes() == (seq_dir / name / member).read_bytes()
    assert json.loads((out / "sequence.json").read_text()) == tcf.sequence_index(seq_dir)


def test_decode_of_the_file_equals_the_dir(seq_dir, dir_frames, tmp_path):
    """decode_sequence reads the .iiv directly: the same frames bit for bit
    as the dir, every seek equal to the full decode's frame, and the JAX
    package's decode of the port's file within 1e-5."""
    ref, names = dir_frames
    iiv = tcf.pack_sequence(seq_dir, tmp_path / "clip.iiv")
    frames, fnames = tseq.decode_sequence(iiv, device="cpu")
    assert fnames == names == NAMES
    np.testing.assert_array_equal(frames, ref)
    for t in range(4):
        img, name = tseq.decode_sequence(iiv, frame=t, device="cpu")
        assert name == NAMES[t]
        np.testing.assert_array_equal(img, ref[t])
    with pytest.raises(IndexError):
        tseq.decode_sequence(iiv, frame=4, device="cpu")
    theirs, _ = jseq.decode_sequence(iiv)
    np.testing.assert_allclose(np.asarray(theirs), frames, rtol=0, atol=1e-5)


def test_seek_extracts_only_its_chain(seq_dir, dir_frames, tmp_path, monkeypatch):
    """A seek to frame 3 extracts frames 2 (its I-frame) and 3 only; a seek
    to frame 1 frames 0 and 1."""
    ref, _ = dir_frames
    iiv = tcf.pack_sequence(seq_dir, tmp_path / "clip.iiv")
    seen = []
    real = tcf.unpack_sequence

    def spy(path, dest=None, frames=None):
        out = real(path, dest, frames=frames)
        seen.append(sorted(d.name for d in out.iterdir() if d.is_dir()))
        return out

    monkeypatch.setattr(tcf, "unpack_sequence", spy)
    for t, chain in ((3, ["frame_0002", "frame_0003"]), (1, ["frame_0000", "frame_0001"])):
        img, _ = tseq.decode_sequence(iiv, frame=t, device="cpu")
        assert seen[-1] == chain
        np.testing.assert_array_equal(img, ref[t])
    part = real(iiv, tmp_path / "part", frames=["frame_0002", "frame_0003"])
    img, name = tseq.decode_sequence(part, frame=0, device="cpu")
    assert name == "frame_0002"
    np.testing.assert_array_equal(img, ref[2])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rootless_chain_is_refused(seq_dir, tmp_path, pkg):
    import shutil

    cf = jcf if pkg == "jax" else tcf
    broken = tmp_path / "seq_rootless"
    shutil.copytree(seq_dir, broken)
    for name in ("frame_0000", "frame_0002"):
        shutil.rmtree(broken / name)
    with pytest.raises(ValueError, match="I-frame"):
        cf.sequence_index(broken)
    with pytest.raises(ValueError, match="I-frame"):
        cf.pack_sequence(broken, tmp_path / "x.iiv")
    with pytest.raises(FileNotFoundError, match="frame_"):
        cf.sequence_index(tmp_path)


@pytest.mark.parametrize("bad", ["../evil", "a/b", ".hidden"])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_suspicious_frame_names_are_refused(tmp_path, bad, pkg):
    cf = jcf if pkg == "jax" else tcf
    path = tmp_path / "evil.iiv"
    index = {"format": "iiv-1", "frames": [{"name": bad, "kind": "I", "prev": None}]}
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("sequence.json", json.dumps(index))
    with pytest.raises(ValueError, match="suspicious"):
        cf.unpack_sequence(path, tmp_path / "out")
    assert not (tmp_path / "evil").exists()


def test_not_an_iiv_is_refused(seq_dir, tmp_path):
    junk = tmp_path / "junk.iiv"
    junk.write_bytes(b"not a zip")
    iic = tcf.pack_run(seq_dir / "frame_0000", tmp_path / "f0.iic")
    for path in (junk, iic, tmp_path / "missing.iiv"):
        assert not tcf.is_packed_sequence(path)
        with pytest.raises(ValueError, match="not a packed .iiv"):
            tcf.read_sequence_index(path)
        with pytest.raises(ValueError, match="not a packed .iiv"):
            tcf.unpack_sequence(path)
    # a P-frame alone stays refused in .iic
    with pytest.raises(ValueError, match="inter-frame"):
        tcf.pack_run(seq_dir / "frame_0001")


def test_pack_seq_and_unpack_seq_through_main(seq_dir, tmp_path, capsys):
    out = tmp_path / "cli.iiv"
    tcf.main(["pack-seq", str(seq_dir), str(out)])
    assert out.is_file() and "packed" in capsys.readouterr().out
    assert out.read_bytes() == jcf.pack_sequence(seq_dir, tmp_path / "j.iiv").read_bytes()
    tcf.main(["unpack-seq", str(out), str(tmp_path / "cli_dir")])
    assert "unpacked" in capsys.readouterr().out
    assert sorted(d.name for d in (tmp_path / "cli_dir").iterdir() if d.is_dir()) == NAMES
    with pytest.raises(SystemExit, match="pack-seq"):
        tcf.main(["pack-seq"])
