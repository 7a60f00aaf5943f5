"""Port parity: the CLIs' run tools — the single-file .iic container
(coding/container_file.py), multirun (-m, launcher.n_jobs) and
profile=True (utils/profiling.py).

.iic: a run packed by either package is the same file, unpacks in the other
and decodes to the run dir's image (exact in the port; within 1e-5 of the
JAX decoder's). Multirun: two members give the same summary.json values
(every key but the wall and build seconds) at n_jobs 1 and 2. Profile: the
trace file lands in <run>/profile/ and holds the fit's span.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from implicit_image_tpu import decompress as jdecompress
from implicit_image_tpu.coding import container_file as jcf
from implicit_image_tpu_torch import compress as tcompress
from implicit_image_tpu_torch import decompress as tdecompress
from implicit_image_tpu_torch.coding import container_file as tcf
from implicit_image_tpu_torch.utils import annotate, trace, wall

torch.set_num_threads(1)

FAST = ["img=synthetic", "img.height=20", "img.width=20", "mlp.depth=3", "mlp.hidden_size=16",
        "train.num_steps=30", "train.log_steps=30", "quant=kmeans", "quant.bits=4",
        "quant.num_steps=4", "entropy_coding=zstd", "masking=none", "device=cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    tcompress.main(tcompress.compose(FAST), run_dir=str(root / "run"))
    return root / "run"


def test_both_packages_pack_the_same_file(run, tmp_path):
    ours = tcf.pack_run(run, tmp_path / "t.iic")
    theirs = jcf.pack_run(run, tmp_path / "j.iic")
    assert ours.read_bytes() == theirs.read_bytes()
    assert tcf.is_packed_container(ours) and jcf.is_packed_container(ours)
    again = tcf.pack_run(run, tmp_path / "again.iic")
    assert again.read_bytes() == ours.read_bytes()  # deterministic


@pytest.mark.parametrize("packer", ["jax", "torch"])
def test_packed_run_decodes_in_both(run, tmp_path, packer):
    iic = (jcf if packer == "jax" else tcf).pack_run(run, tmp_path / "a.iic")
    from_dir, _ = tdecompress.decode_run(run, out_path=tmp_path / "dir.png", device="cpu")
    from_file, stats = tdecompress.decode_run(iic, device="cpu")
    np.testing.assert_array_equal(from_file, from_dir)
    assert stats["out"].endswith("a.decoded.png")
    up, _ = tdecompress.decode_run(iic, device="cpu", scale=2.0)
    assert up.shape == (40, 40, 3)
    theirs, _ = jdecompress.decode_run(iic)
    np.testing.assert_allclose(from_file, np.asarray(theirs), rtol=0, atol=1e-5)
    for unpack in (tcf.unpack_run, jcf.unpack_run):
        out = unpack(iic, tmp_path / f"restored_{unpack.__module__.split('.')[0]}")
        for name in tcf.MEMBERS:
            assert (out / name).read_bytes() == (run / name).read_bytes()


def test_pack_refuses_pframe_and_garbage(run, tmp_path):
    broken = tmp_path / "pframe_run"
    shutil.copytree(run, broken)
    meta_p = broken / "model_quantized" / "meta_data.json"
    meta = json.loads(meta_p.read_text())
    meta.setdefault("__meta__", {})["delta"] = {
        "prev": "../frame_0000/model_quantized", "sha256": "0" * 64, "layers": [1], "xor": []}
    meta_p.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="inter-frame"):
        tcf.pack_run(broken)
    junk = tmp_path / "junk.iic"
    junk.write_bytes(b"not a zip")
    assert not tcf.is_packed_container(junk)
    with pytest.raises(ValueError, match="not a packed"):
        tcf.unpack_run(junk)
    with pytest.raises(FileNotFoundError, match="missing"):
        tcf.pack_run(tmp_path / "nope")


def test_container_cli(run, tmp_path, capsys):
    out = tmp_path / "cli.iic"
    tcf.main(["pack", str(run), str(out)])
    assert out.exists() and "packed" in capsys.readouterr().out
    tcf.main(["unpack", str(out), str(tmp_path / "cli_dir")])
    assert (tmp_path / "cli_dir" / "config.json").exists()
    with pytest.raises(SystemExit, match="usage"):
        tcf.main([])
    tdecompress.cli([str(out), "--device", "cpu"])
    assert (tmp_path / "cli.decoded.png").is_file()


# ---- multirun ----

_VOLATILE = ("_wall_s", "_build_s", "bit_alloc_search_s")


def _summaries(root):
    out = {}
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        s = json.loads((d / "summary.json").read_text())
        out[d.name] = {k: v for k, v in s.items() if not k.endswith(_VOLATILE)}
    return out


# a member's dir is named by all its overrides: keep them few (and the
# output dir relative) to stay inside a file name's 255 bytes
SHORT = ["img=synthetic", "img.height=20", "img.width=20", "mlp.depth=3", "mlp.hidden_size=16",
         "train.num_steps=30", "quant.num_steps=4", "entropy_coding=zstd", "device=cpu"]


def test_multirun_results_do_not_depend_on_n_jobs(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for n_jobs in (1, 2):
        tcompress.cli(["-m", *SHORT, "seed=0,1", f"launcher.n_jobs={n_jobs}",
                       f"output_dir=n{n_jobs}"])
    printed = capsys.readouterr().out
    assert printed.count("PSNR=") == 4 and "RESULT" not in printed
    one, two = _summaries(tmp_path / "n1"), _summaries(tmp_path / "n2")
    # member dirs differ only by their launcher.n_jobs and output_dir
    assert [n.split(",launcher")[0] for n in one] == [n.split(",launcher")[0] for n in two]
    assert len(one) == 2 and list(one.values()) == list(two.values())
    a, b = one.values()
    assert a["Decoded PSNR"] != b["Decoded PSNR"]  # two seeds, two fits
    for n1, n2 in zip(one, two):
        for stem in ("model_quantized/compressed_weights.data", "model.npz"):
            assert ((tmp_path / "n1" / n1 / stem).read_bytes()
                    == (tmp_path / "n2" / n2 / stem).read_bytes())


def test_multirun_member_dirs_are_named_by_overrides(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tcompress.cli(["--multirun", *SHORT, "quant.bits=3,4", "output_dir=o"])
    names = sorted(p.name for p in (tmp_path / "o").iterdir())
    assert names == [",".join(SHORT + [f"quant.bits={b}", "output_dir=o"]) for b in (3, 4)]


def test_single_run_cli_prints_result(tmp_path, capsys):
    tcompress.cli([*FAST, f"output_dir={tmp_path / 'one'}"])
    assert "RESULT PSNR=" in capsys.readouterr().out
    assert (tmp_path / "one" / "summary.json").is_file()


# ---- profile=True ----


def test_profile_writes_a_trace_of_the_fit(tmp_path):
    rd = tmp_path / "prof"
    tcompress.main(tcompress.compose(FAST + ["profile=True"]), run_dir=str(rd))
    trace_file = rd / "profile" / "trace.json"
    assert trace_file.is_file()
    events = json.loads(trace_file.read_text())["traceEvents"]
    assert any(e.get("name") == "fit" for e in events)


def test_profiling_helpers(tmp_path, caplog):
    import logging

    with trace(str(tmp_path / "p")), annotate("span"):
        torch.ones(4).sum()
    names = {e.get("name") for e in json.loads((tmp_path / "p" / "trace.json").read_text())
             ["traceEvents"]}
    assert "span" in names
    with caplog.at_level(logging.INFO, logger="implicit_image_tpu_torch"):
        with wall("unit-span"):
            pass
    assert any("unit-span" in r.message for r in caplog.records)


def test_launch_counts_survive_threads():
    """Multirun members launch from worker threads: the counts' read-modify-
    write is locked, so no increment is lost (a short switch interval makes
    an unlocked race likely)."""
    import sys
    import threading

    from implicit_image_tpu_torch.ops import sine_mlp as sm

    before = dict(sm.LAUNCHES), {k: dict(v) for k, v in sm.LAUNCHES_BY_MODE.items()}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda bf=i % 2: [sm._count("sum_partials", bf)
                                                             for _ in range(2000)])
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert sm.LAUNCHES["sum_partials"] - before[0]["sum_partials"] == 32000
        by_mode = sm.LAUNCHES_BY_MODE["sum_partials"]
        assert by_mode["fp32"] - before[1]["sum_partials"]["fp32"] == 16000
        assert by_mode["bf16"] - before[1]["sum_partials"]["bf16"] == 16000
    finally:
        sys.setswitchinterval(old)
        sm.LAUNCHES.update(before[0])
        for k, v in before[1].items():
            sm.LAUNCHES_BY_MODE[k].update(v)
