"""Port parity: compress-to-target (target.py). `_meets`, `_pick` and
`_bracket` equal the JAX package's on canned members, hits and misses;
with one canned ladder_compress patched into both packages the whole search
gives the same probes, choice and target_met; one real small search runs
end to end on the CPU; without device=cpu the search raises here."""
from pathlib import Path

import numpy as np
import pytest
import torch

from implicit_image_tpu import target as jtarget
from implicit_image_tpu.config import compose as jcompose
from implicit_image_tpu.parallel.pipeline import PipelineResult as JResult
from implicit_image_tpu_torch import target as ttarget
from implicit_image_tpu_torch.compress import compose
from implicit_image_tpu_torch.parallel.pipeline import PipelineResult as TResult

torch.set_num_threads(1)


def _member(cls, db, nbytes, d=0.0):
    return cls(psnr=db, quant_psnr=db, decoded_psnr=db, compressed_bytes=nbytes, params=None,
               stream_dir=f"d{d}")


CANNED = [(0.05, 40.0, 10_000), (0.2, 46.0, 30_000), (0.5, 50.0, 60_000), (0.9, 52.0, 100_000)]


def _members(cls):
    return [(d, _member(cls, db, b, d)) for d, db, b in CANNED]


TARGETS = [(35_000, None), (None, 47.0), (70_000, None), (70_000, 49.0), (70_000, 51.0),
           (5_000, None), (None, 60.0), (5_000, 60.0), (10_000, None), (None, 40.0),
           (200_000, None), (None, 10.0)]


@pytest.mark.parametrize("tb,tdb", TARGETS)
def test_selection_helpers_match_jax(tb, tdb):
    """_meets on every member, _pick and _bracket equal JAX's, hits and
    misses (the JAX package's test_target cases among them)."""
    tm, jm = _members(TResult), _members(JResult)
    for (_, t), (_, j) in zip(tm, jm):
        assert ttarget._meets(t, tb, tdb) == jtarget._meets(j, tb, tdb)
    td, tr, thit = ttarget._pick(tm, tb, tdb)
    jd, jr, jhit = jtarget._pick(jm, tb, tdb)
    assert (td, tr.stream_dir, thit) == (jd, jr.stream_dir, jhit)
    assert ttarget._bracket(tm, tb, tdb) == jtarget._bracket(jm, tb, tdb)


def test_jax_package_cases():
    """The JAX package's asserted values, on the port."""
    m = _members(TResult)
    d, r, hit = ttarget._pick(m, tb=35_000, tdb=None)
    assert hit and d == 0.2 and r.compressed_bytes == 30_000
    d, r, hit = ttarget._pick(m, tb=None, tdb=47.0)
    assert hit and d == 0.5
    assert not ttarget._pick(m, tb=5_000, tdb=None)[2]
    assert ttarget._bracket(m, tb=35_000, tdb=None) == (0.2, 0.5)
    assert ttarget._bracket(m, tb=None, tdb=47.0) == (0.2, 0.5)


def _canned_ladder(cls, calls):
    """A ladder whose member at density d decodes 30 + 25 d dB in
    int(2,000 + 100,000 d) bytes (rising with density, as real ladders)."""
    def ladder_compress(generator, mdef, mcfg, grid, img, train_cfg, optim_cfg, masking_cfg,
                        densities, stream_root="", **kw):
        calls.append([float(d) for d in densities])
        return [cls(psnr=30 + 25 * d, quant_psnr=30 + 25 * d, decoded_psnr=30 + 25 * float(d),
                    compressed_bytes=int(2_000 + 100_000 * float(d)), params=None,
                    stream_dir=f"{stream_root}/d{d}") for d in densities]
    return ladder_compress


@pytest.mark.parametrize("kw", [
    dict(target_bytes=40_000, refine=1),
    dict(target_db=45.0, refine=2),
    dict(target_bytes=60_000, target_db=50.0, refine=1),
    dict(target_bytes=500, refine=1),  # a miss: nothing fits
    dict(target_db=80.0, refine=1, ladder_size=3),  # a miss: nothing reaches it
    dict(target_bytes=40_000, densities=[0.1, 0.3, 0.6], refine=0),
])
def test_search_matches_jax_with_a_canned_ladder(monkeypatch, tmp_path, kw):
    """One canned ladder_compress in both packages: the same ladders are
    asked for, and the same probes, choice and target_met come back."""
    jcalls, tcalls = [], []
    monkeypatch.setattr(jtarget, "ladder_compress", _canned_ladder(JResult, jcalls))
    monkeypatch.setattr(ttarget, "ladder_compress", _canned_ladder(TResult, tcalls))
    ov = ["img=synthetic", "img.height=8", "img.width=8", "mlp.depth=3", "mlp.hidden_size=8"]
    j = jtarget.compress_to_target(jcompose(ov), out_root=str(tmp_path), **kw)
    t = ttarget.compress_to_target(compose(ov + ["device=cpu"]), out_root=str(tmp_path), **kw)
    assert tcalls == jcalls
    for key in ("density", "decoded_psnr", "compressed_bytes", "target_met", "stream_dir",
                "probes"):
        assert t[key] == j[key], key


def test_compress_to_target_end_to_end(tmp_path):
    """A tiny real search on the CPU (24², d4 w16, 60 + 5 steps, 5-bit
    k-means, zstd): the chosen member's stream exists, it meets the byte
    budget exactly when target_met says so, and bytes rise with density."""
    cfg = compose(["device=cpu", "img=synthetic", "img.height=24", "img.width=24", "mlp.depth=4",
                   "mlp.hidden_size=16", "train.num_steps=60", "train.log_steps=30",
                   "masking=RigL", "masking.end_when=40", "masking.interval=20",
                   "quant.num_steps=5", "quant.bits=5", "entropy_coding=zstd"])
    res = ttarget.compress_to_target(cfg, target_bytes=1_000, densities=[0.1, 0.5, 0.9],
                                     refine=1, out_root=str(tmp_path))
    assert len(res["probes"]) >= 3
    assert (res["compressed_bytes"] <= 1_000) == res["target_met"]
    assert (Path(res["stream_dir"]) / "model_quantized" / "compressed_weights.data").exists()
    by_density = {p["density"]: p["bytes"] for p in res["probes"]}
    assert by_density[0.1] < by_density[0.9]
    assert res.density == res["density"] and np.isfinite(res.decoded_psnr)


def test_search_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = compose(["img=synthetic", "img.height=8", "img.width=8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttarget.compress_to_target(cfg, target_bytes=1_000, out_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttarget.cli(["img=synthetic", "img.height=8", "img.width=8", "target.bytes=1000"])
