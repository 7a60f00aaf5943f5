"""Port parity: the density ladder. A GMP ladder against the JAX package's
ladder_fit from one copied init; RigL and SNFS ladders against the port's
own single fits, bit for bit; the CLI's parsing and argument building
against the JAX package's on the same argv; ladder_compress end to end,
each member's container decoded by the JAX package; and the CLI's run
dirs read by decode_run and decode_runs."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from implicit_image_tpu import coding as jcoding
from implicit_image_tpu.data import get_grid as jgrid
from implicit_image_tpu.data import synthetic_image
from implicit_image_tpu.models import build_model as jbuild
from implicit_image_tpu.parallel import ladder as jladder
from implicit_image_tpu.sparsity import MaskingConfig as JMasking
from implicit_image_tpu.training.fit import OptimConfig as JOptim
from implicit_image_tpu.training.fit import TrainConfig as JTrain
from implicit_image_tpu_torch import coding as tcoding
from implicit_image_tpu_torch import decompress
from implicit_image_tpu_torch.convert import params_from_jax, params_to_numpy
from implicit_image_tpu_torch.data import get_grid, stable_seed
from implicit_image_tpu_torch.models import build_model
from implicit_image_tpu_torch.parallel import ladder, member_generators
from implicit_image_tpu_torch.quant import QuantConfig
from implicit_image_tpu_torch.sparsity import MaskingConfig
from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig, fit

torch.set_num_threads(1)

KEYS = ("w", "b")
GMP = dict(name="Pruning", density=1.0, sparse_init="random", prune_mode="global-magnitude",
           growth_mode="none", decay_schedule="magnitude-prune", final_density=0.5,
           start_when=2, end_when=20, interval=4)


def test_gmp_ladder_matches_jax_ladder_fit():
    """The case of the JAX package's test_ladder_gmp_members_match_single_fits
    (16x16, d3 w16, 24 steps, random init at density 1.0, finals 0.25 and
    0.75) from one copied init: each member's density array equals JAX's
    and its params agree within 1e-3 relative; each member prunes toward its
    own target."""
    jm, jc = jbuild("siren", depth=3, hidden_size=16)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jc))
    img = synthetic_image(16, 16, seed=0)
    finals = [0.25, 0.75]
    jres = jladder.ladder_fit(jax.random.PRNGKey(0), jm, jc, jgrid(16, 16), img,
                              JTrain(num_steps=24, log_steps=8, segment_steps=16),
                              JOptim(lr=1e-3), JMasking(**GMP), finals, init_params=p)
    m, c = build_model("siren", depth=3, hidden_size=16)
    res = ladder.ladder_fit(torch.Generator().manual_seed(0), m, c, get_grid(16, 16), img,
                            TrainConfig(num_steps=24, log_steps=8, segment_steps=16),
                            OptimConfig(lr=1e-3), MaskingConfig(**GMP), finals,
                            init_params=params_from_jax(p, "cpu"), device="cpu")
    np.testing.assert_array_equal(res.metrics["density"], np.asarray(jres.metrics["density"]))
    np.testing.assert_allclose(res.metrics["density"][:, -1], finals, atol=0.1)
    for i in range(2):
        for a, b in zip(params_to_numpy(res.params), jres.params):
            for k in KEYS:
                ref = np.asarray(b[k][i])
                assert np.abs(a[k][i] - ref).max() <= 1e-3 * np.abs(ref).max(), (i, k)


@pytest.mark.parametrize("preset", ["RigL", "SNFS"])
def test_ladder_members_are_single_fits_bit_for_bit(preset):
    """A RigL and an SNFS ladder: member i's params, masks and metrics are
    those of a single fit at its density with member_generators(g, B)[i],
    bit for bit (the counterpart of the JAX package's
    test_ladder_fit_members_match_single_fits; the ERK draws differ between
    the packages, so this is the property the port holds)."""
    mk = (MaskingConfig(density=0.5, end_when=20, interval=5) if preset == "RigL" else
          MaskingConfig(name="SNFS", density=0.05, growth_mode="momentum",
                        redistribution_mode="momentum", end_when=20, interval=5))
    m, c = build_model("siren", depth=3, hidden_size=16)
    grid, img = get_grid(16, 16), synthetic_image(16, 16, seed=0)
    tc, oc = TrainConfig(num_steps=30, log_steps=10), OptimConfig(lr=1e-3)
    densities = [0.1, 0.3, 0.6]
    res = ladder.ladder_fit(torch.Generator().manual_seed(4), m, c, grid, img, tc, oc, mk,
                            densities, device="cpu")
    gens = member_generators(torch.Generator().manual_seed(4), 3)
    for i, d in enumerate(densities):
        single = fit(gens[i], m, c, grid, img, tc, oc, dataclasses.replace(mk, density=d))
        for a, b in zip(res.params, single.params):
            for k in KEYS:
                assert torch.equal(a[k][i], b[k]), (i, k)
        for a, b in zip(res.mask_state.masks, single.mask_state.masks):
            assert torch.equal(a[i], b)
        for k, v in single.metrics.items():
            assert np.array_equal(res.metrics[k][i], v, equal_nan=True), (i, k)
    dens = res.metrics["density"][:, -1]
    assert list(dens) == sorted(dens)


def test_ladder_fit_raises():
    m, c = build_model("siren", depth=3, hidden_size=8)
    args = (torch.Generator(), m, c, get_grid(8, 8), synthetic_image(8, 8, seed=0),
            TrainConfig(num_steps=2), OptimConfig())
    with pytest.raises(ValueError, match="sparse masking"):
        ladder.ladder_fit(*args, None, [0.5])
    with pytest.raises(ValueError, match="empty"):
        ladder.ladder_fit(*args, MaskingConfig(), [])


@pytest.mark.parametrize("argv", [
    ["masking=RigL", "masking.density=0.1,0.3"],
    ["masking=Pruning", "masking.final_density=0.2,0.6", "masking.density=0.9"],
    [],
    ["masking=SNFS", "masking.density=0.05,0.1", "train.multiplier=5", "entropy_coding=zstd",
     "quant.bits=6", "train.matmul_precision_early=bfloat16", "mlp.hidden_size=182"],
    ["masking=none", "img=synthetic", "img.height=64", "img.width=64", "optim.lr=1e-3",
     "entropy_coding=lzma", "quant.row_stride=2"],
])
def test_parse_and_build_ladder_args_match_jax(argv):
    """Both packages' parse_ladder_cli and build_ladder_args on one argv
    (every case of the JAX package's test_parse_ladder_cli_axes and a few
    more): the same densities, axis and config values."""
    jcfg, jdens, jgmp = jladder.parse_ladder_cli(argv)
    tcfg, tdens, tgmp = ladder.parse_ladder_cli(argv + ["device=cpu"])
    assert (tdens, tgmp) == (jdens, jgmp)
    assert tcfg.masking == jcfg.masking
    ja, ta = jladder.build_ladder_args(jcfg), ladder.build_ladder_args(tcfg)
    np.testing.assert_array_equal(ta["img"], ja["img"])
    assert ta["mcfg"] == c_like(ta["mcfg"], ja["mcfg"])
    for name in ("masking", "train_cfg", "optim_cfg", "quant_cfg"):
        ours, theirs = dataclasses.asdict(ta[name]), dataclasses.asdict(ja[name])
        common = ours.keys() & theirs.keys()
        assert {k: ours[k] for k in common} == {k: theirs[k] for k in common}, name
    assert ta["stream_name"] == ja["stream_name"]
    assert ta["coding_kwargs"] == ja["coding_kwargs"]
    assert ta["half"] == {"auto": "auto", True: True, False: False}[ja["half"]]
    assert ta["init_params"] is ja["init_params"] is None


def c_like(ours, theirs):
    """The JAX model config's fields as the port's config class holds them."""
    return type(ours)(**{f.name: getattr(theirs, f.name) for f in dataclasses.fields(ours)})


def test_parse_ladder_cli_rejects_a_list_on_the_other_axis():
    for argv in (["masking=RigL", "masking.final_density=0.2,0.6"],
                 ["masking=Pruning", "masking.density=0.1,0.5"]):
        with pytest.raises(ValueError, match="not the ladder axis"):
            ladder.parse_ladder_cli(argv)


def test_ladder_compress_end_to_end(tmp_path):
    """The JAX package's test_ladder_compress_end_to_end (members 0.2 and
    0.8, k-means at 4 bits, zstd): each member's container decodes in the
    JAX package to the weights the port decodes and to its image, the
    denser member writes more bytes, and the decoded PSNR lies within 0.5 dB
    of the quant PSNR."""
    m, c = build_model("siren", depth=3, hidden_size=32)
    jm, jc = jbuild("siren", depth=3, hidden_size=32)
    img = synthetic_image(16, 16, seed=1)
    results = ladder.ladder_compress(
        torch.Generator().manual_seed(0), m, c, get_grid(16, 16), img,
        TrainConfig(num_steps=40, log_steps=20), OptimConfig(lr=1e-3),
        MaskingConfig(density=0.5, end_when=30, interval=10), [0.2, 0.8],
        quant_cfg=QuantConfig(bits=4, num_steps=10), stream_name="zstd",
        stream_root=str(tmp_path / "ladder"), device="cpu")
    assert len(results) == 2
    for r in results:
        assert r.compressed_bytes > 0
        assert abs(r.decoded_psnr - r.quant_psnr) < 0.5
        container = f"{r.stream_dir}/model_quantized"
        ours = tcoding.decompress_state_dict(container, "zstd")
        theirs = jcoding.decompress_state_dict(container, "zstd")
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
        j_img, _ = jcoding.decode_and_render(container, "zstd", jm, jc, 16, 16, benchmark=False)
        t_img, _ = tcoding.decode_and_render(container, "zstd", m, c, 16, 16, device="cpu")
        np.testing.assert_allclose(np.asarray(j_img), t_img, atol=2e-5)
    assert results[1].compressed_bytes > results[0].compressed_bytes


def test_ladder_cli_run_dirs_decode(tmp_path, capsys):
    """The CLI on the CPU writes one run dir per member (config.json with the
    member's density, summary.json, model_quantized/); decode_run reads each
    to its summary's decoded PSNR and decode_runs reads the ladder to the
    same images."""
    root = tmp_path / "out"
    ladder.cli(["device=cpu", "img=synthetic", "img.height=16", "img.width=16", "mlp.depth=3",
                "mlp.hidden_size=16", "train.num_steps=20", "train.log_steps=10",
                "quant.num_steps=4", "entropy_coding=zstd", "masking=RigL",
                "masking.density=0.2,0.8", f"output_dir={root}", "exp_name=t"])
    assert "LADDER 2 members" in capsys.readouterr().out
    dirs = [root / "synthetic" / "ladder_RigL_t" / f"d{d}" for d in (0.2, 0.8)]
    img = synthetic_image(16, 16, seed=stable_seed("synthetic"))
    singles = []
    for d, run in zip((0.2, 0.8), dirs):
        cfg = json.loads((run / "config.json").read_text())
        assert cfg["masking"]["density"] == d
        summary = json.loads((run / "summary.json").read_text())
        masks = np.load(run / "mask.npz")
        assert abs(sum(float(masks[k].sum()) for k in masks.files)
                   / sum(masks[k].size for k in masks.files) - d) < 0.05
        model = np.load(run / "model.npz")
        for k in masks.files:  # the fit's pruned weights are exactly 0
            w = model[k.replace(".mask", ".w")]
            assert not w[masks[k] == 0].any()
        out, _ = decompress.decode_run(run, device="cpu")
        mse = float(np.mean((np.asarray(out, np.float64) - img) ** 2))
        assert abs(10 * np.log10(1 / mse) - summary["Decoded PSNR"]) < 1e-3
        singles.append(np.asarray(out))
    together = decompress.decode_runs(dirs, device="cpu")
    for a, b in zip(together, singles):
        np.testing.assert_array_equal(a, b)
