"""Port parity: the study analyses of implicit_image_tpu_torch.visualize
(bd_rate, width_depth, weight_removal, sequence_curve) and utils.timer /
utils.catch_error against their implicit_image_tpu counterparts on the same
inputs: BD numbers within 1e-9 relative, the same exception classes, equal
gather tables (on synthetic run stores and on one the port's compress -m
writes on the CPU), both packages' plots written, and each CLI in a process
where importing JAX raises."""
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import implicit_image_tpu.utils.catch_error as jcatch
import implicit_image_tpu.utils.timer as jtimer
import implicit_image_tpu.visualize.bd_rate as jbd
import implicit_image_tpu.visualize.sequence_curve as jseq
import implicit_image_tpu.visualize.weight_removal as jwr
import implicit_image_tpu.visualize.width_depth as jwd
import implicit_image_tpu_torch.utils as tutils
import implicit_image_tpu_torch.utils.catch_error as tcatch
import implicit_image_tpu_torch.utils.timer as ttimer
import implicit_image_tpu_torch.visualize.bd_rate as tbd
import implicit_image_tpu_torch.visualize.sequence_curve as tseq
import implicit_image_tpu_torch.visualize.weight_removal as twr
import implicit_image_tpu_torch.visualize.width_depth as twd

REPO = Path(__file__).resolve().parents[1]
BD_REL = 1e-9
# a process where importing JAX or the JAX package raises
NO_JAX = ("import runpy, sys\n"
          "for m in ('jax', 'jaxlib', 'implicit_image_tpu'):\n"
          "    sys.modules[m] = None\n")


def _ladder(rng, n, lo, hi, slope, offset, noise):
    """n (bytes, PSNR) points: log-spaced rates in [lo, hi], PSNR linear in
    log-rate plus noise."""
    rates = np.exp(np.sort(rng.uniform(np.log(lo), np.log(hi), n)))
    psnr = offset + slope * np.log10(rates) + rng.normal(0, noise, n)
    return [(float(r), float(p)) for r, p in zip(rates, psnr)]


def _curve_pairs():
    """(anchor, test) pairs, each made from a seed with numpy."""
    rng = np.random.default_rng(27)
    overlapping = (_ladder(rng, 5, 2e3, 9e4, 8.0, 2.0, 0.1),
                   _ladder(rng, 6, 3e3, 1.2e5, 8.5, 2.5, 0.1))
    anchor = _ladder(rng, 5, 2e3, 9e4, 7.0, 5.0, 0.05)
    duplicates = (anchor + [anchor[1], (anchor[3][0], anchor[3][1] + 0.4)],
                  _ladder(rng, 4, 1e3, 6e4, 7.5, 4.0, 0.05))
    rung = _ladder(rng, 6, 5e3, 2e5, 6.0, 8.0, 0.0)
    rung[3] = (rung[3][0], rung[2][1] - 0.7)  # a PSNR rung below the one before
    non_monotone = (_ladder(rng, 5, 4e3, 1.5e5, 6.2, 7.0, 0.1), rung)
    # the rates do not overlap, the PSNR ranges do: BD-rate defined, BD-PSNR not
    disjoint = tuple([(r, off + 9.0 * np.log10(r) + float(rng.normal(0, 0.05))) for r in rates]
                     for rates, off in (((1e3, 2.5e3, 5e3, 9e3), 3.0),
                                        ((2e4, 4e4, 9e4, 2e5), -8.5)))
    three_points = (_ladder(rng, 3, 2e3, 5e4, 7.0, 4.0, 0.1),
                    _ladder(rng, 2, 3e3, 4e4, 7.2, 4.2, 0.0))
    return {"overlapping": overlapping, "duplicate_rates": duplicates,
            "non_monotone_rung": non_monotone, "disjoint_rates": disjoint,
            "three_and_two_points": three_points}


def _outcome(fn, anchor, test):
    try:
        return fn(anchor, test)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e)


@pytest.mark.parametrize("name", list(_curve_pairs()))
@pytest.mark.parametrize("fn", ["bd_rate", "bd_psnr"])
def test_bd_numbers_match_jax(name, fn):
    """bd_rate / bd_psnr of the port equal JAX's within 1e-9 relative, both
    ways round; where JAX raises, the port raises the same class."""
    anchor, test = _curve_pairs()[name]
    for a, t in ((anchor, test), (test, anchor)):
        ours = _outcome(getattr(tbd, fn), a, t)
        theirs = _outcome(getattr(jbd, fn), a, t)
        if isinstance(theirs, type):
            assert ours is theirs
        else:
            assert isinstance(ours, float) and np.isfinite(ours)
            assert abs(ours - theirs) <= BD_REL * max(abs(theirs), 1.0)
    if name == "disjoint_rates":
        assert isinstance(_outcome(tbd.bd_rate, anchor, test), float)
        assert _outcome(tbd.bd_psnr, anchor, test) is ValueError


@pytest.mark.parametrize("name", ["overlapping", "non_monotone_rung"])
def test_bd_of_a_curve_against_itself_is_zero(name):
    curve = _curve_pairs()[name][0]
    for mod in (tbd, jbd):
        assert abs(mod.bd_rate(curve, curve)) <= 1e-9
        assert abs(mod.bd_psnr(curve, curve)) <= 1e-9


@pytest.mark.parametrize("points", [
    [(1000.0, 30.0)],                                # one point
    [(1000.0, 30.0), (1000.0, 31.0)],                # one distinct rate
    [(0.0, 30.0), (2000.0, 33.0), (4000.0, 35.0)],   # a rate of 0
    [(-5.0, 20.0), (2000.0, 33.0)],                  # a negative rate
])
def test_bd_errors_match_jax(points):
    good = [(1500.0, 31.0), (3000.0, 34.0), (6000.0, 36.5)]
    for fn in ("bd_rate", "bd_psnr"):
        for a, t in ((points, good), (good, points)):
            assert _outcome(getattr(jbd, fn), a, t) is ValueError
            assert _outcome(getattr(tbd, fn), a, t) is ValueError


def test_bd_curves_without_overlap_raise_as_jax():
    low = [(1e3, 20.0), (2e3, 22.0), (4e3, 24.0)]
    high = [(1e5, 40.0), (2e5, 42.0), (4e5, 44.0)]
    for fn in ("bd_rate", "bd_psnr"):
        assert _outcome(getattr(jbd, fn), low, high) is ValueError
        assert _outcome(getattr(tbd, fn), low, high) is ValueError


def _write_run(d: Path, summary: dict, config=None):
    d.mkdir(parents=True)
    (d / "summary.json").write_text(json.dumps(summary))
    (d / "metrics.jsonl").write_text(json.dumps({"step": 1, "PSNR": 1.0}) + "\n")
    if config is not None:
        (d / "config.json").write_text(json.dumps(config))


def _rd_stores(root: Path):
    """Two run trees of (bytes, decoded PSNR) points and a run without
    bytes, the second with a duplicate rate."""
    anchor, test = _curve_pairs()["overlapping"]
    for name, curve in (("anchor", anchor), ("test", test + [test[2]])):
        for i, (r, p) in enumerate(curve):
            _write_run(root / name / f"synthetic/run{i}",
                       {"Compressed Bytes": r, "Decoded PSNR": p, "PSNR": p + 1.0})
    _write_run(root / "anchor/synthetic/fit_only", {"PSNR": 30.0})
    return root / "anchor", root / "test"


@pytest.mark.parametrize("metric", ["Decoded PSNR", "PSNR"])
def test_curve_from_runs_matches_jax(tmp_path, metric):
    for root in _rd_stores(tmp_path):
        ours = tbd.curve_from_runs(root, metric)
        assert ours == jbd.curve_from_runs(root, metric)
        assert len(ours) >= 5
    for mod in (tbd, jbd):
        with pytest.raises(FileNotFoundError):
            mod.curve_from_runs(tmp_path / "absent", metric)


@pytest.mark.parametrize("extra", [[], ["--metric", "PSNR"]])
def test_bd_rate_cli_without_jax_matches_jax_cli(tmp_path, capsys, extra):
    """The port's CLI, in a process where importing JAX raises, prints the
    JSON the JAX CLI prints."""
    anchor, test = _rd_stores(tmp_path)
    argv = [str(anchor), str(test), *extra]
    jbd.main(argv)
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    code = NO_JAX + (
        f"sys.argv = ['bd_rate', *{argv!r}]\n"
        "runpy.run_module('implicit_image_tpu_torch.visualize.bd_rate', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    ours = json.loads(res.stdout.strip().splitlines()[-1])
    assert ours == theirs
    assert set(ours) == {"anchor", "test", "metric", "anchor_points", "test_points",
                         "bd_rate_pct", "bd_psnr_db"}


@pytest.mark.parametrize("argv", [[], ["a"], ["a", "b", "--metric"]])
def test_bd_rate_cli_usage_errors_match_jax(argv):
    for mod in (tbd, jbd):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        assert isinstance(e.value.code, str)


def _width_depth_store(root: Path):
    """Run dirs named as compress -m names them, over models, widths and
    depths, with and without Quant PSNR; dirs without the tokens; a run
    without PSNR."""
    rng = np.random.default_rng(5)
    for mlp, widths, depths in (("", (64, 128), (4, 8)), ("mlp=fourier,", (96,), (6, 10)),
                                ("mlp=coordx,mlp.split_depth=5,", (96,), (3,))):
        for w in widths:
            for d in depths:
                summary = {"PSNR": float(rng.uniform(20, 40))}
                if (w + d) % 3:
                    summary["Quant PSNR"] = summary["PSNR"] - float(rng.uniform(0, 2))
                _write_run(root / f"{mlp}mlp.hidden_size={w},mlp.depth={d},masking=none,"
                           "quant=none,entropy_coding=none", summary)
    _write_run(root / "img=synthetic,masking.density=0.5", {"PSNR": 33.0})
    _write_run(root / "mlp.hidden_size=256", {"PSNR": 34.0})
    _write_run(root / "mlp.hidden_size=256,mlp.depth=4,seed=1", {"Quant PSNR": 30.0})
    _write_run(root / "nested/mlp.hidden_size=256,mlp.depth=6", {"PSNR": 35.5})


def test_width_depth_gather_matches_jax(tmp_path):
    _width_depth_store(tmp_path)
    ours = twd.gather(tmp_path)
    assert ours == jwd.gather(tmp_path)
    assert set(ours) == {"siren", "fourier", "coordx"}
    assert len(ours["siren"]) == 5
    # coordx's split_depth=5 comes first in the name: the first depth= token
    assert set(ours["coordx"]) == {(96, 5)}
    assert twd.gather(tmp_path / "absent") == jwd.gather(tmp_path / "absent") == {}


def _weight_removal_store(root: Path):
    """Run stores covering every branch of _classify and gather."""
    siren = {"name": "siren", "hidden_size": 128, "depth": 8}
    protocol = {"multiplier": 5}
    rng = np.random.default_rng(9)

    def psnr():
        return float(rng.uniform(20, 45))

    for method in ("RigL", "SNFS"):
        for dens in (0.1, 0.25, 0.5):
            _write_run(root / f"cfg/{method}/d{dens}", {"PSNR": psnr(), "Quant PSNR": psnr()},
                       {"masking": {"name": method, "density": dens}, "mlp": siren,
                        "train": protocol})
    for dens in (0.1, 0.5):  # GMP: the study axis is final_density
        _write_run(root / f"cfg/Pruning/d{dens}", {"PSNR": psnr()},
                   {"masking": {"name": "Pruning", "density": 1.0, "final_density": dens},
                    "mlp": siren, "train": protocol})
    _write_run(root / "cfg/Pruning/no_final", {"PSNR": psnr()},
               {"masking": {"name": "Pruning", "density": 0.3}, "mlp": siren})
    _write_run(root / "cfg/Small_Dense", {"PSNR": psnr()},
               {"masking": {"name": "Small_Dense", "density": 0.2, "dense": True},
                "mlp": {"name": "siren", "hidden_size": 57}})
    _write_run(root / "cfg/Feathermap", {"PSNR": psnr()},
               {"masking": {"name": "Feathermap", "density": 0.2, "dense": True}, "mlp": siren})
    # masking=none: the protocol point gives the dense line, the others do not
    _write_run(root / "cfg/dense_protocol", {"PSNR": 41.5, "Quant PSNR": 40.25},
               {"masking": {"name": "none"}, "mlp": siren, "train": protocol})
    _write_run(root / "cfg/dense_w256", {"PSNR": 44.0},
               {"masking": {"name": "none"}, "mlp": {**siren, "hidden_size": 256},
                "train": protocol})
    _write_run(root / "cfg/dense_d4", {"PSNR": 39.0},
               {"masking": {}, "mlp": {**siren, "depth": 4}, "train": protocol})
    _write_run(root / "cfg/dense_x1", {"PSNR": 38.0},
               {"masking": None, "mlp": siren, "train": {"multiplier": 1}})
    # a wavelet-SIREN RigL point: skipped
    _write_run(root / "cfg/wavelet", {"PSNR": 50.0},
               {"masking": {"name": "RigL", "density": 0.25},
                "mlp": {"name": "wavelet_siren", "hidden_size": 128}})
    # a store without config.json: the dir names decide
    for name in ("masking=RigL,masking.density=0.05", "masking=SNFS,masking.density=0.75",
                 "masking=Pruning", "masking=none,mlp.hidden_size=64",
                 "img=synthetic,seed=3"):
        _write_run(root / "names" / name, {"PSNR": psnr()})
    _write_run(root / "names/no_psnr,masking=RigL,masking.density=0.5", {"Quant PSNR": 30.0})


@pytest.mark.parametrize("sub", ["", "cfg", "names"])
def test_weight_removal_gather_matches_jax(tmp_path, sub):
    _weight_removal_store(tmp_path)
    ours = twr.gather(tmp_path / sub)
    theirs = jwr.gather(tmp_path / sub)
    assert (dict(ours[0]), ours[1]) == (dict(theirs[0]), theirs[1])
    if sub == "cfg":
        assert ours[1] == 40.25
        assert sorted(ours[0]) == ["Feathermap", "Pruning", "RigL", "SNFS", "Small_Dense"]
        assert sorted(d for d, _ in ours[0]["Pruning"]) == [0.1, 0.3, 0.5]
        assert all(p != 50.0 for pts in ours[0].values() for _, p in pts)


def test_weight_removal_classify_matches_jax(tmp_path):
    _weight_removal_store(tmp_path)
    runs = twr.collect_runs(tmp_path)
    assert len(runs) > 20
    for run in runs:
        assert twr._classify(run) == jwr._classify(run), run["dir"]


@pytest.mark.parametrize("which", ["width_depth", "weight_removal"])
def test_study_plots_match_jax(tmp_path, which):
    """Both packages write the plot for the same store."""
    (_width_depth_store if which == "width_depth" else _weight_removal_store)(tmp_path / "runs")
    mods = {"width_depth": (twd, jwd), "weight_removal": (twr, jwr)}[which]
    for tag, mod in zip(("torch", "jax"), mods):
        out = tmp_path / f"{tag}.pdf"
        assert Path(mod.plot(tmp_path / "runs", out)) == out
        assert out.stat().st_size > 0


def _seq_dir(root: Path) -> Path:
    rng = np.random.default_rng(3)
    kinds = ["I", "P", "P", "P", "I", "P"]
    rows = [{"frame": f"frame_{t:04d}", "kind": k, "steps": 200 if k == "I" else 50,
             "decoded_psnr": round(float(rng.uniform(30, 40)), 2),
             "bytes": int(rng.integers(40000, 70000)), "wall_s": 1.0}
            for t, k in enumerate(kinds)]
    d = root / "seq_seqbench"
    d.mkdir(parents=True)
    summary = {"frames": len(rows), "bytes_per_frame": float(np.mean([r["bytes"] for r in rows])),
               "mean_decoded_psnr": round(float(np.mean([r["decoded_psnr"] for r in rows])), 2),
               "rows": rows}
    (d / "seq_summary.json").write_text(json.dumps(summary, indent=2))
    return d


def test_sequence_curve_matches_jax(tmp_path):
    """Both packages write the PDF for the same seq_summary.json (to --out
    and to the default path); the port's reader gives the rows."""
    seq = _seq_dir(tmp_path)
    assert tseq.load_summary(seq) == json.loads((seq / "seq_summary.json").read_text())
    for tag, mod in (("torch", tseq), ("jax", jseq)):
        out = tmp_path / f"{tag}.pdf"
        assert Path(mod.plot_sequence(seq, out)) == out and out.stat().st_size > 0
    default = tseq.plot_sequence(seq)
    assert default == seq / "sequence_curve.pdf" and default.stat().st_size > 0


def test_sequence_curve_without_summary_raises_as_jax(tmp_path):
    for mod, cli in ((tseq, "implicit_image_tpu_torch.sequence"),
                     (jseq, "implicit_image_tpu.sequence")):
        with pytest.raises(FileNotFoundError, match="seq_summary.json not found") as e:
            mod.plot_sequence(tmp_path)
        assert f"python -m {cli} " in str(e.value)
    with pytest.raises(FileNotFoundError):
        tseq.load_summary(tmp_path)


def test_plots_without_matplotlib_name_it(tmp_path, monkeypatch):
    """Without matplotlib (the GPU machine has none) each plot raises
    ImportError naming it; the readers run."""
    _width_depth_store(tmp_path / "wd")
    _weight_removal_store(tmp_path / "wr")
    seq = _seq_dir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for call in (lambda: twd.plot(tmp_path / "wd", tmp_path / "a.pdf"),
                 lambda: twr.plot(tmp_path / "wr", tmp_path / "b.pdf"),
                 lambda: tseq.plot_sequence(seq, tmp_path / "c.pdf")):
        with pytest.raises(ImportError, match="'matplotlib' package"):
            call()
    assert twd.gather(tmp_path / "wd") and twr.gather(tmp_path / "wr")[0]
    assert tseq.load_summary(seq)["frames"] == 6


@pytest.mark.parametrize("which", ["width_depth", "weight_removal", "sequence_curve"])
def test_study_cli_runs_without_jax(tmp_path, which):
    """`python -m implicit_image_tpu_torch.visualize.<which>` in a process
    where importing JAX raises writes its plot."""
    out = tmp_path / "plot.pdf"
    if which == "sequence_curve":
        args = [str(_seq_dir(tmp_path)), "--out", str(out)]
    else:
        (_width_depth_store if which == "width_depth" else _weight_removal_store)(
            tmp_path / "runs")
        args = [f"outputs_root={tmp_path / 'runs'}", f"out={out}"]
    code = NO_JAX + (
        f"sys.argv = [{which!r}, *{args!r}]\n"
        f"runpy.run_module('implicit_image_tpu_torch.visualize.{which}', run_name='__main__')\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert out.stat().st_size > 0


COMMON = ["img=synthetic", "img.height=16", "img.width=16", "mlp.depth=3",
          "mlp.hidden_size=16", "train.num_steps=6", "train.log_steps=3", "quant.num_steps=2",
          "device=cpu"]


def test_port_run_store_feeds_both_packages_analyses(tmp_path):
    """The port's compress -m on the CPU (16², d3, w16, a few steps) over two
    densities and masking=none: both packages' gather give equal tables, and
    both curve_from_runs the same points."""
    from implicit_image_tpu_torch import compress

    store = tmp_path / "store"
    compress.cli(["-m", *COMMON, "masking.density=0.25,0.5", f"output_dir={store}"])
    compress.cli(["-m", *COMMON, "masking=none", f"output_dir={store}"])
    runs = twr.collect_runs(store, require=["PSNR"])
    assert len(runs) == 3 and all("config" in r for r in runs)

    ours, theirs = twr.gather(store), jwr.gather(store)
    assert (dict(ours[0]), ours[1]) == (dict(theirs[0]), theirs[1])
    assert sorted(d for d, _ in ours[0]["RigL"]) == [0.25, 0.5]
    assert ours[1] is None  # w16 d3 is not the protocol's dense control
    assert sorted(twr._classify(r) for r in runs) == sorted(jwr._classify(r) for r in runs)

    wd = twd.gather(store)
    assert wd == jwd.gather(store) and set(wd["siren"]) == {(16, 3)}
    assert tbd.curve_from_runs(store) == jbd.curve_from_runs(store)
    assert all(np.isfinite(p) and b > 0 for b, p in tbd.curve_from_runs(store))


@pytest.mark.parametrize("mod", [ttimer, jtimer], ids=["torch", "jax"])
def test_catchtime_elapsed_grows(mod):
    with mod.catchtime() as t:
        first = t()
        time.sleep(0.01)
        second = t()
    assert 0.0 < first < second and second >= 0.01
    assert t() >= second


@pytest.mark.parametrize("mod", [tcatch, jcatch], ids=["torch", "jax"])
def test_catch_error_decorator_exits_1_with_the_traceback(mod, caplog):
    @mod.catch_error_decorator
    def fails(x):
        raise RuntimeError(f"boom {x}")

    @mod.catch_error_decorator
    def works(x, y=1):
        """doc"""
        return x + y

    assert works(2, y=3) == 5 and works.__name__ == "works" and works.__doc__ == "doc"
    with caplog.at_level(logging.ERROR):
        with pytest.raises(SystemExit) as e:
            fails(7)
    assert e.value.code == 1
    assert "Traceback" in caplog.text and "RuntimeError: boom 7" in caplog.text


@pytest.mark.parametrize("mod", [tcatch, jcatch], ids=["torch", "jax"])
@pytest.mark.parametrize("code", [0, 3, "usage"])
def test_catch_error_decorator_passes_system_exit(mod, code, caplog):
    @mod.catch_error_decorator
    def exits():
        raise SystemExit(code)

    with caplog.at_level(logging.ERROR):
        with pytest.raises(SystemExit) as e:
            exits()
    assert e.value.code == code and "Traceback" not in caplog.text


def test_utils_exports_the_moved_decorator():
    """implicit_image_tpu_torch.utils exports catchtime and the decorator from
    their own modules, as the JAX package's utils does."""
    assert tutils.catch_error_decorator is tcatch.catch_error_decorator
    assert tutils.catchtime is ttimer.catchtime
    import implicit_image_tpu.utils as jutils

    assert set(jutils.__all__) - set(tutils.__all__) == {"cost_analysis"}
