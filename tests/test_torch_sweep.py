"""Port parity: the hyper-parameter sweeper (sweep.py). Its samplers and
store are the JAX package's pure-Python code: for seeds 0-2 parse_space,
sample, ask (tpe, random), CMAES, ask_batch and run_sweep (every sampler,
batched and not) give identical proposals and trial lists on a synthetic
objective; a sweep.jsonl written by JAX's run_sweep replays in the port's
with zero evaluations; the batched density sweep CLI runs one ladder per
round (the JAX package's test_batched_density_sweep_runs_as_ladder), a
serial one one compress run per trial; without device=cpu the CLI exits 1."""
import json
import math
import random

import numpy as np
import pytest
import torch

from implicit_image_tpu import sweep as jsweep
from implicit_image_tpu_torch import sweep as tsweep

torch.set_num_threads(1)

ARGV = ["n_trials=9", "sampler=tpe", "n_startup=3", "gamma=0.3", "lambda_kb=0.5",
        "masking.density='loguniform(0.05,0.95)'", "optim.lr=uniform(1e-4,1e-2)",
        "mlp=choice(siren,coordx)", "img=synthetic", "train.num_steps=50"]
SPACE = {"masking.density": ("loguniform", ["0.05", "0.95"]),
         "optim.lr": ("uniform", ["1e-4", "1e-2"]),
         "mlp": ("choice", ["siren", "coordx"])}


def _objective(values):
    """A smooth synthetic (PSNR, bytes) with an interior optimum."""
    d = float(values["masking.density"])
    lr = float(values.get("optim.lr", 3e-3))
    bonus = 1.5 if values.get("mlp", "siren") == "coordx" else 0.0
    psnr = 40.0 - 30.0 * (math.log(d) - math.log(0.3)) ** 2 - 2e4 * (lr - 3e-3) ** 2 + bonus
    return psnr, int(10_000 + 90_000 * d)


def _evaluator(calls):
    def evaluate(batch_values):
        calls.append(len(batch_values))
        return [_objective(v) for v in batch_values]
    return evaluate


def test_parse_space_and_sample_match_jax():
    assert tsweep.parse_space(ARGV) == jsweep.parse_space(ARGV)
    fixed, space, params = tsweep.parse_space(ARGV)
    assert space == SPACE and fixed == ["img=synthetic", "train.num_steps=50"]
    for seed in range(3):
        t, j = random.Random(seed), random.Random(seed)
        for _ in range(5):
            assert tsweep.sample(SPACE, t) == jsweep.sample(SPACE, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sampler", ["tpe", "random"])
def test_ask_matches_jax(seed, sampler):
    """ask over a growing history: the same proposal at every step."""
    t, j = random.Random(seed), random.Random(seed)
    history = []
    for _ in range(12):
        pt = tsweep.ask(SPACE, history, t, sampler=sampler, n_startup=4, gamma=0.25)
        pj = jsweep.ask(SPACE, history, j, sampler=sampler, n_startup=4, gamma=0.25)
        assert pt == pj
        history.append((pt, _objective(pt)[0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cmaes_and_ask_batch_match_jax(seed):
    cont = {k: v for k, v in SPACE.items() if v[0] != "choice"}
    cats = {k: v for k, v in SPACE.items() if v[0] == "choice"}
    t = tsweep.CMAES(list(cont), {"__cont__": cont, **cats}, random.Random(seed), popsize=4)
    j = jsweep.CMAES(list(cont), {"__cont__": cont, **cats}, random.Random(seed), popsize=4)
    for _ in range(4):
        vt, vj = t.ask(), j.ask()
        assert vt == vj
        objs = [_objective(v)[0] for v in vt]
        t.tell(objs)
        j.tell(objs)
        np.testing.assert_array_equal(t.mean, j.mean)
        assert t.sigma == j.sigma
    params = {"batch": 3, "sampler": "tpe", "n_startup": 2, "gamma": 0.25}
    history = [({"masking.density": 0.2, "optim.lr": 1e-3, "mlp": "siren"}, 20.0),
               ({"masking.density": 0.6, "optim.lr": 5e-3, "mlp": "coordx"}, 30.0)]
    assert (tsweep.ask_batch(SPACE, history, random.Random(seed), params)
            == jsweep.ask_batch(SPACE, history, random.Random(seed), params))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sampler,batch", [("tpe", 1), ("tpe", 3), ("random", 2),
                                           ("cmaes", 1), ("cmaes", 4)])
def test_run_sweep_trials_match_jax(seed, sampler, batch):
    params = {"n_trials": 10, "seed": seed, "lambda_kb": 0.5, "sampler": sampler,
              "n_startup": 3, "gamma": 0.25, "batch": batch}
    tcalls, jcalls = [], []
    t_trials, t_best = tsweep.run_sweep(_evaluator(tcalls), SPACE, dict(params))
    j_trials, j_best = jsweep.run_sweep(_evaluator(jcalls), SPACE, dict(params))
    assert t_trials == j_trials and t_best == j_best and tcalls == jcalls
    assert len(t_trials) == 10


@pytest.mark.parametrize("sampler", ["tpe", "cmaes"])
def test_jax_store_replays_in_the_port(tmp_path, sampler):
    """A store written by JAX's run_sweep replays in the port's run_sweep
    with zero evaluations and the same trials; the port's own store is the
    same file, line for line."""
    params = {"n_trials": 8, "seed": 1, "lambda_kb": 0.0, "sampler": sampler, "n_startup": 3,
              "gamma": 0.25, "batch": 2}
    jpath, tpath = tmp_path / "jax" / "sweep.jsonl", tmp_path / "port" / "sweep.jsonl"
    j_trials, _ = jsweep.run_sweep(_evaluator([]), SPACE, dict(params),
                                   store=jsweep.SweepStore(jpath, SPACE, params))
    calls = []
    t_trials, _ = tsweep.run_sweep(_evaluator(calls), SPACE, dict(params),
                                   store=tsweep.SweepStore(jpath, SPACE, params))
    assert calls == [] and t_trials == j_trials
    tsweep.run_sweep(_evaluator([]), SPACE, dict(params),
                     store=tsweep.SweepStore(tpath, SPACE, params))
    assert tpath.read_text() == jpath.read_text()


def test_batched_density_sweep_runs_as_ladder(tmp_path, monkeypatch, capsys):
    """A masking.density-only sweep with batch > 1 evaluates each round as
    one density ladder (round_0, round_1) and reports real (PSNR, bytes);
    relaunched with the same arguments it replays every trial with no
    evaluation; a batch > 1 over another space runs one compress.main per
    trial."""
    from implicit_image_tpu_torch.parallel import ladder

    monkeypatch.chdir(tmp_path)
    rounds = []
    real = ladder.ladder_compress

    def counted(*args, **kw):
        rounds.append(len(args[8]))
        return real(*args, **kw)

    monkeypatch.setattr(ladder, "ladder_compress", counted)
    argv = ["device=cpu", "n_trials=4", "batch=2", "sampler=random", "seed=0",
            "masking.density='loguniform(0.2,0.8)'", "img=synthetic", "img.height=16",
            "img.width=16", "mlp.depth=3", "mlp.hidden_size=8", "train.num_steps=30",
            "train.log_steps=30", "quant=none", "entropy_coding=zstd", "logging.use=false",
            "output_dir=sweep_out"]
    tsweep.cli(argv)
    res = json.loads((tmp_path / "outputs/sweep_results.json").read_text())
    assert len(res["trials"]) == 4 and rounds == [2, 2]
    for t in res["trials"]:
        assert np.isfinite(t["psnr"]) and t["bytes"] > 0
    assert (tmp_path / "sweep_out/round_0").exists() and (tmp_path / "sweep_out/round_1").exists()
    tsweep.cli(argv)
    again = json.loads((tmp_path / "outputs/sweep_results.json").read_text())
    assert rounds == [2, 2] and again == res

    tsweep.cli(["device=cpu", "n_trials=2", "batch=2", "optim.lr=loguniform(1e-4,1e-3)",
                "img=synthetic", "img.height=16", "img.width=16", "mlp.depth=3",
                "mlp.hidden_size=8", "train.num_steps=10", "train.log_steps=10",
                "masking=none", "quant=none", "entropy_coding=zstd", "logging.use=false",
                "output_dir=serial_out", "dir=outputs/serial"])
    assert rounds == [2, 2]
    assert sorted(p.name for p in (tmp_path / "serial_out").iterdir()) == ["trial_0", "trial_1"]
    assert "BEST objective=" in capsys.readouterr().out


def test_cli_exits_without_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.open_device("cuda")
    with pytest.raises(SystemExit) as err:
        tsweep.cli(["n_trials=1", "optim.lr=uniform(1e-4,1e-3)"])
    assert err.value.code == 1
    assert not (tmp_path / "outputs").exists()
