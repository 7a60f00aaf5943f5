"""Hyper-parameter sweeper (counterpart of implicit_image_tpu/sweep.py, the
reference's Optuna / Ax sweepers without their dependencies).

  * random search over `key=uniform(a,b)` / `key=loguniform(a,b)` /
    `key=choice(a,b,c)` spaces;
  * `sampler=tpe` (the default after n_startup random trials): a
    Tree-structured Parzen Estimator per dimension (the history split at
    the gamma quantile of the objective, good and bad sets as Parzen
    windows in the unit-transformed space, weighted counts for choices;
    the candidate maximizing l(x)/g(x));
  * `sampler=cmaes`: (mu/mu_w, lambda) CMA-ES over the continuous
    dimensions, categorical ones drawn with weights tilted toward the
    selected proposals;
  * the objective: PSNR (default) or PSNR - lambda_kb * KB, maximized;
  * persistence: every completed trial appends to `<dir>/sweep.jsonl`
    (dir=outputs/sweep); a sweep relaunched with the same space, sampler
    and seed replays the record against the deterministic proposal
    sequence and resumes where it stopped; `resume=0` disables the store.

The samplers and the store are the JAX package's, pure Python on
random.Random (CMA-ES's linear algebra in numpy): the same seed gives the
same proposals in both packages, and either package replays the other's
store. A trial runs compress.main; with batch > 1 and masking.density the
only sampled key, each round of `batch` proposals runs as one density
ladder (parallel/ladder.ladder_compress, one fit over the member axis,
every round's members drawing from a generator seeded with the config's
seed); another space with batch > 1 runs its trials one by one, with a
warning. Trials run on the card (`device`, default "cuda": RuntimeError
without one; `device=cpu` runs the plain versions); the kernels build
before the first trial.

    python -m implicit_image_tpu_torch.sweep n_trials=15 seed=0 sampler=tpe \
        masking.density='loguniform(0.05,0.95)' img=synthetic train.num_steps=500
"""
from __future__ import annotations

import json
import logging
import math
import random
import re
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from implicit_image_tpu_torch.config import compose
from implicit_image_tpu_torch.ops.cuda_build import open_device
from implicit_image_tpu_torch.utils import catch_error_decorator

__all__ = ["parse_space", "ask_tpe", "sample_random", "ask", "CMAES", "ask_batch", "SweepStore",
           "run_sweep", "sample", "cli"]

log = logging.getLogger("implicit_image_tpu_torch")

_DIST = re.compile(r"(uniform|loguniform|choice)\((.*)\)$")


def parse_space(overrides: List[str]):
    """Split CLI args into (fixed overrides, sampled space, sweep params)."""
    fixed, space = [], {}
    params = {
        "n_trials": 15,
        "seed": 0,
        "lambda_kb": 0.0,
        "sampler": "tpe",  # tpe | random | cmaes
        "n_startup": 5,
        "gamma": 0.25,
        # trials proposed AND evaluated per round; >1 with a
        # masking.density-only space runs each round as ONE density
        # ladder (one fit over the member axis for B trials)
        "batch": 1,
        # trial persistence/resume (the reference's Optuna sweeper keeps
        # its study in sqlite and resumes — conf/hydra/sweeper/optuna.yaml):
        # completed trials append to <dir>/sweep.jsonl; a relaunch with
        # resume=1 (default) replays them instead of re-evaluating
        "dir": "outputs/sweep",
        "resume": 1,
    }
    for ov in overrides:
        key, _, val = ov.partition("=")
        if key in params:
            if isinstance(params[key], str):
                params[key] = val.strip()
            else:
                params[key] = type(params[key])(float(val))
            continue
        m = _DIST.match(val.strip().strip("'\""))
        if m:
            kind, args = m.group(1), m.group(2).split(",")
            space[key] = (kind, args)
        else:
            fixed.append(ov)
    return fixed, space, params


def _to_unit(kind, args, v: float) -> float:
    lo, hi = float(args[0]), float(args[1])
    if kind == "loguniform":
        return (math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo))
    return (v - lo) / (hi - lo)


def _from_unit(kind, args, u: float):
    lo, hi = float(args[0]), float(args[1])
    u = min(max(u, 0.0), 1.0)
    if kind == "loguniform":
        return math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    return lo + u * (hi - lo)


def _parzen_logpdf(x: float, centers: Sequence[float], bw: float) -> float:
    """log of a uniform-mixture-of-Gaussians Parzen window on [0,1]
    (plus one prior component centered at 0.5 with unit-range bandwidth)."""
    cs = list(centers) + [0.5]
    bws = [bw] * len(centers) + [1.0]
    acc = 0.0
    for c, b in zip(cs, bws):
        acc += math.exp(-0.5 * ((x - c) / b) ** 2) / (b * math.sqrt(2 * math.pi))
    return math.log(acc / len(cs) + 1e-300)


def ask_tpe(
    space: Dict,
    history: List[Tuple[Dict[str, object], float]],
    rng: random.Random,
    gamma: float = 0.25,
    n_candidates: int = 24,
) -> Dict[str, object]:
    """Propose the next point: per-dimension TPE over `history` =
    [(values dict, objective)], maximizing objective."""
    n_good = max(1, int(math.ceil(gamma * len(history))))
    ranked = sorted(history, key=lambda t: -t[1])
    good, bad = ranked[:n_good], ranked[n_good:] or ranked[:1]

    out: Dict[str, object] = {}
    for key, (kind, args) in space.items():
        if kind == "choice":
            options = [a.strip() for a in args]
            # weighted counts with add-one smoothing
            gw = {o: 1.0 for o in options}
            bw_ = {o: 1.0 for o in options}
            for vals, _ in good:
                gw[str(vals[key])] += 1.0
            for vals, _ in bad:
                bw_[str(vals[key])] += 1.0
            gs, bs = sum(gw.values()), sum(bw_.values())
            out[key] = max(options, key=lambda o: (gw[o] / gs) / (bw_[o] / bs))
            continue
        g_pts = [_to_unit(kind, args, float(v[key])) for v, _ in good]
        b_pts = [_to_unit(kind, args, float(v[key])) for v, _ in bad]
        bw_g = max(1.0 / max(len(g_pts), 1) ** 0.5 * 0.5, 0.05)
        bw_b = max(1.0 / max(len(b_pts), 1) ** 0.5 * 0.5, 0.05)
        best_u, best_score = 0.5, -1e18
        for _ in range(n_candidates):
            # draw from l(x): pick a good center, jitter by its bandwidth
            c = rng.choice(g_pts) if g_pts else 0.5
            u = min(max(rng.gauss(c, bw_g), 0.0), 1.0)
            score = _parzen_logpdf(u, g_pts, bw_g) - _parzen_logpdf(
                u, b_pts, bw_b
            )
            if score > best_score:
                best_u, best_score = u, score
        out[key] = _from_unit(kind, args, best_u)
    return out


def sample_random(space: Dict, rng: random.Random) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for key, (kind, args) in space.items():
        if kind == "uniform":
            out[key] = rng.uniform(float(args[0]), float(args[1]))
        elif kind == "loguniform":
            out[key] = math.exp(
                rng.uniform(math.log(float(args[0])), math.log(float(args[1])))
            )
        else:  # choice
            out[key] = rng.choice(args).strip()
    return out


def ask(space, history, rng, sampler="tpe", n_startup=5, gamma=0.25):
    """Next point to evaluate: random during startup (or sampler=random),
    TPE afterwards."""
    if sampler == "random" or len(history) < n_startup or not space:
        return sample_random(space, rng)
    return ask_tpe(space, history, rng, gamma)


class CMAES:
    """(μ/μ_w, λ) CMA-ES over the unit-transformed continuous dimensions —
    the second model-based sampler (the reference ships BOTH Optuna TPE
    and Ax, conf/hydra/sweeper/{optuna,ax}.yaml; this is the Ax-class
    counterpart). Naturally batched: ask() yields a full population per
    generation, which the batched ask-tell loop evaluates as ONE density
    ladder when the space permits (run_sweep). Categorical dimensions
    are drawn randomly with weights tilted toward values seen in the
    top-μ (selected) proposals of earlier generations.

    Standard Hansen update equations (rank-μ + rank-1 covariance update,
    cumulative step-size adaptation), maximization convention.
    """

    def __init__(self, cont_keys, cat_space, rng, popsize=None, sigma0=0.3):
        import numpy as np

        self.np = np
        self.keys = list(cont_keys)
        self.cat_space = dict(cat_space)
        self.rng = rng
        n = max(len(self.keys), 1)
        self.n = n
        # λ ≥ 2 / μ ≥ 1 always: popsize 1 would give μ=0 → μ_eff = 1/0
        self.lam = max(popsize or (4 + int(3 * math.log(n))), 2)
        self.mu = max(self.lam // 2, 1)
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mueff = 1.0 / (self.w**2).sum()
        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2.0 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(
            1 - self.c1,
            2 * (self.mueff - 2 + 1 / self.mueff) / ((n + 2) ** 2 + self.mueff),
        )
        self.damps = 1 + 2 * max(0, math.sqrt((self.mueff - 1) / (n + 1)) - 1) + self.cs
        self.chi_n = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
        self.mean = np.full(n, 0.5)
        self.sigma = sigma0
        self.C = np.eye(n)
        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.gen = 0
        self._pending = None
        self._pending_cats = None
        # per-categorical-key counts of values among selected (top-μ)
        # proposals; draw weights are 1 + count
        self._cat_good = {
            k: {} for k in self.cat_space if k != "__cont__"
        }

    def ask(self, k=None):
        """Propose k points (default: the population size λ)."""
        np = self.np
        k = k or self.lam
        d, B = np.linalg.eigh(self.C)
        d = np.sqrt(np.maximum(d, 1e-20))
        zs = np.array(
            [[self.rng.gauss(0, 1) for _ in range(self.n)] for _ in range(k)]
        )
        ys = zs @ np.diag(d) @ B.T
        xs = np.clip(self.mean + self.sigma * ys, 0.0, 1.0)
        values = [self._to_values(x) for x in xs]
        self._pending = (xs, ys)
        self._pending_cats = [
            {k: v[k] for k in self._cat_good} for v in values
        ]
        return values

    def _to_values(self, x):
        out = {}
        for i, key in enumerate(self.keys):
            kind, args = self.cat_space["__cont__"][key]
            out[key] = _from_unit(kind, args, float(x[i]))
        for key, spec in self.cat_space.items():
            if key == "__cont__":
                continue
            _, args = spec
            choices = [c.strip() for c in args]
            good = self._cat_good[key]
            weights = [1.0 + good.get(c, 0) for c in choices]
            out[key] = self.rng.choices(choices, weights=weights, k=1)[0]
        return out

    def tell(self, objectives):
        """Update from the objectives of the last ask() batch (same order)."""
        np = self.np
        xs, ys = self._pending
        # the tail round of a sweep may evaluate fewer than λ proposals;
        # select among what was actually scored and renormalize weights
        order = np.argsort(-np.asarray(objectives))[: self.mu]
        y_sel = ys[order]
        w = self.w[: len(order)]
        w = w / w.sum()
        for idx in order:
            for key, val in self._pending_cats[int(idx)].items():
                self._cat_good[key][val] = self._cat_good[key].get(val, 0) + 1
        y_w = w @ y_sel
        self.mean = np.clip(self.mean + self.sigma * y_w, 0.0, 1.0)
        # step-size path (C^-1/2 y_w)
        d, B = np.linalg.eigh(self.C)
        d = np.sqrt(np.maximum(d, 1e-20))
        c_inv_half = B @ np.diag(1.0 / d) @ B.T
        self.ps = (1 - self.cs) * self.ps + math.sqrt(
            self.cs * (2 - self.cs) * self.mueff
        ) * (c_inv_half @ y_w)
        hsig = float(
            np.linalg.norm(self.ps)
            / math.sqrt(1 - (1 - self.cs) ** (2 * (self.gen + 1)))
            < (1.4 + 2 / (self.n + 1)) * self.chi_n
        )
        self.pc = (1 - self.cc) * self.pc + hsig * math.sqrt(
            self.cc * (2 - self.cc) * self.mueff
        ) * y_w
        rank_mu = sum(wi * np.outer(y, y) for wi, y in zip(w, y_sel))
        self.C = (
            (1 - self.c1 - self.cmu) * self.C
            + self.c1
            * (np.outer(self.pc, self.pc) + (1 - hsig) * self.cc * (2 - self.cc) * self.C)
            + self.cmu * rank_mu
        )
        self.sigma *= math.exp(
            (self.cs / self.damps) * (np.linalg.norm(self.ps) / self.chi_n - 1)
        )
        self.sigma = min(self.sigma, 1.0)
        self.gen += 1
        self._pending = None
        self._pending_cats = None


def ask_batch(space, history, rng, params, cma=None):
    """Propose a batch of `batch` points for one evaluation round.

    TPE/random use the constant-liar strategy (each pending point is
    temporarily told the round's worst-known objective so later asks in
    the round diversify); CMA-ES asks its population directly.
    """
    b = int(params.get("batch", 1))
    sampler = str(params["sampler"])
    if sampler == "cmaes" and cma is not None:
        return cma.ask(b if b > 1 else None)
    liar = min((obj for _, obj in history), default=0.0)
    fake = list(history)
    out = []
    for _ in range(b):
        v = ask(
            space, fake, rng,
            sampler=sampler,
            n_startup=int(params["n_startup"]),
            gamma=float(params["gamma"]),
        )
        out.append(v)
        fake = fake + [(v, liar)]
    return out


class SweepStore:
    """Append-only trial log: one JSON line per completed trial, headed by
    a fingerprint of (space, sampler, seed, lambda_kb, batch). Replaces
    the reference Optuna sweeper's sqlite storage
    (conf/hydra/sweeper/optuna.yaml) for kill/resume durability."""

    def __init__(self, path, space, params):
        self.path = Path(path)
        self.fingerprint = {
            "space": {k: [v[0], [str(a) for a in v[1]]]
                      for k, v in sorted(space.items())},
            "sampler": str(params["sampler"]),
            "seed": int(params["seed"]),
            "lambda_kb": float(params["lambda_kb"]),
            "batch": int(params.get("batch", 1)),
        }

    def load(self) -> List[dict]:
        """Prior trials if the file exists AND its fingerprint matches;
        a changed space/sampler/seed invalidates replay (the proposal
        sequence would diverge) — then [] and the file is re-headed."""
        if not self.path.exists():
            return []
        lines = self.path.read_text().splitlines()
        if not lines:
            return []
        head = json.loads(lines[0])
        if head.get("_sweep") != self.fingerprint:
            log.warning(
                "sweep store %s was written under a different "
                "space/sampler/seed; starting fresh", self.path,
            )
            return []
        return [json.loads(ln) for ln in lines[1:] if ln.strip()]

    def append(self, trial: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists() or not self.path.read_text().strip():
            self.path.write_text(
                json.dumps({"_sweep": self.fingerprint}) + "\n"
            )
        with self.path.open("a") as f:
            f.write(json.dumps(trial) + "\n")

    def truncate(self, n_keep: int) -> None:
        """Keep the header + the first n_keep trials (desync recovery:
        stale tail lines must not survive into the next resume)."""
        if not self.path.exists():
            return
        lines = self.path.read_text().splitlines()
        self.path.write_text("\n".join(lines[: 1 + n_keep]) + "\n")


def run_sweep(evaluate_batch, space, params, rng=None, store=None):
    """Driver shared by the CLI and tests: ask a batch, evaluate it (ONE
    call — the evaluator may fit the whole batch together), tell, repeat.

    evaluate_batch(values_list) -> [(psnr, bytes), ...] in order.
    Returns (trials, best_overrides).

    `store` (SweepStore) persists each completed trial; on relaunch the
    recorded results REPLAY against the deterministic proposal sequence
    (same seed -> same asks for every sampler, including CMA-ES, whose
    internal state is rebuilt by replaying ask/tell) so a killed sweep
    resumes where it stopped instead of restarting from zero. A proposal
    that stops matching the record (e.g. nondeterministic evaluator noise
    fed back into the asks) discards the remaining record and resumes
    live evaluation from that point.
    """
    rng = rng or random.Random(int(params["seed"]))
    recorded = store.load() if store is not None else []
    replayed = 0
    cma = None
    if str(params["sampler"]) == "cmaes":
        cont = {k: v for k, v in space.items() if v[0] != "choice"}
        cats = {k: v for k, v in space.items() if v[0] == "choice"}
        b = int(params.get("batch", 1))
        cma = CMAES(
            list(cont),
            {"__cont__": cont, **cats},
            rng,
            # batch<=1 means "no explicit population": use the default λ
            popsize=b if b > 1 else None,
        )
    history: List[Tuple[Dict[str, object], float]] = []
    trials = []
    best: Tuple[float, Dict[str, object]] = (-1e18, {})
    t = 0
    n_trials = int(params["n_trials"])
    while t < n_trials:
        batch_values = ask_batch(space, history, rng, params, cma)
        batch_values = batch_values[: n_trials - t]
        proposed_strs = [
            {k: str(v) for k, v in values.items()} for values in batch_values
        ]
        head = recorded[: len(batch_values)]
        if head and len(head) == len(batch_values) and all(
            r["values"] == p for r, p in zip(head, proposed_strs)
        ):
            # replay: this whole round was already evaluated pre-kill
            results = [(r["psnr"], r["bytes"]) for r in head]
            recorded = recorded[len(head):]
            replayed += len(head)
            fresh = False
        else:
            if recorded:
                log.warning(
                    "sweep store desynced after %d replayed trials "
                    "(proposals no longer match the record); evaluating "
                    "live from here", replayed,
                )
                recorded = []
                if store is not None:
                    store.truncate(replayed)
            results = evaluate_batch(batch_values)
            fresh = True
        objectives = []
        for values, (psnr, nbytes) in zip(batch_values, results):
            objective = psnr - float(params["lambda_kb"]) * nbytes / 1024.0
            objectives.append(objective)
            history.append((values, objective))
            trial = {
                "trial": t, "values": {k: str(v) for k, v in values.items()},
                "psnr": psnr, "bytes": nbytes, "objective": objective,
            }
            trials.append(trial)
            if fresh and store is not None:
                store.append(trial)
            if objective > best[0]:
                best = (objective, values)
            log.info(
                "trial %d%s: PSNR=%.3f bytes=%d obj=%.3f",
                t, " (replayed)" if not fresh else "", psnr, nbytes, objective,
            )
            t += 1
        if cma is not None and cma._pending is not None:
            # tell on the full asked population (trimmed tail gets the
            # batch's worst objective so array shapes line up)
            pad = [min(objectives)] * (len(cma._pending[0]) - len(objectives))
            cma.tell(objectives + pad)
    return trials, best


def sample(space: Dict, rng: random.Random) -> List[str]:
    """Back-compat: one random draw as override strings."""
    return [f"{k}={v}" for k, v in sample_random(space, rng).items()]


def _make_serial_evaluator(fixed, params):
    """Trials one by one through compress.main, each into
    <output_dir>/trial_{t}."""
    from implicit_image_tpu_torch.compress import main

    counter = {"t": 0}

    def evaluate(batch_values):
        out = []
        for values in batch_values:
            cfg = compose(fixed + [f"{k}={v}" for k, v in values.items()])
            run_dir = Path(cfg.get("output_dir", "outputs/sweep")) / f"trial_{counter['t']}"
            counter["t"] += 1
            out.append(main(cfg, run_dir=str(run_dir)))
        return out

    return evaluate


def _make_ladder_evaluator(fixed, params):
    """A round of masking.density proposals as one density ladder
    (parallel/ladder.ladder_compress) into <output_dir>/round_{r}: one fit
    over the member axis for the whole round. A dense config runs RigL."""
    import torch

    from implicit_image_tpu_torch.parallel.ladder import build_ladder_args, ladder_compress

    cfg = compose(fixed)
    if not cfg.get("masking") or cfg.masking.get("dense", False):
        cfg = compose([a for a in fixed if not a.startswith("masking=")] + ["masking=RigL"])
    args = build_ladder_args(cfg)
    counter = {"round": 0}

    def evaluate(batch_values):
        densities = [float(v["masking.density"]) for v in batch_values]
        root = Path(cfg.get("output_dir", "outputs/sweep")) / f"round_{counter['round']}"
        counter["round"] += 1
        results = ladder_compress(
            torch.Generator().manual_seed(int(cfg.seed)), args["mdef"], args["mcfg"],
            args["grid"], args["img"], args["train_cfg"], args["optim_cfg"], args["masking"],
            densities, quant_cfg=args["quant_cfg"], stream_name=args["stream_name"],
            stream_root=str(root), half=args["half"], coding_kwargs=args["coding_kwargs"],
            init_params=args["init_params"], delta_info=args["delta_info"],
            device=args["device"])
        out = []
        for r in results:
            psnr = r.decoded_psnr
            if not (psnr == psnr):  # no coding stage: the quant or fit PSNR
                psnr = r.quant_psnr if r.quant_psnr == r.quant_psnr else r.psnr
            out.append((psnr, r.compressed_bytes))
        return out

    return evaluate


@catch_error_decorator
def cli(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    fixed, space, params = parse_space(argv)
    batch = int(params.get("batch", 1))
    batchable = batch > 1 and set(space) == {"masking.density"}
    if batch > 1 and not batchable:
        log.warning(
            "batch=%d requested but the space %s cannot run as one density "
            "ladder (only masking.density can); evaluating its trials one "
            "by one", batch, sorted(space),
        )
    open_device(compose(fixed).get("device", "cuda"))  # the kernels build before the first trial
    evaluate = (
        _make_ladder_evaluator(fixed, params)
        if batchable
        else _make_serial_evaluator(fixed, params)
    )
    store = (
        SweepStore(Path(str(params["dir"])) / "sweep.jsonl", space, params)
        if int(params["resume"])
        else None
    )
    trials, best = run_sweep(evaluate, space, params, store=store)
    out = Path("outputs/sweep_results.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    best_overrides = fixed + [f"{k}={v}" for k, v in best[1].items()]
    out.write_text(
        json.dumps({"trials": trials, "best": best_overrides}, indent=2)
    )
    print(f"BEST objective={best[0]:.4f} overrides={best_overrides}")


if __name__ == "__main__":
    cli()
