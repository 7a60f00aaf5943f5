"""Meta-learned warm starts: REPTILE meta-training, the artifact, and the
`init_path=auto` choice (counterpart of
implicit_image_tpu/training/metainit.py).

Meta-training (first-order REPTILE, Nichol et al. arXiv:1803.02999, for the
learned inits of Tancik et al. arXiv:2012.02189): each meta-step draws
`meta_batch` images of the pool without replacement (from an explicit
torch.Generator; JAX uses jax.random.choice), adapts a copy of the shared
weights to each with `inner_steps` Adam steps (Adam restarted every
meta-step, lr = inner_lr, constant), reads each adapted copy's loss with a
forward after its last update, and moves the shared weights toward the
adapted mean: θ ← θ + ε_j (mean(adapted) − θ), ε_j = outer_lr (1 − j/T) with
j the global meta-step, so the chunks (`MetaConfig.chunk`, the JAX
package's compiled blocks, here the logging cadence) do not reset it.
`make_meta_step` builds that step as a plain function, `meta_step(
meta_params, targets, j)`; `meta_train` loops over it.

Every family adapts its members together over the member axis
(parallel/batched.fit_members, the JAX package's jax.vmap of the inner
loop): the shared weights stacked into (M, ...) copies, each inner step one
member-axis forward and backward (for SIREN with the polynomial sine one
`sine_mlp_fwd_batched` and one `sine_mlp_bwd_batched` launch; CoordX and
hashgrid on their separable path over the grid), one more forward for the
post-adaptation loss, and the single fit's Adam step
(training.fit.optimizer_step).

The artifact is a numpy .npz in the JAX package's layout (`save_meta_init`):
tensors under "params.{i}.{key}", the architecture under "meta.*" and
"mcfg.*", and the matmul precision it was meta-trained under in
"meta.matmul_precision". Either package loads the other's, and
`train.init_path` starts a fit from it; the committed artifacts live in
<repo>/assets/meta.

`meta_pool` draws the training images from the synthetic family of the
evaluation stand-ins, with name-salted seeds, and refuses a seed that
collides with an evaluation image.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "MetaConfig",
    "meta_pool",
    "make_meta_step",
    "meta_train",
    "save_meta_init",
    "build_meta_model",
    "WARM_BUDGET_MAX_STEPS",
    "load_meta_init",
    "default_meta_dir",
    "meta_precision",
    "resolve_auto_init",
]

# The largest fit budget at which a warm start was measured to win (the JAX
# package's value): past it `init_path=auto` cold-starts, and an explicit
# init_path logs a warning.
WARM_BUDGET_MAX_STEPS = 3000

# the evaluation images (bench.py, benchmarks/time_to_quality.py): the meta
# pool never holds them
_EVAL_NAMES = ("flower", "flower_foveon", "big_building", "bridge", "synthetic")


@dataclass(frozen=True)
class MetaConfig:
    """The JAX package's fields and defaults: K = 50 inner steps, 300 outer
    steps, outer_lr 0.2 (its measured operating point; outer_lr 1.0 diverged
    and K = 16 was too short for 512² INRs there)."""

    pool_size: int = 16
    inner_steps: int = 50
    inner_lr: float = 3e-4
    outer_steps: int = 300
    outer_lr: float = 0.2  # REPTILE interpolation rate, annealed linearly to 0
    meta_batch: int = 4  # images per meta-step (the member axis)
    # meta-steps per block: the JAX package's compiled block, here the
    # logging cadence; it must divide outer_steps
    chunk: int = 25
    seed: int = 0


def meta_pool(height: int, width: int, n: int, extra_exclude: Tuple[str, ...] = ()) -> np.ndarray:
    """(n, H, W, 3) float32 pool of synthetic meta-training images, seeded
    `stable_seed(f"metatrain_{i}")` and skipping any seed of an evaluation
    stand-in (seed 0 and `stable_seed(name)` of _EVAL_NAMES + extra_exclude):
    the JAX package's pool, bit for bit."""
    from implicit_image_tpu_torch.data import stable_seed, synthetic_image

    banned = {0} | {stable_seed(nm) for nm in _EVAL_NAMES + tuple(extra_exclude)}
    imgs = []
    i = 0
    while len(imgs) < n:
        s = stable_seed(f"metatrain_{i}")
        i += 1
        if s in banned:
            continue
        imgs.append(synthetic_image(height, width, seed=s))
    return np.stack(imgs).astype(np.float32)


def make_meta_step(mdef, mcfg, grid: torch.Tensor, meta_cfg: MetaConfig,
                   precision: str = "fp32", device="cuda"):
    """meta_step(meta_params, targets (B, H·W, C), j) -> (meta_params, the
    mean post-adaptation loss): REPTILE step j (module note) on `device`,
    the products in `precision` (the kernels' mode: "fp32" or "bf16")."""
    from implicit_image_tpu_torch.parallel.batched import fit_members
    from implicit_image_tpu_torch.training.fit import OptimConfig, TrainConfig

    device = torch.device(device)
    grid = grid.to(device)
    h, w, c = grid.shape
    inner_optim = OptimConfig(lr=meta_cfg.inner_lr, lr_step_size=10**9)
    k_inner = int(meta_cfg.inner_steps)
    total = int(meta_cfg.outer_steps)
    matmul = {"fp32": "float32", "bf16": "bfloat16"}[precision]
    inner_train = TrainConfig(num_steps=k_inner, log_steps=k_inner, matmul_precision=matmul)

    def meta_step(meta_params, targets, j: int):
        targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
        b = targets.shape[0]
        # every family adapts over the member axis (the JAX package's vmap)
        res = fit_members([None] * b, mdef, mcfg, grid, targets.reshape(b, h, w, -1),
                          inner_train, inner_optim, init_params=meta_params, device=device)
        adapted = res.params
        # the eval after the last update: the post-adaptation loss
        post = torch.from_numpy(res.metrics["test_loss"][:, -1])
        # linear outer-rate anneal over the global meta-step, in float32
        eps = np.float32(meta_cfg.outer_lr) * (np.float32(1.0) - np.float32(j) / np.float32(total))
        with torch.no_grad():
            new = tuple({k: m + float(eps) * (adapted[i][k].mean(0) - m) for k, m in layer.items()}
                        for i, layer in enumerate(meta_params))
        return new, post.mean()

    return meta_step


def meta_train(mdef, mcfg, grid: torch.Tensor, pool: np.ndarray, meta_cfg: MetaConfig, log=None,
               precision: str = "fp32", device="cuda"):
    """REPTILE meta-training on `device` (default "cuda": RuntimeError
    without one; "cpu" runs the plain versions); returns (meta_params, the
    post-adaptation loss of each meta-step as a float32 array, wall
    seconds). The init and the index draws come from one torch.Generator
    seeded with meta_cfg.seed; `log(step, loss)` is called after every
    `chunk` meta-steps."""
    from implicit_image_tpu_torch.ops.cuda_build import open_device
    from implicit_image_tpu_torch.training.fit import synchronize

    n, h, w, c = pool.shape
    if tuple(grid.shape[:2]) != (h, w):
        raise ValueError(f"grid {tuple(grid.shape)} does not match pool {pool.shape}")
    if meta_cfg.outer_steps % meta_cfg.chunk:
        raise ValueError(
            f"chunk={meta_cfg.chunk} must divide outer_steps={meta_cfg.outer_steps}")
    if meta_cfg.meta_batch > n:
        raise ValueError(f"meta_batch={meta_cfg.meta_batch} exceeds pool size {n}")
    device = open_device(device)
    generator = torch.Generator().manual_seed(int(meta_cfg.seed))
    meta_params = mdef.init(generator, mcfg, device)
    pool_flat = torch.as_tensor(pool.reshape(n, h * w, c), dtype=torch.float32, device=device)
    meta_step = make_meta_step(mdef, mcfg, grid, meta_cfg, precision, device)

    synchronize(device)
    t0 = time.perf_counter()
    losses = []
    for j in range(meta_cfg.outer_steps):
        idx = torch.randperm(n, generator=generator)[: meta_cfg.meta_batch]
        meta_params, loss = meta_step(meta_params, pool_flat[idx.to(device)], j)
        losses.append(loss)
        if log is not None and (j + 1) % meta_cfg.chunk == 0:
            log(j + 1, float(loss))
    curve = torch.stack(losses).cpu().numpy().astype(np.float32)
    synchronize(device)
    return meta_params, curve, time.perf_counter() - t0


def save_meta_init(path, params, model_name: str, mcfg, matmul_precision=None) -> None:
    """Write a meta-init .npz in the JAX package's layout: "meta.n_layers",
    "meta.model", "meta.matmul_precision" (the train.matmul_precision string
    it was meta-trained under, "" for none: resolve_auto_init matches it),
    the int / float / bool fields of mcfg as "mcfg.{field}", and every
    tensor as "params.{i}.{key}"."""
    out = {
        "meta.n_layers": np.asarray(len(params)),
        "meta.model": np.asarray(model_name),
        "meta.matmul_precision": np.asarray(str(matmul_precision or "")),
    }
    for f in dataclasses.fields(mcfg):
        v = getattr(mcfg, f.name)
        if isinstance(v, (int, float, bool)):
            out[f"mcfg.{f.name}"] = np.asarray(v)
    for i, layer in enumerate(params):
        for k, v in layer.items():
            out[f"params.{i}.{k}"] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                      else np.asarray(v))
    np.savez(path, **out)


def build_meta_model(model_name: str, **mlp_kwargs):
    """(mdef, mcfg) of a registry model, for the CLI and the tools."""
    from implicit_image_tpu_torch.models import build_model

    return build_model(model_name, **mlp_kwargs)


def load_meta_init(path, expect_model: Optional[str] = None, expect_mcfg=None,
                   device="cpu"):
    """Load a meta-init .npz -> params tuple of {key: tensor} on `device`.

    With expect_model / expect_mcfg the recorded architecture is checked
    against the run's, so a mismatched init fails loudly."""
    data = np.load(path, allow_pickle=False)
    model = str(data["meta.model"])
    if expect_model is not None and model != expect_model:
        raise ValueError(
            f"meta-init {path} was trained for model {model!r}, "
            f"run configures {expect_model!r}"
        )
    if expect_mcfg is not None:
        for f in dataclasses.fields(expect_mcfg):
            k = f"mcfg.{f.name}"
            if k not in data:
                continue
            have, want = data[k].item(), getattr(expect_mcfg, f.name)
            if isinstance(want, (int, float, bool)) and have != want:
                raise ValueError(
                    f"meta-init {path} architecture mismatch: "
                    f"{f.name}={have} but run configures {f.name}={want}"
                )
    layers = []
    for i in range(int(data["meta.n_layers"])):
        prefix = f"params.{i}."
        layers.append({
            k[len(prefix):]: torch.as_tensor(np.array(data[k])).to(device)
            for k in data.files if k.startswith(prefix)
        })
    return tuple(layers)


def default_meta_dir() -> Path:
    """The committed artifact store: <repo>/assets/meta."""
    return Path(__file__).resolve().parents[2] / "assets" / "meta"


def meta_precision(path) -> Optional[str]:
    """The matmul_precision an artifact was meta-trained under (None for an
    artifact that predates the field)."""
    data = np.load(path, allow_pickle=False)
    if "meta.matmul_precision" not in data:
        return None
    return str(data["meta.matmul_precision"]) or None


def resolve_auto_init(model_name: str, mcfg, num_steps: int, meta_dir=None,
                      matmul_precision=None, device="cpu"):
    """`train.init_path=auto`: warm or cold. Returns (params or None, path
    or None, reason), with the JAX package's decision and reason strings.

    Warm only when the budget (num_steps x multiplier, as passed) is at most
    WARM_BUDGET_MAX_STEPS and an artifact in `meta_dir` (default
    assets/meta) was meta-trained under the run's matmul precision and
    matches its architecture (load_meta_init's checks); the first such
    artifact in name order wins. Otherwise (None, None, why): the fit
    cold-starts."""
    if num_steps > WARM_BUDGET_MAX_STEPS:
        return None, None, (
            f"budget {num_steps} steps > warm-win regime "
            f"(<= {WARM_BUDGET_MAX_STEPS}, the largest measured warm "
            "win — beyond it is unmeasured; BASELINE.md), cold-starting"
        )
    root = Path(meta_dir) if meta_dir is not None else default_meta_dir()
    if not root.is_dir():
        return None, None, f"no artifact store at {root}"
    rejected = []
    for p in sorted(root.glob("*.npz")):
        try:
            art_prec = meta_precision(p)
            if art_prec != (matmul_precision or None):
                # the basin is precision-specific
                rejected.append(
                    f"{p.name}: meta-trained under matmul_precision="
                    f"{art_prec}, run uses {matmul_precision or None}"
                )
                continue
            params = load_meta_init(p, expect_model=model_name, expect_mcfg=mcfg,
                                    device=device)
            return params, p, f"matched artifact {p.name}"
        except Exception as e:  # noqa: BLE001 - a mismatch rejects the artifact
            rejected.append(f"{p.name}: {e}")
    return None, None, (
        "no matching artifact in "
        f"{root} ({'; '.join(rejected) if rejected else 'empty'})"
    )
