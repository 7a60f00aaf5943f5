"""Meta-learned warm starts: loading and the `init_path=auto` choice
(counterpart of implicit_image_tpu/training/metainit.py `load_meta_init`,
`default_meta_dir`, `meta_precision` and `resolve_auto_init`).

The artifact is a numpy .npz written by the JAX package's `save_meta_init`:
tensors under "params.{i}.{key}", the architecture under "meta.*" and
"mcfg.*", and the matmul precision it was meta-trained under in
"meta.matmul_precision". `train.init_path` lets both packages start a fit
from the same weights; the committed artifacts live in <repo>/assets/meta.
Meta-training itself is not ported.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = [
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
