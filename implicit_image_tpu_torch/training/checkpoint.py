"""Checkpoint / resume (counterpart of implicit_image_tpu/training/
checkpoint.py): the whole training state as one flat .npz, so that a fit
stops and continues with the same bits as an uninterrupted one.

The keys are the JAX package's for everything the two packages share, so
each package loads the other's params, Adam state, masks and step:

    meta.step, meta.n_layers, params.{i}.{k}, meta.count, mu.{i}.{k},
    nu.{i}.{k}, mask.{i}, mask.baseline_nonzero, mask.total_params,
    mask.adjusted_growth, mask.adj_sum, mask.adj_count, mask.final_sparsity,
    and under EKFAC meta.ekfac_layers, ekfac_ua.{j}, ekfac_ug.{j}, ekfac_m2.{j}
    (j counts the captured linear layers)

Random state does not carry across packages: the port stores its
torch.Generator's state under `torch.generator_state`, a key only it reads,
and the JAX package its PRNG key under `meta.key`. A port checkpoint
carries a `meta.key` too, a fresh JAX key made from the step (not a draw
of the port's generator), so that the JAX package can resume a sparse fit
from it; a JAX checkpoint resumes in the port with the generator the
caller passes.
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from implicit_image_tpu_torch.optim.adam import AdamState
from implicit_image_tpu_torch.optim.ekfac import EkfacState
from implicit_image_tpu_torch.sparsity import MaskState

__all__ = ["save_checkpoint", "load_checkpoint", "GENERATOR_KEY"]

GENERATOR_KEY = "torch.generator_state"
_MASK_SCALARS = ("baseline_nonzero", "total_params", "adjusted_growth", "adj_sum",
                 "adj_count", "final_sparsity")


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _flat_layers(prefix: str, layers, out: Dict[str, np.ndarray]) -> None:
    for i, layer in enumerate(layers):
        if layer is None:
            continue
        if isinstance(layer, dict):
            for k, v in layer.items():
                out[f"{prefix}.{i}.{k}"] = _host(v)
        else:
            out[f"{prefix}.{i}"] = _host(layer)


def _unflat_layers(prefix: str, data, n: int, device, none_ok: bool = False):
    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    layers = []
    for i in range(n):
        keys = [k for k in data if k.startswith(f"{prefix}.{i}.")]
        if keys:
            layers.append({k.rsplit(".", 1)[1]: tensor(data[k]) for k in keys})
        elif f"{prefix}.{i}" in data:
            layers.append(tensor(data[f"{prefix}.{i}"]))
        else:
            layers.append(None if none_ok else {})
    return tuple(layers)


def save_checkpoint(path, params, opt_state: Optional[AdamState] = None,
                    mask_state: Optional[MaskState] = None,
                    generator: Optional[torch.Generator] = None, step: int = 0,
                    ekfac_state: Optional[EkfacState] = None) -> None:
    """Write the state atomically (a temporary file, then a rename): a crash
    while writing keeps the previous checkpoint."""
    out: Dict[str, np.ndarray] = {"meta.step": np.asarray(step),
                                  "meta.n_layers": np.asarray(len(params)),
                                  "meta.key": np.asarray([0, step], np.uint32)}
    _flat_layers("params", params, out)
    if generator is not None:
        out[GENERATOR_KEY] = generator.get_state().numpy()
    if opt_state is not None:
        _flat_layers("mu", opt_state.mu, out)
        _flat_layers("nu", opt_state.nu, out)
        out["meta.count"] = np.asarray(opt_state.count, np.int32)
    if ekfac_state is not None and len(ekfac_state.ua):
        out["meta.ekfac_layers"] = np.asarray(len(ekfac_state.ua))
        for name in ("ua", "ug", "m2"):
            _flat_layers(f"ekfac_{name}", getattr(ekfac_state, name), out)
    if mask_state is not None:
        _flat_layers("mask", mask_state.masks, out)
        for name in _MASK_SCALARS:
            out[f"mask.{name}"] = _host(getattr(mask_state, name))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=str(path.parent))
    os.close(fd)
    try:
        np.savez(tmp, **out)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path, device="cpu") -> Dict[str, Any]:
    """A checkpoint of either package -> {"step", "params", and where the
    file holds them "opt_state", "mask_state", "ekfac_state",
    "generator_state" (the port's only)}, tensors on `device`. A mask state
    without final_sparsity (an older JAX checkpoint) holds NaN there; the
    fit re-seeds it from the masking config."""
    data = dict(np.load(path, allow_pickle=False))
    n = int(data["meta.n_layers"])
    out: Dict[str, Any] = {"step": int(data["meta.step"]),
                           "params": _unflat_layers("params", data, n, device)}
    if "meta.count" in data:
        out["opt_state"] = AdamState(mu=_unflat_layers("mu", data, n, device),
                                     nu=_unflat_layers("nu", data, n, device),
                                     count=int(data["meta.count"]))
    if "meta.ekfac_layers" in data:
        ne = int(data["meta.ekfac_layers"])
        out["ekfac_state"] = EkfacState(*(_unflat_layers(f"ekfac_{name}", data, ne, device)
                                          for name in ("ua", "ug", "m2")))
    if "mask.total_params" in data:
        scalars = {name: torch.as_tensor(np.asarray(data.get(f"mask.{name}", np.nan),
                                                    np.float32)).to(device)
                   for name in _MASK_SCALARS}
        out["mask_state"] = MaskState(
            masks=_unflat_layers("mask", data, n, device, none_ok=True), **scalars)
    if GENERATOR_KEY in data:
        out["generator_state"] = torch.from_numpy(data[GENERATOR_KEY])
    return out
