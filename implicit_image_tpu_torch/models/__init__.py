"""Model registry (counterpart of implicit_image_tpu/models/__init__.py).

Every family of the JAX registry is ported: SIREN, Fourier features,
wavelet-SIREN, CoordX and hashgrid, and the Feathermap wrap
(masking=Feathermap) over any of them.

Each family also runs over a member axis (the JAX package's jax.vmap of
its forward): `ModelDef.apply_members` / `apply_flat_members` take params
whose leaves carry a leading member axis and are differentiable. SIREN
with the polynomial sine and wavelet-SIREN's two chains launch the
member-axis kernels (ops/sine_mlp.py); every other forward is
`torch.func.vmap` of the family's own (`vmap_members`): plain products
with a leading member dimension, each custom autograd Function with a
generated vmap rule. The method `apply_batched` renders a list of params
tuples through `apply_members` (decompress.decode_runs).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

__all__ = ["ModelDef", "registry", "build_model", "build_model_from_config", "vmap_members"]


@dataclass(frozen=True)
class ModelDef:
    name: str
    config_cls: type
    init: Callable  # (generator, cfg, device) -> params
    apply: Callable  # (params, grid (H,W,in), cfg, precision) -> (H,W,out)
    apply_flat: Callable  # (params, coords (N,in), cfg, precision) -> (N,out)
    # True when `apply` exploits a tensor-product grid and is cheaper than
    # apply_flat on the same pixels (CoordX): the fit and the finetune then
    # evaluate through `apply` on the grid
    separable: bool = False
    # True when the model renders only its configured full grid
    # (wavelet_siren, whose sub-SIRENs run on their own DWT lattices): the
    # fit then takes no pixel chunks, and over a pixel group its lattices'
    # rows split over the ranks instead of the image's (apply_split)
    full_grid: bool = False
    # the member-axis forwards, over params whose leaves carry a leading
    # member axis, differentiable: (params, grid (H,W,in), cfg, precision) ->
    # (M, H, W, out) and (params, coords (N,in), cfg, precision) -> (M, N, out);
    # left None, vmap_members of apply / apply_flat
    apply_members: Optional[Callable] = None
    apply_flat_members: Optional[Callable] = None
    # a full-grid model's forward on rank `part` of `parts` (params, grid
    # (H,W,in), cfg, precision, part, parts, gather) -> the whole (H,W,out),
    # and over a member axis -> (M, H, W, out); `gather` brings the ranks'
    # shares together (training.fit's pixel group)
    apply_split: Optional[Callable] = None
    apply_members_split: Optional[Callable] = None

    def __post_init__(self):
        if self.apply_members is None:
            object.__setattr__(self, "apply_members", vmap_members(self.apply))
        if self.apply_flat_members is None:
            object.__setattr__(self, "apply_flat_members", vmap_members(self.apply_flat))

    def apply_batched(self, members, grid, cfg, precision: str = "fp32"):
        """M params tuples of one shape -> (M, H, W, out), no gradient,
        rendered together through apply_members (SIREN: one K1 launch over
        a member axis)."""
        from implicit_image_tpu_torch.ops.sine_mlp import stack_members

        with torch.no_grad():
            return self.apply_members(stack_members(list(members)), grid, cfg, precision)


def vmap_members(apply: Callable) -> Callable:
    """A forward (params, x, cfg, precision) -> its member-axis form, params
    with a leading member axis and x shared: torch.func.vmap over the
    params."""

    def members(params, x, cfg, precision: str = "fp32"):
        return torch.func.vmap(lambda p: apply(p, x, cfg, precision))(params)

    return members


def _siren_def() -> ModelDef:
    from implicit_image_tpu_torch.models.siren import (
        SirenConfig,
        init_siren,
        siren_apply,
        siren_apply_flat,
        siren_apply_flat_members,
        siren_apply_members,
    )

    return ModelDef("siren", SirenConfig, init_siren, siren_apply, siren_apply_flat,
                    apply_members=siren_apply_members,
                    apply_flat_members=siren_apply_flat_members)


def _coordx_def() -> ModelDef:
    from implicit_image_tpu_torch.models.coordx import (
        CoordXConfig,
        coordx_apply,
        coordx_apply_flat,
        init_coordx,
    )

    return ModelDef("coordx", CoordXConfig, init_coordx, coordx_apply, coordx_apply_flat,
                    separable=True)


def _fourier_def() -> ModelDef:
    from implicit_image_tpu_torch.models.fourier import (
        FourierConfig,
        fourier_apply,
        fourier_apply_flat,
        init_fourier,
    )

    return ModelDef("fourier", FourierConfig, init_fourier, fourier_apply, fourier_apply_flat)


def _wavelet_siren_def() -> ModelDef:
    from implicit_image_tpu_torch.models.wavelet_siren import (
        WaveletSirenConfig,
        init_wavelet_siren,
        wavelet_siren_apply,
        wavelet_siren_apply_flat,
        wavelet_siren_apply_flat_members,
        wavelet_siren_apply_members,
        wavelet_siren_apply_members_split,
        wavelet_siren_apply_split,
    )

    return ModelDef("wavelet_siren", WaveletSirenConfig, init_wavelet_siren,
                    wavelet_siren_apply, wavelet_siren_apply_flat, full_grid=True,
                    apply_members=wavelet_siren_apply_members,
                    apply_flat_members=wavelet_siren_apply_flat_members,
                    apply_split=wavelet_siren_apply_split,
                    apply_members_split=wavelet_siren_apply_members_split)


def _hashgrid_def() -> ModelDef:
    from implicit_image_tpu_torch.models.hashgrid import (
        HashGridConfig,
        hashgrid_apply,
        hashgrid_apply_flat,
        init_hashgrid,
    )

    return ModelDef("hashgrid", HashGridConfig, init_hashgrid, hashgrid_apply,
                    hashgrid_apply_flat, separable=True)


registry = {
    "siren": _siren_def,
    "fourier": _fourier_def,
    "wavelet_siren": _wavelet_siren_def,
    "coordx": _coordx_def,
    "hashgrid": _hashgrid_def,
}


def build_model(model_name: str, **cfg_kwargs) -> Tuple[ModelDef, Any]:
    """Look up a model and build its config from (possibly overfull) kwargs;
    keys the config does not have (e.g. 'name') are dropped."""
    if model_name not in registry:
        raise KeyError(f"Model {model_name!r} not in registry {sorted(registry)}")
    mdef = registry[model_name]()
    fields = {f.name for f in dataclasses.fields(mdef.config_cls)}
    cfg = mdef.config_cls(**{k: v for k, v in cfg_kwargs.items() if k in fields})
    return mdef, cfg


def build_model_from_config(cfg) -> Tuple[ModelDef, Any]:
    """(mdef, mcfg) from a composed run config — the one mapping from
    cfg.mlp + cfg.masking to an architecture, shared by the encoder and the
    decoder. Small-Dense scales the hidden width by sqrt(masking.density);
    Feathermap wraps the model, hashing its tensors at masking.density."""
    mlp = dict(cfg["mlp"])
    name = mlp.pop("name")
    masking = cfg.get("masking") or {}
    small = 1.0
    if masking.get("name") == "Small_Dense":
        small = float(masking.get("density", 1.0))
    mdef, mcfg = build_model(name, small_dense_density=small, **mlp)
    if masking.get("name") == "Feathermap":
        # local import: feathermap imports this module
        from implicit_image_tpu_torch.feathermap import build_feather_model

        mdef = build_feather_model(mdef, mcfg, compress=float(masking.get("density", 1.0)))
    return mdef, mcfg
