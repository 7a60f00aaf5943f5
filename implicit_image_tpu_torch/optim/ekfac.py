"""EKFAC natural-gradient preconditioner (George et al. 2018; counterpart
of implicit_image_tpu/optim/ekfac.py, optim.preconditioner=ekfac).

Per linear layer, over N samples:
  A = E[a1 a1^T]  (the layer's inputs, a ones column appended) -> eigvecs Ua
  G = E[g g^T]    (per-sample grads of the pre-activation)      -> eigvecs Ug
  m2 <- alpha m2 + (1 - alpha) E[(Ug^T g)^2 (a1^T Ua)^2]         (running)
  precond(grad) = Ug ((Ug^T grad Ua) / (m2 + eps)) Ua^T

The per-sample pre-activation grads come from differentiating the MSE with
respect to zero perturbations added to each layer's pre-activation, through
a plain per-layer chain of the model (`_perturbed_forward`: siren, fourier,
coordx, wavelet_siren, hashgrid). As in the JAX package, which computes it
in XLA outside any Pallas kernel, the capture is plain fp32 `torch.matmul`
(TF32 off on the card: ops.check_fp32), whatever precision mode the fit's
own chain runs in. The captured grads carry the mean loss's 1/N; the
update scales them back by N.

The eigenbases are recomputed when the fit asks (every precond_interval
steps, a decision on the Python step count), each shape's matrices in one
batched `eigh`. `ekfac_update_stats_chunked` bounds the capture's memory at
one pixel chunk (train.pixel_chunks > 1): the Grams are sums over chunks,
and a recompute step runs two chunk passes (the Grams, then m2 in the new
basis). Hashgrid's feature table is an embedding, not a linear layer: it is
not captured and its gradient passes through (`model_skip_indices`).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from implicit_image_tpu_torch.ops import check_fp32, eigh_by_shape

__all__ = ["EkfacState", "ekfac_init", "ekfac_update_stats", "ekfac_precondition",
           "capture_layer_stats", "model_skip_indices", "ekfac_update_stats_chunked"]


class EkfacState(NamedTuple):
    ua: Tuple[torch.Tensor, ...]  # (fan_in+1, fan_in+1) eigvecs per layer
    ug: Tuple[torch.Tensor, ...]  # (fan_out, fan_out) eigvecs per layer
    m2: Tuple[torch.Tensor, ...]  # (fan_out, fan_in+1) KFE second moments


def _perturbed_forward(params, coords: torch.Tensor, cfg, model_name: str):
    """fwd(perturbs) -> (out, per-layer inputs): the model's chain in fp32
    with perturbs[i] added to linear layer i's pre-activation."""
    from implicit_image_tpu_torch.ops.fast_math import fast_sin

    def sine(c):
        return fast_sin if getattr(c, "fast_sine", True) else torch.sin

    def fwd(perturbs):
        acts = []
        if model_name == "siren":
            x = (coords - 0.5) * 2.0
            n = len(params)
            for i, layer in enumerate(params):
                acts.append(x)
                z = x @ layer["w"] + layer["b"] + perturbs[i]
                x = z if (i == n - 1 and cfg.outermost_linear) else sine(cfg)(cfg.omegas[i] * z)
            return x / 2.0 + 0.5, acts
        if model_name == "fourier":
            xp = (2.0 * math.pi * coords) @ params[0]["B"]
            x = torch.cat([torch.sin(xp), torch.cos(xp)], dim=-1)
            layers = params[1:]
            for i, layer in enumerate(layers):
                acts.append(x)
                z = x @ layer["w"] + layer["b"] + perturbs[i]
                x = torch.relu(z) if i < len(layers) - 1 else torch.sigmoid(z)
            return x, acts
        if model_name == "coordx":
            # the branches run per point, so every layer captures N samples;
            # acts follow the params order [x-branch, y-branch, fused]
            sin = sine(cfg)
            s = cfg.split_depth
            px, py, pf = params[:s], params[s:2 * s], params[2 * s:]
            acts_x, acts_y, acts_f = [], [], []

            def branch(pslice, pert, x, acc):
                for i, layer in enumerate(pslice):
                    acc.append(x)
                    omega = cfg.first_omega_0 if i == 0 else cfg.hidden_omega_0
                    if layer["w"].shape[0] == 1:
                        z = x * layer["w"][0] + layer["b"] + pert[i]
                    else:
                        z = x @ layer["w"] + layer["b"] + pert[i]
                    x = sin(omega * z)
                return x

            fx = branch(px, perturbs[:s], (coords[:, 1:2] - 0.5) * 2.0, acts_x)
            fy = branch(py, perturbs[s:2 * s], (coords[:, 0:1] - 0.5) * 2.0, acts_y)
            if cfg.fusion == "product":
                x = (fy * fx) * math.sqrt(2.0)
            else:
                x = (fy + fx) * (1.0 / math.sqrt(2.0))
            pert_f = perturbs[2 * s:]
            for i, layer in enumerate(pf):
                acts_f.append(x)
                z = x @ layer["w"] + layer["b"] + pert_f[i]
                x = z if (i == len(pf) - 1 and cfg.outermost_linear) else sin(
                    cfg.hidden_omega_0 * z)
            return x / 2.0 + 0.5, acts_x + acts_y + acts_f
        if model_name == "wavelet_siren":
            # two SIREN stacks on their own DWT lattices (each layer captures
            # its stack's sample count), then the inverse DWT, the chroma
            # upsample and the colour transform, as wavelet_siren_apply
            from implicit_image_tpu_torch.models.wavelet_siren import (
                _grid_flat,
                _upsample,
                ycbcr_to_rgb,
            )
            from implicit_image_tpu_torch.ops.wavelet import idwt2

            def stack(pslice, pert, scfg, x):
                for i, layer in enumerate(pslice):
                    acts.append(x)
                    z = x @ layer["w"] + layer["b"] + pert[i]
                    last = i == len(pslice) - 1 and scfg.outermost_linear
                    x = z if last else sine(scfg)(scfg.omegas[i] * z)
                return x / 2.0 + 0.5

            n_lf = cfg.n_lf_layers
            (lf_h, lf_w), (hf_h, hf_w) = cfg.lf_shape, cfg.hf_shape
            dev = coords.device
            lf_img = stack(params[:n_lf], perturbs[:n_lf], cfg.lf_config,
                           (_grid_flat(lf_h, lf_w, dev) - 0.5) * 2.0
                           ).reshape(lf_h, lf_w, cfg.output_size)
            hf_img = stack(params[n_lf:], perturbs[n_lf:], cfg.hf_config,
                           (_grid_flat(hf_h, hf_w, dev) - 0.5) * 2.0).reshape(hf_h, hf_w, 3)
            h, w = cfg.height, cfg.width
            y = idwt2(lf_img[:, :, 0], hf_img[:, :, 0], hf_img[:, :, 1], hf_img[:, :, 2],
                      (h, w))
            cbcr = _upsample(lf_img[:, :, 1:], h, w)
            return ycbcr_to_rgb(torch.cat([y[:, :, None], cbcr], dim=-1)).reshape(h * w, 3), acts
        if model_name == "hashgrid":
            # the feature table is not captured (model_skip_indices); the
            # ReLU ladder with its linear output is
            from implicit_image_tpu_torch.models.hashgrid import _pyramid_features

            x = _pyramid_features(params[0]["w"], coords, cfg, False)
            layers = params[1:]
            for i, layer in enumerate(layers):
                acts.append(x)
                z = x @ layer["w"] + layer["b"] + perturbs[i]
                x = torch.relu(z) if i < len(layers) - 1 else z
            return x, acts
        raise NotImplementedError("EKFAC capture supports siren/fourier/coordx/wavelet_siren/"
                                  f"hashgrid, got {model_name}")

    return fwd


def model_skip_indices(model_name: str, params) -> frozenset:
    """Layer indices EKFAC leaves alone for this family (hashgrid's table)."""
    return frozenset({0}) if model_name == "hashgrid" else frozenset()


def _linear_layers(model_name: str, params):
    skip = model_skip_indices(model_name, params)
    return [layer for i, layer in enumerate(params) if "w" in layer and i not in skip]


def _capture(mdef, mcfg, params, coords, loss_of, counts):
    """(acts, per-sample grads) of loss_of(out), the perturbations sized by
    `counts`; every tensor detached from the fit's graph."""
    check_fp32(coords, "optim.preconditioner=ekfac")
    params = tuple({k: v.detach() for k, v in layer.items()} for layer in params)
    lin = _linear_layers(mdef.name, params)
    perturbs = [torch.zeros((c, layer["w"].shape[1]), dtype=torch.float32,
                            device=coords.device, requires_grad=True)
                for c, layer in zip(counts, lin)]
    with torch.enable_grad():
        out, acts = _perturbed_forward(params, coords, mcfg, mdef.name)(perturbs)
        grads = torch.autograd.grad(loss_of(out), perturbs)
    return [a.detach() for a in acts], list(grads)


def capture_layer_stats(mdef, mcfg, params, coords, target
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per linear layer (a, g): its inputs and the per-sample grads of the
    MSE with respect to its pre-activation."""
    lin = _linear_layers(mdef.name, params)
    if mdef.name == "wavelet_siren":
        n_lf = mcfg.lf_shape[0] * mcfg.lf_shape[1]
        n_hf = mcfg.hf_shape[0] * mcfg.hf_shape[1]
        counts = [n_lf] * mcfg.n_lf_layers + [n_hf] * (len(lin) - mcfg.n_lf_layers)
    else:
        counts = [coords.shape[0]] * len(lin)
    return _capture(mdef, mcfg, params, coords, lambda out: torch.mean((out - target) ** 2),
                    counts)


def ekfac_init(params, skip: frozenset = frozenset()) -> EkfacState:
    """Identity bases and unit moments for every linear layer not in `skip`."""
    ua, ug, m2 = [], [], []
    for i, layer in enumerate(params):
        if "w" not in layer or i in skip:
            continue
        fi, fo = layer["w"].shape
        dev = layer["w"].device
        ua.append(torch.eye(fi + 1, device=dev))
        ug.append(torch.eye(fo, device=dev))
        m2.append(torch.ones((fo, fi + 1), device=dev))
    return EkfacState(ua=tuple(ua), ug=tuple(ug), m2=tuple(m2))


def _bases(mats) -> List[torch.Tensor]:
    """Each symmetric matrix's eigenvectors (ascending eigenvalues)."""
    return [v for _, v in eigh_by_shape(mats)]


def _with_ones(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, torch.ones((a.shape[0], 1), dtype=a.dtype, device=a.device)], dim=1)


def _m2_batch(gs, a1, ug, ua) -> torch.Tensor:
    """sum over samples of (gs ug)^2 (a1 ua)^2 as (fo, fi+1)."""
    ga = (gs @ ug).t()
    aa = (a1 @ ua).t()
    return (ga ** 2) @ (aa ** 2).t()


def ekfac_update_stats(state: EkfacState, acts, grads, alpha: float = 0.75,
                       recompute_eigs: bool = True) -> EkfacState:
    """The factors and KFE moments updated from one (a, g) capture; the
    bases recomputed from this capture's A and G when recompute_eigs."""
    a1s, gss = [], []
    for a, g in zip(acts, grads):
        a1s.append(_with_ones(a))
        gss.append(g * a.shape[0])  # the true per-sample grads
    ua_t, ug_t = state.ua, state.ug
    if recompute_eigs:
        ua_t = _bases([(a1.t() @ a1) / a1.shape[0] for a1 in a1s])
        ug_t = _bases([(gs.t() @ gs) / gs.shape[0] for gs in gss])
    m2 = tuple(alpha * m2 + (1 - alpha) * (_m2_batch(gs, a1, ug, ua) / a1.shape[0])
               for m2, a1, gs, ua, ug in zip(state.m2, a1s, gss, ua_t, ug_t))
    return EkfacState(ua=tuple(ua_t), ug=tuple(ug_t), m2=m2)


def ekfac_update_stats_chunked(state: EkfacState, mdef, mcfg, params, coords, target,
                               chunks: int, alpha: float = 0.75,
                               recompute_eigs: bool = True, pixel_group=None) -> EkfacState:
    """ekfac_update_stats with the capture held to one pixel chunk at a time
    (per-pixel models only: wavelet_siren raises). Each chunk's loss is its
    share of the global mean, so its per-sample grads carry the unchunked
    capture's scale; the Grams and m2 are sums over the chunks. With a
    `pixel_group` (parallel/collectives.AxisGroup), coords and target are
    this rank's rows in `chunks` chunks, and the sums run over every rank's
    chunks in rank order: each rank gets the bits of the whole lattice's
    capture in chunks · size chunks."""
    if mdef.name == "wavelet_siren":
        raise ValueError("chunked EKFAC capture is undefined for full-grid models "
                         "(wavelet_siren renders on its own DWT grids)")
    n_local = coords.shape[0]
    if n_local % chunks:
        raise ValueError(f"pixel_chunks={chunks} must divide pixel count {n_local}")
    n_c = n_local // chunks
    n_total = n_local * (pixel_group.size if pixel_group is not None else 1)
    lin = _linear_layers(mdef.name, params)

    def summed(per_chunk):
        """The left-to-right sum over the chunks (every rank's, in order)
        of per-chunk lists of tensors."""
        if pixel_group is not None:
            return pixel_group.chunk_sum(per_chunk)
        acc = per_chunk[0]
        for part in per_chunk[1:]:
            acc = [x + y for x, y in zip(acc, part)]
        return acc

    def chunk_stats(c):
        cc, tc = coords[c * n_c:(c + 1) * n_c], target[c * n_c:(c + 1) * n_c]
        acts, grads = _capture(
            mdef, mcfg, params, cc,
            lambda out: torch.sum((out - tc) ** 2) / (n_total * out.shape[-1]), [n_c] * len(lin))
        return [(_with_ones(a), g * n_total) for a, g in zip(acts, grads)]

    if recompute_eigs:
        grams = []
        for c in range(chunks):
            stats = chunk_stats(c)
            grams.append([a1.t() @ a1 for a1, _ in stats] + [gs.t() @ gs for _, gs in stats])
        sums = summed(grams)
        ua_t = _bases([a / n_total for a in sums[:len(lin)]])
        ug_t = _bases([g / n_total for g in sums[len(lin):]])
    else:
        ua_t, ug_t = state.ua, state.ug
    m2_sums = summed([[_m2_batch(gs, a1, ug, ua)
                       for (a1, gs), ua, ug in zip(chunk_stats(c), ua_t, ug_t)]
                      for c in range(chunks)])
    m2 = tuple(alpha * m2 + (1 - alpha) * (s / n_total) for m2, s in zip(state.m2, m2_sums))
    return EkfacState(ua=tuple(ua_t), ug=tuple(ug_t), m2=m2)


def ekfac_precondition(state: EkfacState, grads, eps: float = 0.1,
                       skip: frozenset = frozenset()):
    """A grads tuple preconditioned in the KFE basis (w and b together as
    the (fan_out, fan_in+1) matrix); `skip` layers pass through."""
    out = []
    j = 0
    for i, layer in enumerate(grads):
        if "w" not in layer or i in skip:
            out.append(layer)
            continue
        gw, gb = layer["w"], layer.get("b")
        ua, ug, m2 = state.ua[j], state.ug[j], state.m2[j]
        j += 1
        bias = gb if gb is not None else gw.new_zeros(gw.shape[1])
        gmat = torch.cat([gw.t(), bias[:, None]], dim=1)
        kfe = (ug.t() @ gmat @ ua) / (m2 + eps)
        pre = ug @ kfe @ ua.t()
        new_layer = dict(layer)
        new_layer["w"] = pre[:, :-1].t()
        if gb is not None:
            new_layer["b"] = pre[:, -1]
        out.append(new_layer)
    return tuple(out)
