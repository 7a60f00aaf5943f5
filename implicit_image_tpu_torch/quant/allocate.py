"""Per-layer codebook bit allocation, `quant.bit_alloc=auto` (counterpart
of implicit_image_tpu/quant/allocate.py).

Each quantized layer's rate/distortion trade-off is measured and the
separable Lagrangian allocation solved (Shoham & Gersho 1988):

    b_i(λ) = argmin_b  ΔD_i(b) + λ · R_i(b)

* ΔD_i(b): the measured increase of the image MSE when layer i alone is
  snapped to a 2^b-entry k-means codebook (every other layer full
  precision), each probe one render through `mdef.apply` (for SIREN the K1
  kernel on the card);
* R_i(b): the order-0 entropy of the snap's label histogram plus the fp16
  codebook bytes (the constant container terms cancel between
  allocations).

Sweeping λ traces the convex hull; each distinct allocation is re-scored
by a joint render with every layer snapped, and the cheapest one whose
joint MSE is no worse than the all-`bits` baseline's wins; if none is, the
uniform baseline comes back (`chosen_uniform`).

The renders run in the kernels' mode `precision`. The JAX package calls
allocate_bits with no precision context around it (its compress.py), so on
the TPU its probes render at JAX's default, one bf16 pass: the bf16 mode,
this function's default. The MSE is a float64 mean of the fp32 render's
errors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.quant import QuantConfig, quantize_weight, quantized_layer_indices

__all__ = ["AllocationReport", "allocate_bits"]


@dataclass(frozen=True)
class AllocationReport:
    """Outcome of the allocation search (rates in modeled model bytes)."""

    bits_per_layer: Tuple[Optional[int], ...]
    chosen_uniform: bool  # True when no allocation beat the baseline
    base_bits: int
    base_mse: float  # joint MSE, every layer at base_bits
    base_rate: float  # modeled label + codebook bytes at base_bits
    mse: float  # joint MSE of the chosen allocation
    rate: float  # modeled bytes of the chosen allocation
    per_layer: Dict[int, Dict[int, Tuple[float, float]]]
    # per_layer[i][b] = (ΔD_i(b) image-MSE increase, R_i(b) modeled bytes)


def _snap_one(w: torch.Tensor, bits: int, iters: int):
    snapped, book = quantize_weight(w, bits, iters)
    return snapped, book.labels


def _label_rate_bytes(labels: np.ndarray, bits: int) -> float:
    """Order-0 entropy of the labels + fp16 codebook bytes."""
    counts = np.bincount(labels.reshape(-1), minlength=2**bits).astype(np.float64)
    n = counts.sum()
    p = counts[counts > 0] / n
    h0 = float(-(p * np.log2(p)).sum())  # bits per label
    return n * h0 / 8.0 + 2.0 * (2**bits)


def allocate_bits(mdef, mcfg, params, grid: torch.Tensor, img, qcfg: QuantConfig,
                  candidates: Sequence[int] = (5, 6, 7, 8, 9, 10), n_lambdas: int = 64,
                  slack_db: float = 0.0, precision: str = "bf16") -> AllocationReport:
    """Search per-layer codebook widths for `qcfg`'s quantized layers.

    params: the fit's (masked) params, tensors on the render's device; grid:
    the image's grid on that device; qcfg.bits is the uniform baseline.
    candidates: the widths probed per layer (those with 2^b above the
    layer's weight count dropped, qcfg.bits always in). slack_db: the joint
    PSNR loss allowed against the baseline (0: strict dominance).

    Returns an AllocationReport whose `bits_per_layer` plugs into
    QuantConfig(bits_per_layer=...)."""
    target = torch.as_tensor(np.asarray(img), dtype=torch.float64, device=grid.device)
    target = target.reshape(-1, target.shape[-1])

    def render_mse(p) -> float:
        with torch.no_grad():
            pred = mdef.apply(p, grid, mcfg, precision).reshape(target.shape)
        d = pred.double() - target
        return float(torch.mean(d * d))

    qidx = quantized_layer_indices(params, qcfg)
    d0 = render_mse(params)

    # per-layer probes: layer i alone snapped at width b
    per_layer: Dict[int, Dict[int, Tuple[float, float]]] = {}
    snapped_cache: Dict[Tuple[int, int], torch.Tensor] = {}
    for i in qidx:
        w = params[i]["w"]
        cand = [b for b in candidates if 2**b <= w.numel()]
        if qcfg.bits not in cand:
            cand.append(qcfg.bits)
        per_layer[i] = {}
        for b in sorted(set(cand)):
            with torch.no_grad():
                snapped, labels = _snap_one(w, b, qcfg.lloyd_iters)
            snapped_cache[(i, b)] = snapped
            probe = tuple({**layer, "w": snapped} if j == i else layer
                          for j, layer in enumerate(params))
            dd = max(render_mse(probe) - d0, 0.0)
            per_layer[i][b] = (dd, _label_rate_bytes(labels.cpu().numpy(), b))

    def joint(alloc: Dict[int, int]) -> Tuple[float, float]:
        """Measured joint MSE and modeled bytes with every layer snapped."""
        probe = tuple({**layer, "w": snapped_cache[(j, alloc[j])]} if j in alloc else layer
                      for j, layer in enumerate(params))
        return render_mse(probe), sum(per_layer[j][b][1] for j, b in alloc.items())

    base_alloc = {i: qcfg.bits for i in qidx}
    base_mse, base_rate = joint(base_alloc)

    # the λ sweep over the separable Lagrangian
    seen, allocs = set(), []
    for lam in np.logspace(-12, 0, n_lambdas):
        alloc = {i: min(per_layer[i], key=lambda b: per_layer[i][b][0] + lam * per_layer[i][b][1])
                 for i in qidx}
        key = tuple(sorted(alloc.items()))
        if key not in seen:
            seen.add(key)
            allocs.append(alloc)

    # joint re-score: the cheapest allocation that holds the quality
    mse_budget = base_mse * 10.0 ** (slack_db / 10.0)
    best, best_mse, best_rate = None, base_mse, base_rate
    for alloc in allocs:
        m, r = joint(alloc)
        if m <= mse_budget and r < best_rate:
            best, best_mse, best_rate = alloc, m, r
    if best is None:
        chosen, chosen_uniform = base_alloc, True
        best_mse, best_rate = base_mse, base_rate
    else:
        chosen, chosen_uniform = best, False

    return AllocationReport(
        bits_per_layer=tuple(chosen.get(i) for i in range(len(params))),
        chosen_uniform=chosen_uniform,
        base_bits=qcfg.bits,
        base_mse=base_mse,
        base_rate=base_rate,
        mse=best_mse,
        rate=best_rate,
        per_layer=per_layer,
    )
