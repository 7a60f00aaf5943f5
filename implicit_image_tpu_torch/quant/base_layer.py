"""Base-layer codebook finetune for the progressive container (counterpart
of implicit_image_tpu/quant/base_layer.py).

The format-4 base layer (coding/progressive.py) rebuilds each split tensor
from a 16-entry run-mean codebook, which is optimal in weight space; what a
client sees is the rendered image. This finetune trains those codebooks
alone against the image: Adam on ~16 scalars per tensor, the hi labels and
every other tensor frozen. The refinement never reads the base books, so
the full stream is untouched.

Each step is a render and its gradient through `mdef.apply` (for SIREN K1
and K2 on the card); the gradient reaches each book through
`gather_centroids`, a fixed-order segment sum (no atomics), so two runs on
the card repeat bit for bit. The JAX package runs it with no precision
context around it, JAX's default one bf16 pass on the TPU: the bf16 mode,
this function's default.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from implicit_image_tpu_torch.ops.metrics import mse
from implicit_image_tpu_torch.quant.kmeans import gather_centroids

__all__ = ["finetune_base_codebooks"]


def finetune_base_codebooks(mdef, mcfg, grid: torch.Tensor, img, base_entries,
                            steps: int = 100, lr: float = 1e-3, delta_layers=(),
                            delta_offsets=None, precision: str = "bf16") -> Dict[str, np.ndarray]:
    """base_entries (the format-4 base section, name -> array) ->
    {"layers.{i}.base_centroids": finetuned array} in the stored dtype,
    trained on `grid`'s device.

    Frozen: the hi labels and every unsplit tensor (weights, biases, extras;
    uint16-label codebooks as centroids[labels]; per-channel codes times
    their scales). Trainable: the run-mean codebooks only.

    `delta_layers` / `delta_offsets` (progressive delta streams): those
    layers' books are residual books, so the render takes
    w = (book[hi] + offset) * (hi != 0), the base decode's rule, with
    delta_offsets[i] the shared artifact's layer-i weight."""
    device = grid.device
    h, w, _ = grid.shape
    target = torch.as_tensor(np.asarray(img, np.float32), device=device).reshape(h * w, -1)

    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, np.float32), device=device)

    template: Dict[int, dict] = {}
    hi_of: Dict[int, torch.Tensor] = {}
    book_names = []  # (layer index, entry name, stored dtype)
    raw = dict(base_entries)
    for name, arr in raw.items():
        _, idx, key = name.split(".", 2)
        i = int(idx)
        if key == "labels_hi":
            hi_of[i] = torch.as_tensor(np.asarray(arr, np.int64), device=device)
        elif key == "base_centroids":
            book_names.append((i, name, np.asarray(arr).dtype))
        elif key == "labeled_weight":
            qn, cn = f"layers.{i}.qscale", f"layers.{i}.centroids"
            if qn in raw:  # per-channel codes times their scales, frozen
                wt = np.asarray(arr, np.float32) * np.asarray(raw[qn], np.float32)[None, :]
            else:  # an unsplit (uint16-label) codebook, frozen
                wt = np.asarray(raw[cn], np.float32)[np.asarray(arr)]
            template.setdefault(i, {})["w"] = tensor(wt)
        elif key not in ("qscale", "centroids"):
            template.setdefault(i, {})[{"weight": "w", "bias": "b"}.get(key, key)] = tensor(arr)
    if not book_names:
        return {}
    books = [tensor(raw[name]).requires_grad_(True) for _, name, _ in book_names]
    delta_layers = frozenset(int(i) for i in delta_layers)
    offs = {int(i): tensor(v) for i, v in (delta_offsets or {}).items()}

    def build_params(bks):
        layers = {i: dict(d) for i, d in template.items()}
        for (i, _, _), book in zip(book_names, bks):
            wt = gather_centroids(book, hi_of[i])
            if i in delta_layers:
                wt = (wt + offs[i]) * (hi_of[i] != 0)
            layers.setdefault(i, {})["w"] = wt
        return tuple(layers[i] for i in sorted(layers))

    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = [torch.zeros_like(b) for b in books]
    nu = [torch.zeros_like(b) for b in books]
    for t in range(steps):
        pred = mdef.apply(build_params(books), grid, mcfg, precision)
        grads = torch.autograd.grad(mse(pred.reshape(h * w, -1), target), books)
        # the bias corrections in float32, as JAX's (step count a float32)
        tt = np.float32(t + 1)
        c1, c2 = (float(np.float32(1) - np.float32(b) ** tt) for b in (b1, b2))
        with torch.no_grad():
            mu = [b1 * m + (1 - b1) * g for m, g in zip(mu, grads)]
            nu = [b2 * n + (1 - b2) * g * g for n, g in zip(nu, grads)]
            books = [(b - lr * (m / c1) / (torch.sqrt(n / c2) + eps)).requires_grad_(True)
                     for b, m, n in zip(books, mu, nu)]
    return {name: np.asarray(book.detach().cpu().numpy(), dtype)
            for (_, name, dtype), book in zip(book_names, books)}
