"""Multiresolution hash-grid INR (counterpart of
implicit_image_tpu/models/hashgrid.py; Müller et al., SIGGRAPH 2022,
arXiv:2201.05989).

Per pixel, L pyramid levels each blend the 4 corners of the pixel's cell
in a learned feature table bilinearly; the concatenated (L·F) features run
through a small ReLU MLP. Params keep the JAX package's layout:
params[0]["w"] is the fused table (ΣT_l, F) of all levels (2-D, so k-means,
the container and the masks treat it like any weight), then the MLP's
{"w", "b"} layers.

Two forwards, as in the JAX package:

  * `hashgrid_apply` (a tensor-product grid; the fit, the finetune and the
    decode take it, `separable=True` in the registry): per level, the
    dense virtual grid G_l ((r+1)², F) — a reshape of a direct level's
    rows, a static-index gather of a hashed level's — and the bilinear
    blend as two interpolation products A_rows @ G_l @ A_colsᵀ. A hashed
    level's backward is JAX's transpose-gather (`_hashed_materializer`):
    per table row, the sum of the cells that hash to it, read through a
    padded static index table (numpy, built once per level) — no
    scatter-add, whose CUDA path adds with atomics and would not repeat
    bit for bit. The products are `torch.matmul` (fp32, or one bf16 pass
    under "bf16"; TF32 never), their backward products too.
  * `hashgrid_apply_flat` (any (N, 2) coordinates; rendering only): one
    gather of the N·L·4 corner rows. It is forward-only: its gather has
    no deterministic backward here, and no training path differentiates
    it (the fit and the finetune take the grid path; a pixel chunking
    that is not whole row blocks raises in its backward).

The NGP hash is uint32 arithmetic (cy · 2654435761 wrapping mod 2^32, XOR
cx, masked to the table size), emulated in int64 with `& 0xFFFFFFFF`.
"+mixed" casts the table, the interpolation weights, the level features
and the MLP's activations to bf16 where the JAX package does.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from implicit_image_tpu_torch.ops import check_fp32
from implicit_image_tpu_torch.ops.precision import matmul, maybe_cast, modes

__all__ = ["HashGridConfig", "init_hashgrid", "hashgrid_apply", "hashgrid_apply_flat",
           "hashed_level_tables"]

Params = Tuple[dict, ...]

_HASH_P2 = 2_654_435_761  # NGP's y prime (pi_1 = 1 keeps x-coherence)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridConfig:
    """Static architecture config (conf/mlp/hashgrid.yaml). depth counts the
    MLP's weight layers after the lookup; level resolutions follow NGP's
    geometric schedule N_l = floor(base · b^l), b chosen so the last level
    lands on finest_resolution."""

    input_size: int = 2
    output_size: int = 3
    n_levels: int = 12
    features: int = 2
    log2_table_size: int = 12
    base_resolution: int = 16
    finest_resolution: int = 512
    depth: int = 3
    hidden_size: int = 64
    small_dense_density: float = 1.0

    def __post_init__(self):
        if self.input_size != 2:
            raise ValueError("hashgrid factorizes 2-D (row, col) grids")
        if self.depth < 2:
            raise ValueError("hashgrid needs at least one hidden layer and the output layer")
        if self.n_levels < 1:
            raise ValueError("hashgrid needs at least one level")

    @property
    def effective_hidden(self) -> int:
        # Small-Dense width compensation: hidden_size * sqrt(density)
        return int(self.hidden_size * math.sqrt(self.small_dense_density))

    @property
    def level_resolutions(self) -> Sequence[int]:
        if self.n_levels == 1:
            return [int(self.base_resolution)]
        b = math.exp((math.log(self.finest_resolution) - math.log(self.base_resolution))
                     / (self.n_levels - 1))
        # +1e-6: b is a rounding away from the exact growth factor, so a bare
        # floor() would turn e.g. 64.0 into 63 at the configured endpoint
        return [int(math.floor(self.base_resolution * b**lv + 1e-6))
                for lv in range(self.n_levels)]

    @property
    def level_table_sizes(self) -> Sequence[int]:
        """Rows per level: the dense (res+1)² grid when it fits 2^log2_table_size,
        else the hashed 2^log2_table_size."""
        cap = 1 << self.log2_table_size
        return [min((r + 1) * (r + 1), cap) for r in self.level_resolutions]

    @property
    def level_offsets(self) -> Sequence[int]:
        offs, acc = [], 0
        for t in self.level_table_sizes:
            offs.append(acc)
            acc += t
        return offs

    @property
    def table_rows(self) -> int:
        return sum(self.level_table_sizes)

    @property
    def mlp_dims(self) -> Sequence[Tuple[int, int]]:
        h = self.effective_hidden
        return ([(self.n_levels * self.features, h)] + [(h, h)] * (self.depth - 2)
                + [(h, self.output_size)])


def init_hashgrid(generator: torch.Generator, cfg: HashGridConfig, device="cpu") -> Params:
    """NGP's table init U(±1e-4), then the MLP with Kaiming-uniform weights
    U(±sqrt(6/fan_in)) and biases U(±1/sqrt(fan_in)); drawn on the CPU from
    `generator` (the table, then each layer's weights and biases)."""
    table = (torch.rand((cfg.table_rows, cfg.features), generator=generator) * 2.0 - 1.0) * 1e-4
    params = [{"w": table.to(device)}]
    for fan_in, fan_out in cfg.mlp_dims:
        wb, bb = math.sqrt(6.0 / fan_in), 1.0 / math.sqrt(fan_in)
        w = (torch.rand((fan_in, fan_out), generator=generator) * 2.0 - 1.0) * wb
        b = (torch.rand((fan_out,), generator=generator) * 2.0 - 1.0) * bb
        params.append({"w": w.to(device), "b": b.to(device)})
    return tuple(params)


def _mlp_ladder(mlp, z: torch.Tensor, bf16: bool, mixed: bool) -> torch.Tensor:
    last = len(mlp) - 1
    for i, layer in enumerate(mlp):
        z = matmul(z, maybe_cast(layer["w"], mixed), bf16) + maybe_cast(layer["b"], mixed)
        if i != last:
            z = maybe_cast(torch.relu(z), mixed)
    return z


# --- flat path (rendering arbitrary coordinates) ---------------------------


class _ForwardOnlyGather(torch.autograd.Function):
    """table[idx]; its backward raises (see the module note). Its vmap rule
    is generated (the member-axis forwards)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(table, idx):
        return table.index_select(0, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "hashgrid's flat path (hashgrid_apply_flat) is forward-only: train "
            "through the tensor-product grid path (pixel_chunks in whole row blocks)")


def _pyramid_features(table, coords, cfg: HashGridConfig, mixed: bool) -> torch.Tensor:
    """(N, 2) coords in [0, 1] -> (N, L·F) blended pyramid features: one
    gather of every level's 4 corners."""
    n, dev = coords.shape[0], coords.device
    cap = 1 << cfg.log2_table_size
    res = torch.tensor(cfg.level_resolutions, dtype=torch.float32, device=dev)  # (L,)
    direct = torch.tensor([(r + 1) ** 2 <= cap for r in cfg.level_resolutions], device=dev)
    offsets = torch.tensor(cfg.level_offsets, dtype=torch.int64, device=dev)
    stride = torch.tensor([r + 1 for r in cfg.level_resolutions], dtype=torch.int64, device=dev)

    pos = coords[:, None, :] * res[None, :, None]  # (N, L, 2)
    p0 = torch.minimum(torch.clamp(torch.floor(pos), min=0.0), (res - 1.0)[None, :, None])
    frac = pos - p0
    corner = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=torch.int64, device=dev)
    cyx = p0.long()[:, :, None, :] + corner[None, None]  # (N, L, 4, 2)
    cy, cx = cyx[..., 0], cyx[..., 1]
    idx_direct = cy * stride[None, :, None] + cx
    idx_hash = (cx ^ ((cy * _HASH_P2) & _U32)) & (cap - 1)
    idx = torch.where(direct[None, :, None], idx_direct, idx_hash) + offsets[None, :, None]

    t = maybe_cast(table, mixed)
    g = _ForwardOnlyGather.apply(t, idx.reshape(-1)).reshape(n, cfg.n_levels, 4, cfg.features)
    fy, fx = frac[..., 0], frac[..., 1]  # (N, L)
    wgt = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], dim=-1)
    wgt = maybe_cast(wgt, mixed)
    return maybe_cast(maybe_cast(g * wgt[..., None], mixed).sum(dim=2), mixed).reshape(n, -1)


def hashgrid_apply_flat(params: Params, coords: torch.Tensor, cfg: HashGridConfig,
                        precision: str = "fp32") -> torch.Tensor:
    """(N, 2) coords in [0, 1] -> (N, out); forward-only."""
    check_fp32(coords, "mlp=hashgrid")
    bf16, mixed = modes(precision)
    z = _pyramid_features(params[0]["w"], coords, cfg, mixed)
    return _mlp_ladder(params[1:], z, bf16, mixed)


# --- separable (tensor-product grid) path ----------------------------------


@functools.lru_cache(maxsize=None)
def hashed_level_tables(r: int, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static index tables of one hashed level ((r+1)² cells > cap rows):
    (idx, inv). idx (cells,): each dense-grid cell's hash bucket, in
    row-major (y, x) order and the uint32 arithmetic of the flat path.
    inv (cap, M): per bucket, its cells, padded with `cells` (the index of
    a zero row appended to the cotangent), so that the level's table
    gradient is dG_padded[inv].sum(1). A copy of the JAX package's
    `_hashed_level_tables`."""
    side = r + 1
    yy, xx = np.meshgrid(np.arange(side, dtype=np.uint32), np.arange(side, dtype=np.uint32),
                         indexing="ij")
    idx = ((xx ^ (yy * np.uint32(_HASH_P2))) & np.uint32(cap - 1)).reshape(-1)
    cells = side * side
    counts = np.bincount(idx, minlength=cap)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(idx, kind="stable")
    inv = np.full((cap, int(counts.max())), cells, np.int32)
    pos = np.arange(cells) - np.repeat(starts, counts)
    inv[idx[order], pos] = order
    return idx.astype(np.int32), inv


@functools.lru_cache(maxsize=None)
def _level_index(r: int, cap: int, device: torch.device):
    idx, inv = hashed_level_tables(r, cap)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(inv.astype(np.int64)).to(device))


class _Materialize(torch.autograd.Function):
    """A hashed level's table (cap, F) -> its dense grid ((r+1)², F), with the
    transpose-gather backward: the same bits on every run. Its vmap rule is
    generated: over a member axis each member's table gathers and
    transpose-gathers on its own (the member-axis forwards)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(tbl, idx, inv):
        return tbl.index_select(0, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def backward(ctx, dg):
        (inv,) = ctx.saved_tensors
        dg_pad = torch.cat([dg, dg.new_zeros((1, dg.shape[-1]))])
        grad = dg_pad.index_select(0, inv.reshape(-1)).reshape(*inv.shape, -1).sum(dim=1)
        return grad, None, None


def _interp_matrix(axis_coords: torch.Tensor, r: int) -> torch.Tensor:
    """(K,) axis coords in [0, 1] -> (K, r+1) bilinear rows (two nonzeros), the
    flat path's floor/clip/frac per axis: coord 1.0 lands on the last cell
    with frac 1.0."""
    pos = axis_coords * float(r)
    p0 = torch.clamp(torch.floor(pos), 0.0, float(r - 1))
    f = (pos - p0)[:, None]
    i0 = p0.long()[:, None]
    lanes = torch.arange(r + 1, device=axis_coords.device)[None, :]
    zero = torch.zeros((), device=axis_coords.device)
    return torch.where(lanes == i0, 1.0 - f, zero) + torch.where(lanes == i0 + 1, f, zero)


def _pyramid_features_grid(table, rows, cols, cfg: HashGridConfig, bf16: bool,
                           mixed: bool) -> torch.Tensor:
    """Tensor-product grid (rows (H,), cols (W,)) -> (H, W, L·F): per level
    A_rows @ G_l @ A_colsᵀ, the flat path's blend (its weights factorize)."""
    cap = 1 << cfg.log2_table_size
    f = cfg.features
    t = maybe_cast(table, mixed)
    h, w = rows.shape[0], cols.shape[0]
    feats = []
    for r, size, off in zip(cfg.level_resolutions, cfg.level_table_sizes, cfg.level_offsets):
        side = r + 1
        tbl = t[off:off + size]
        if side * side > cap:
            tbl = _Materialize.apply(tbl, *_level_index(r, cap, table.device))
        a_r = maybe_cast(_interp_matrix(rows, r), mixed)  # (H, side)
        a_c = maybe_cast(_interp_matrix(cols, r), mixed)  # (W, side)
        f1 = matmul(a_r, tbl.reshape(side, side * f), bf16).reshape(h, side, f)
        f1 = maybe_cast(f1, mixed)
        f2 = matmul(f1.transpose(1, 2).reshape(h * f, side), a_c.t(), bf16)  # (H F, W)
        feats.append(maybe_cast(f2.reshape(h, f, w).transpose(1, 2), mixed))
    return torch.cat(feats, dim=-1)


def hashgrid_apply(params: Params, grid: torch.Tensor, cfg: HashGridConfig,
                   precision: str = "fp32") -> torch.Tensor:
    """(H, W, 2) tensor-product grid (grid[y, x] = (rows[y], cols[x]), what
    data.get_grid makes) -> (H, W, out)."""
    check_fp32(grid, "mlp=hashgrid")
    bf16, mixed = modes(precision)
    h, w, _ = grid.shape
    z = _pyramid_features_grid(params[0]["w"], grid[:, 0, 0], grid[0, :, 1], cfg, bf16, mixed)
    return _mlp_ladder(params[1:], z.reshape(h * w, -1), bf16, mixed).reshape(h, w, -1)
