"""Fused SIREN chain: hand-written CUDA kernels and their plain-torch versions.

Replaces the Pallas TPU kernels of implicit_image_tpu/ops/sine_mlp.py:

  * `sine_mlp_fwd` (csrc/sine_mlp.cu) <- `_fwd_kernel` / `_fwd_call`: the
    whole chain for a tile of pixel rows, activations kept on chip.
    `sine_mlp_fwd_batched` launches it once over a member axis (M models of
    one shape, grid y): the counterpart of the jax.vmap over the render that
    the JAX package's decode_runs compiles, and of the batched fit's forward;
    each member's rows come out with the bits of a single launch, in every
    mode ("+mixed" too).
  * `sine_mlp_bwd` + `sum_partials`   <- `_bwd_kernel` / `_bwd_call`: the
    rematerializing backward. The TPU accumulated dW/db across sequential
    grid steps; on the card each block of a fixed grid writes its own
    partial slice and `sum_partials` adds the slices in a fixed order.
    `sine_mlp_bwd_batched` launches it once over a member axis (grid y;
    `sum_partials_batched`): the counterpart of the jax.vmap of K2 in the
    JAX package's batched fit and density ladder; each member's gradients
    come out with the bits of a single launch.

What bounds them on the card, and the design: see the note at the top of
csrc/sine_mlp.cu (arithmetic-bound chain; the hidden layers' products on
the tensor cores, bf16 wgmma). Kernel widths 128 and 192 run the fused
chain, a launch for the whole chain: a model's hidden width up to 192 is
zero-padded to the first of `KERNEL_WIDTHS` at or above it (padded units
stay exactly 0), W's bf16 planes (`weight_planes`, packed once per K1/K2
pair, in the forward) stream by bulk copies and each tile's dW is added
into the partial by bulk reduce-adds (`dw_position_index`, its order
undone here; csrc/sine_mlp.cu, "the width-192 backward"). Every width
above 192 runs on the layer-wise kernels (csrc/sine_mlp.cu, "the
layer-wise kernels"), its width rounded up to a multiple of 128
(`LAYER_TILE`) and taken at run time: a launch a layer
(`sine_mlp_layer_fwd`, `sine_mlp_layer_bwd`), the hidden layers' dW a
launch a layer (`sine_mlp_layer_dw`), then `sum_partials`; the z stash and
the activations between layers in device memory. There, under autograd,
K1 fills the z stash band by band as it computes the output and K2 takes
it in place of its recompute (the same bits); a forward under no_grad
keeps none.

Side by side in this module:

  * `siren_chain_reference` / `siren_chain_backward_reference` — the
    plain-torch versions of the same math (the backward recomputes the
    forward and mirrors the kernel step for step);
    `siren_chain_reference_batched` and
    `siren_chain_backward_reference_batched` the batched kernels', member by
    member;
  * `sum_partials_reference` — the partial sum in the kernel's order of
    additions (row groups, then the groups in order), equal to the kernel
    bit for bit on the card; only the tests and chip_smoke.py call it;
  * `siren_chain_dw_operands` / `layer_dw_reference` — the hidden layers'
    dW operands (what the layer-wise backward hands `sine_mlp_layer_dw`)
    and the split dW that `sine_mlp_layer_dw` computes from them, plain
    torch (the tests and chip_smoke.py);
  * `siren_chain_layer_partials` — the layer-wise backward's partial
    slices, each slice's rows as the kernels split them (`layer_slices`,
    `layer_slice_rows`, `dw_row_splits`), plain torch;
  * `SineMLPFunction` — the autograd.Function. A CUDA tensor runs the
    kernels, or raises; a CPU tensor runs the plain versions. Nothing falls
    back from one to the other. W's planes are packed at most once per
    forward and backward pair (kept from the forward at widths 128 and
    192); above width 192 the forward keeps the z stash for the backward
    when the caller says a backward may follow (`_wants_stash`);
  * `SineMLPBatchedFunction` — the same over a member axis (the batched
    fit's), in every mode;
  * `siren_apply_flat_fused`, `siren_apply_flat_batched_fused` — the [0,1]
    -> [-1,1] input map and the /2 + 0.5 output map around the Functions;
  * `LAUNCHES` — a count per kernel, incremented where the kernel launches;
    `LAUNCHES_BY_MODE` the same counts split by the launch's mode.

Precision modes: "fp32" (the main path: each hidden product on the
tensor cores as three bf16 planes h, m, l of each operand and the six
products with at most two orders of smallness, accumulated in fp32, which
holds the fp32 chain to ~1e-6 relative; the first and last layers are
fp32 FMA) and "bf16"
(matmul operands rounded to bf16, fp32 accumulation — what the Pallas
kernel computes). `precision_from_config` maps `train.matmul_precision`. A
1-pass TF32 product is never used.

Mixed precision (`train.mixed_precision`, the JAX package's
compute_dtype=bfloat16) is the suffix "+mixed" on either mode ("fp32+mixed",
"bf16+mixed"). It is not the bf16 mode: JAX's siren_apply_flat casts x, W
and b to bf16 and every activation back to bf16, and under autodiff each
cast rounds the cotangent that passes back through it. So on top of the
mode: x, W and b are rounded on the way in; each activation a = rnd(sin(ω
z)); in the backward the activation's cotangent ga is rounded before the
sine derivative (gz = rnd(ga) ω cos(ω z)), where the bf16 mode rounds gz
after it as a product operand; and dW, db come out rounded. The kernels
take it as a flag of the existing modes (bit 1 of their `bf16` argument):
they round the activations and ga; the wrappers round the rest.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

from implicit_image_tpu_torch.ops.fast_math import fast_cos, fast_sin

__all__ = [
    "PRECISIONS",
    "MIXED",
    "precision_modes",
    "LAUNCHES",
    "LAUNCHES_BY_MODE",
    "LAUNCHES_MIXED",
    "reset_launch_counts",
    "precision_from_config",
    "siren_chain_reference",
    "siren_chain_backward_reference",
    "siren_chain_reference_batched",
    "siren_chain_backward_reference_batched",
    "stack_members",
    "SineMLPFunction",
    "SineMLPBatchedFunction",
    "siren_apply_flat_fused",
    "siren_apply_flat_batched_fused",
    "KERNEL_TILE_ROWS",
    "KERNEL_WIDTHS",
    "PLANE_WIDTHS",
    "kernel_width",
    "partial_layout",
    "MAX_ROWS",
    "sine_mlp_fwd",
    "sine_mlp_fwd_batched",
    "sine_mlp_bwd",
    "sine_mlp_bwd_batched",
    "dw_row_splits",
    "siren_chain_dw_operands",
    "layer_dw_reference",
    "LAYER_TILE",
    "layer_slices",
    "layer_slice_rows",
    "layer_band_rows",
    "siren_chain_layer_partials",
    "sine_mlp_layer_partials",
    "sine_mlp_layer_stash",
    "sine_mlp_layer_dw",
    "LAUNCHES_BY_KIND",
    "layer_fwd_first_reference",
    "layer_fwd_last_reference",
    "layer_bwd_last_reference",
    "layer_bwd_first_reference",
    "sine_mlp_layer_fwd_first",
    "sine_mlp_layer_fwd_last",
    "sine_mlp_layer_bwd_last",
    "sine_mlp_layer_bwd_first",
    "weight_planes",
    "dw_turn_index",
    "dw_position_index",
    "SUM_PARTIALS_GROUPS",
    "sum_partials_row_groups",
    "sum_partials_reference",
    "sum_partials",
]

PRECISIONS = ("fp32", "bf16")  # the kernels' product modes
MIXED = "+mixed"  # the suffix of a mode under train.mixed_precision

# train.matmul_precision -> kernel mode. "tensorfloat32" meant 3 bf16 passes
# (~fp32) on the TPU; here it is the fp32 mode, 3 TF32 passes, never one.
# null was JAX's 1-pass bf16 default.
_PRECISION_OF = {
    "tensorfloat32": "fp32",
    "float32": "fp32",
    "bfloat16": "bf16",
    None: "bf16",
}

# launches per kernel; only the launch sites below add to these, to both:
# LAUNCHES by kernel, LAUNCHES_BY_MODE by kernel and product mode (a
# "+mixed" launch counts under its mode; sum_partials under the mode of the
# backward it sums)
LAUNCHES = {"sine_mlp_fwd": 0, "sine_mlp_fwd_batched": 0, "sine_mlp_bwd": 0,
            "sine_mlp_bwd_batched": 0, "sum_partials": 0, "sum_partials_batched": 0,
            # the layer-wise kernels (widths above 192): one count per layer launch
            "sine_mlp_layer_fwd": 0, "sine_mlp_layer_fwd_batched": 0,
            "sine_mlp_layer_bwd": 0, "sine_mlp_layer_bwd_batched": 0,
            "sine_mlp_layer_dw": 0, "sine_mlp_layer_dw_batched": 0}
LAUNCHES_BY_MODE = {k: {m: 0 for m in PRECISIONS} for k in LAUNCHES}
# the launches among LAUNCHES that ran a "+mixed" mode, per kernel
LAUNCHES_MIXED = {k: 0 for k in LAUNCHES}
# the layer-wise forward's and backward's launches by kind ("first",
# "hidden", "last"), under "<kernel> <kind>": a split of their LAUNCHES
LAYER_KINDS = ("first", "hidden", "last")
LAUNCHES_BY_KIND = {f"{k} {kind}": 0 for k in LAUNCHES
                    if k.startswith(("sine_mlp_layer_fwd", "sine_mlp_layer_bwd"))
                    for kind in LAYER_KINDS}

# the fused kernel widths of csrc/sine_mlp.cu and each one's pixel rows per
# tile of the backward (the width 128 and SINE_MLP_WIDE_GEOS there; the
# library's sine_mlp_kernel_width() and sine_mlp_tile_rows()): a SIREN of
# hidden width h runs on the first width that is >= h, zero-padded to it;
# above the last (LW_MIN there), on the layer-wise kernels at h rounded up to
# a multiple of LAYER_TILE
KERNEL_TILE_ROWS = {128: 128, 192: 64}
KERNEL_WIDTHS = tuple(KERNEL_TILE_ROWS)
# LW_T = LW_N of csrc/sine_mlp.cu: the layer-wise kernels' block tile, 128
# pixel rows by 128 columns (their tile rows, and the multiple their width
# is padded to)
LAYER_TILE = 128
# the kernel widths whose wgmma kernels stream W's bf16 planes
# (`weight_planes`, packed once per K1/K2 pair): the forward and backward at
# 128 and at 192, every fused width
PLANE_WIDTHS = KERNEL_WIDTHS

# kMaxRows of csrc/sine_mlp.cu (the library's sine_mlp_max_rows(), which the
# card tests and chip_smoke.py hold equal to it): the most
# pixel rows one forward launch takes; its row indices are int, and n + 127
# must not wrap
MAX_ROWS = 2**31 - 128

# kSumGroups of csrc/sine_mlp.cu (the library's sum_partials_groups()): the
# row groups of the partial-sum kernel's fixed order
SUM_PARTIALS_GROUPS = 2


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCHES_MIXED[k] = 0
        for m in PRECISIONS:
            LAUNCHES_BY_MODE[k][m] = 0
    for k in LAUNCHES_BY_KIND:
        LAUNCHES_BY_KIND[k] = 0


_count_lock = threading.Lock()  # multirun members launch from worker threads


def _count(kernel: str, bf16: bool, mixed: bool = False, kind: Optional[int] = None) -> None:
    with _count_lock:
        LAUNCHES[kernel] += 1
        LAUNCHES_BY_MODE[kernel][PRECISIONS[int(bf16)]] += 1
        LAUNCHES_MIXED[kernel] += int(mixed)
        if kind is not None:
            LAUNCHES_BY_KIND[f"{kernel} {LAYER_KINDS[kind]}"] += 1


def precision_from_config(matmul_precision: Optional[str], mixed: bool = False) -> str:
    """Map `train.matmul_precision` to a kernel mode ("fp32" | "bf16"), with
    the "+mixed" suffix under `train.mixed_precision`."""
    try:
        mode = _PRECISION_OF[matmul_precision]
    except KeyError:
        raise ValueError(
            f"train.matmul_precision={matmul_precision!r}; expected one of "
            f"{sorted(k for k in _PRECISION_OF if k)} or null"
        ) from None
    return mode + MIXED if mixed else mode


def precision_modes(precision: str):
    """(bf16, mixed) flags of a precision string: "fp32" | "bf16", each with
    or without the "+mixed" suffix; anything else raises ValueError."""
    mode, mixed = precision, False
    if isinstance(precision, str) and precision.endswith(MIXED):
        mode, mixed = precision[: -len(MIXED)], True
    if mode not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, each with or without "
                         f"{MIXED!r}; got {precision!r}")
    return mode == "bf16", mixed


def _check_precision(precision: str) -> bool:
    return precision_modes(precision)[0]


def _rnd(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Round to bf16 (nearest even) and back: the kernel's operand type."""
    return t.to(torch.bfloat16).float() if bf16 else t


def _rnd_params(params, mixed: bool):
    """Under mixed precision, W and b as the chain takes them (bf16 values)."""
    if not mixed:
        return params
    return tuple({k: _rnd(v.float(), True) for k, v in layer.items()} for layer in params)


def _omegas(cfg, n_layers: int) -> Sequence[float]:
    if not cfg.outermost_linear:
        raise NotImplementedError("the fused SIREN chain assumes a linear last layer")
    return [float(cfg.first_omega_0)] + [float(cfg.hidden_omega_0)] * (n_layers - 1)


# ----------------------------------------------------------- plain versions


def _chain_forward(params, x: torch.Tensor, cfg, precision: str, keep: bool = False):
    """The plain chain on mapped coordinates x (N, in): (out (N, out), zs),
    zs the pre-activations z_0 .. z_{D-2} where `keep` (the stash that the
    plain backward takes in place of its recompute), else None."""
    bf16, mixed = precision_modes(precision)
    params = _rnd_params(params, mixed)
    om = _omegas(cfg, len(params))
    a = _rnd(x.float(), bf16 or mixed)
    last = len(params) - 1
    zs = [] if keep else None
    for i, layer in enumerate(params):
        z = a @ _rnd(layer["w"], bf16) + layer["b"]
        if i == last:
            return z, zs
        if keep:
            zs.append(z)
        a = _rnd(fast_sin(om[i] * z), bf16 or mixed)
    raise ValueError("empty params")


def siren_chain_reference(params, x: torch.Tensor, cfg, precision: str = "fp32"):
    """The chain on mapped coordinates x (N, in) -> (N, out), plain torch."""
    return _chain_forward(params, x, cfg, precision)[0]


def _chain_backward(params, x: torch.Tensor, g: torch.Tensor, cfg, precision: str, layer,
                    zs=None):
    """The plain backward's walk: recomputes the forward keeping only the
    pre-activations z (or takes them from `zs`, the forward's stash), then
    goes back over the layers exactly as the kernel does (derivative of sin
    via fast_cos), calling layer(i, a_prev, gzb, gz) for each layer i, last
    first (a_prev its rounded input, gzb its rounded and gz its unrounded
    output cotangent). Returns dx. Under "+mixed" the params come in
    rounded already (the callers round them) and each activation's
    cotangent is rounded before the sine derivative."""
    bf16, mixed = precision_modes(precision)
    act = bf16 or mixed
    n_layers = len(params)
    om = _omegas(cfg, n_layers)
    xr = _rnd(x.float(), act)
    if zs is None:
        zs = _chain_forward(params, x, cfg, precision, keep=True)[1]
    a = _rnd(fast_sin(om[n_layers - 2] * zs[-1]), act) if n_layers > 1 else xr
    g = g.float()
    gb = _rnd(g, bf16)
    layer(n_layers - 1, a, gb, g)
    ga = gb @ _rnd(params[-1]["w"], bf16).t()
    for i in range(n_layers - 2, -1, -1):
        gz = _rnd(ga, mixed) * (om[i] * fast_cos(om[i] * zs[i]))
        gzb = _rnd(gz, bf16)
        layer(i, xr if i == 0 else _rnd(fast_sin(om[i - 1] * zs[i - 1]), act), gzb, gz)
        ga = gzb @ _rnd(params[i]["w"], bf16).t()
    return ga


def siren_chain_reference_batched(members, x: torch.Tensor, cfg, precision: str = "fp32"):
    """The plain version of `sine_mlp_fwd_batched`: `siren_chain_reference`
    of each member's params (a sequence of params tuples) on x, (N, in)
    shared or (M, N, in) one per member, stacked -> (M, N, out)."""
    xs = [x] * len(members) if x.dim() == 2 else list(x)
    return torch.stack([siren_chain_reference(p, xm, cfg, precision)
                        for p, xm in zip(members, xs)])


def siren_chain_backward_reference(
    params, x: torch.Tensor, g: torch.Tensor, cfg, precision: str = "fp32", zs=None
):
    """Cotangents of `siren_chain_reference` for output cotangent g (N, out):
    returns (dx, grads) with grads a tuple of {"w", "b"} dicts. Recomputes
    the forward keeping only the pre-activations z (with `zs`, the plain
    forward's stash, takes them instead: the same bits), then walks the
    layers back exactly as the kernel does (derivative of sin via
    fast_cos). Under "+mixed", dW and db come out rounded to bf16 (dx does
    not)."""
    mixed = precision_modes(precision)[1]
    grads = [None] * len(params)

    def layer(i, a_prev, gzb, gz):
        grads[i] = {"w": _rnd(a_prev.t() @ gzb, mixed), "b": _rnd(gz.sum(0), mixed)}

    dx = _chain_backward(_rnd_params(params, mixed), x, g, cfg, precision, layer, zs)
    return dx, tuple(grads)


def stack_members(trees):
    """Per-member params-like tuples of one shape (params, gradients) -> one
    tuple whose leaves carry a leading member axis."""
    return tuple({k: torch.stack([t[i][k] for t in trees]) for k in trees[0][i]}
                 for i in range(len(trees[0])))


def siren_chain_backward_reference_batched(members, x: torch.Tensor, g: torch.Tensor, cfg,
                                           precision: str = "fp32", zs=None):
    """The plain version of `sine_mlp_bwd_batched`: for M params tuples of one
    shape, x (N, in) shared or (M, N, in) one per member and g (M, N, out),
    `siren_chain_backward_reference` of each member (with `zs`, each
    member's stash), stacked -> (dx (M, N, in), grads whose leaves carry a
    leading member axis). The batched Function runs the same per member."""
    xs = [x] * len(members) if x.dim() == 2 else list(x)
    zs = [None] * len(members) if zs is None else zs
    out = [siren_chain_backward_reference(p, xm, gm, cfg, precision, z)
           for p, xm, gm, z in zip(members, xs, g, zs)]
    return torch.stack([dx for dx, _ in out]), stack_members([gr for _, gr in out])


def siren_chain_dw_operands(params, x: torch.Tensor, g: torch.Tensor, cfg,
                            precision: str = "fp32"):
    """The operands of the hidden layers' dW, as the layer-wise backward
    hands them to `sine_mlp_layer_dw`: (A, G), each (depth - 2, N, h), A[l -
    1] = rnd(a_{l-1}) and G[l - 1] = rnd(gz_l) for hidden layer l = 1 ..
    depth - 2, so that dW_l = A[l - 1]^T G[l - 1]."""
    hidden = range(1, len(params) - 1)
    ops = {}

    def layer(i, a_prev, gzb, gz):
        if i in hidden:
            ops[i] = (a_prev, gzb)

    _chain_backward(_rnd_params(params, precision_modes(precision)[1]), x, g, cfg, precision, layer)
    return (torch.stack([ops[i][0] for i in hidden]), torch.stack([ops[i][1] for i in hidden]))


def dw_row_splits(n: int, splits: int):
    """`sine_mlp_layer_dw`'s row split: `splits` contiguous (start, stop)
    ranges in order, split s holding rows [s n / S, (s + 1) n / S)."""
    return [(s * n // splits, (s + 1) * n // splits) for s in range(splits)]


def layer_dw_reference(a: torch.Tensor, g: torch.Tensor, splits: int,
                       precision: str = "fp32") -> torch.Tensor:
    """Plain version of `sine_mlp_layer_dw`, a layer at a time: a and g (L,
    N, H) -> (splits, L, H, H), row s holding sum over split s's rows
    (`dw_row_splits`) of a^T g per layer (fp32 products; bf16 mode rounds
    the operands to bf16 first, a no-op on what the layer-wise backward
    hands the kernel). `sum_partials_reference` of it is dW; the kernel
    adds each split's rows in its own order."""
    bf16 = _check_precision(precision)
    a, g = _rnd(a.float(), bf16), _rnd(g.float(), bf16)
    return torch.stack([a[:, r0:r1].transpose(1, 2) @ g[:, r0:r1]
                        for r0, r1 in dw_row_splits(a.shape[1], splits)])


def layer_slices(n: int, hidden: int, sms: int) -> int:
    """The layer-wise kernels' row slices for n rows at kernel width `hidden`
    on a card of `sms` SMs: as many as one wave of blocks of (slice, column
    tile) holds, at most one per 128-row tile, at least 1."""
    return max(1, min(-(-n // LAYER_TILE), sms // (hidden // LAYER_TILE)))


def layer_slice_rows(n: int, slices: int):
    """The rows of each slice of the layer-wise backward's row tiles: slice s
    holds tiles [s T / S, (s + 1) T / S) of the T = ceil(n / 128), as (start,
    stop) row ranges in order."""
    nt = -(-n // LAYER_TILE)
    return [(min(n, s * nt // slices * LAYER_TILE), min(n, (s + 1) * nt // slices * LAYER_TILE))
            for s in range(slices)]


def layer_band_rows(hidden: int, members: int = 1) -> int:
    """Rows per band of the layer-wise forward (K1): a multiple of 128 whose
    two activation buffers over `members` members hold about 2^28 floats
    (1 GiB); each row's output does not depend on the banding."""
    return max(LAYER_TILE, (1 << 28) // (2 * hidden * members) // LAYER_TILE * LAYER_TILE)


def _pad_params(params, hidden: int):
    """params with the hidden width zero-padded to `hidden` (padded units
    stay exactly 0), as the kernels take them."""
    pad = hidden - params[0]["w"].shape[-1]
    last = len(params) - 1
    return tuple({"w": torch.nn.functional.pad(layer["w"].float(),
                                               (0, pad if i < last else 0, 0, pad if i else 0)),
                  "b": torch.nn.functional.pad(layer["b"].float(), (0, pad if i < last else 0))}
                 for i, layer in enumerate(params))


def siren_chain_layer_partials(params, x: torch.Tensor, g: torch.Tensor, cfg,
                               precision: str = "fp32", slices: int = 1) -> torch.Tensor:
    """Plain version of the layer-wise backward's partial buffer (kernel
    width above 192): (slices, n_part) as `partial_layout` lays it out at
    the kernel width, row s holding slice s's sums: dW_0, the biases' and
    the last layer's over the rows of its row tiles (`layer_slice_rows`),
    each hidden dW_l over split s of `dw_row_splits` (`sine_mlp_layer_dw`).
    Each sum in torch's order; `sum_partials_reference` of the buffer, in
    the kernels' order over the slices, is the backward's gradients."""
    bf16, mixed = precision_modes(precision)
    depth = len(params)
    in_size, out_size = params[0]["w"].shape[0], params[-1]["w"].shape[1]
    hidden = kernel_width(params[0]["w"].shape[1])
    n = x.shape[0]
    layers = {}

    def layer(i, a_prev, gzb, gz):
        layers[i] = (a_prev, gzb, gz)

    _chain_backward(_pad_params(_rnd_params(params, mixed), hidden), x, g, cfg, precision,
                    layer)
    sizes = (in_size * hidden, (depth - 2) * hidden * hidden, hidden * out_size,
             (depth - 1) * hidden, out_size)
    n_part = -(-sum(sizes) // 4) * 4
    out = torch.zeros((slices, n_part), device=x.device)
    for s, ((r0, r1), (d0, d1)) in enumerate(zip(layer_slice_rows(n, slices),
                                                 dw_row_splits(n, slices))):
        a0, gb0, gz0 = layers[0]
        aL, gbL, gzL = layers[depth - 1]
        parts = [a0[r0:r1].t() @ gb0[r0:r1]]
        parts += [layers[i][0][d0:d1].t() @ layers[i][1][d0:d1] for i in range(1, depth - 1)]
        parts += [aL[r0:r1].t() @ gbL[r0:r1]]
        parts += [layers[i][2][r0:r1].sum(0) for i in range(depth - 1)]
        parts += [gzL[r0:r1].sum(0)]
        flat = torch.cat([t.reshape(-1) for t in parts])
        out[s, : flat.numel()] = flat
    return out


# ------------------------------------------------------------ CUDA wrappers


def _lib():
    from implicit_image_tpu_torch.ops.cuda_build import load_library

    return load_library()


def _check_cuda(name: str, t: torch.Tensor, device, shape=None, aligned: bool = True) -> None:
    """A kernel's operand: float32 and contiguous on `device`, 16-byte
    aligned (`aligned`: where a kernel moves it in 16-byte pieces)."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous() or (aligned and t.data_ptr() % 16):
        raise ValueError(f"{name}: expected a contiguous 16-byte-aligned tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _mode_flags(bf16: bool, mixed: bool) -> int:
    """The kernels' `bf16` argument: bit 0 the bf16 mode, bit 1 mixed
    precision (round the activations and their cotangents)."""
    return int(bf16) | int(mixed) << 1


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def _pack(params, hidden: int):
    """params tuple -> the kernel's packed fp32 operands, hidden width
    zero-padded to the kernel's H (padded units stay exactly 0). Leaves with
    a leading member axis give operands with that axis, in one pass."""
    depth = len(params)
    lead = tuple(params[0]["w"].shape[:-2])
    h = params[0]["w"].shape[-1]
    pad = hidden - h

    def p2(w, r, c):
        return torch.nn.functional.pad(w.float(), (0, c, 0, r))

    w0 = p2(params[0]["w"], 0, pad).contiguous()
    dev = w0.device
    if depth > 2:
        wm = torch.stack([p2(params[i]["w"], pad, pad) for i in range(1, depth - 1)],
                         dim=len(lead))
    else:
        wm = torch.zeros(lead + (1, hidden, hidden), dtype=torch.float32, device=dev)
    wl = p2(params[-1]["w"], pad, 0).contiguous()
    bs = torch.stack(
        [torch.nn.functional.pad(params[i]["b"].float(), (0, pad)) for i in range(depth - 1)],
        dim=len(lead))
    bl = params[-1]["b"].float().contiguous()
    return w0, wm.contiguous(), wl, bs.contiguous(), bl


def _is_stacked(members) -> bool:
    """True for one params tuple whose leaves carry a leading member axis
    (the batched fit's), false for a sequence of params tuples."""
    return isinstance(members[0], dict)


def _member_count(members) -> int:
    return members[0]["w"].shape[0] if _is_stacked(members) else len(members)


def _first_member(members):
    """A params tuple with member 0's shapes (views)."""
    if _is_stacked(members):
        return tuple({k: v[0] for k, v in layer.items()} for layer in members)
    return members[0]


def _pack_members(members, hidden: int, mixed: bool):
    """The packed operands of the members: a stacked params tuple's in one
    pass (each operand with a leading member axis: the batched fit's
    launches do O(depth) copies, not O(M depth)), or each params tuple's of
    a sequence, stacked (one member's without the member axis)."""
    if _is_stacked(members):
        return _pack(_rnd_params(members, mixed), hidden)
    packed = [_pack(_rnd_params(p, mixed), hidden) for p in members]
    if len(packed) == 1:
        return packed[0]
    return tuple(torch.stack(t).contiguous() for t in zip(*packed))


def kernel_width(h: int) -> int:
    """The kernel width a SIREN of hidden width h runs on: the first of
    KERNEL_WIDTHS at or above h, above them h rounded up to a multiple of
    LAYER_TILE (the layer-wise kernels). A width below 1 raises
    NotImplementedError."""
    if h < 1:
        spans = ", ".join(f"{lo}-{hi} at {hi}" for lo, hi in
                          zip((1,) + tuple(k + 1 for k in KERNEL_WIDTHS), KERNEL_WIDTHS))
        raise NotImplementedError(
            f"the CUDA SIREN kernels take hidden widths {spans} and above "
            f"{KERNEL_WIDTHS[-1]} at the next multiple of {LAYER_TILE}; got width {h}")
    hidden = next((k for k in KERNEL_WIDTHS if h <= k), None)
    return hidden if hidden is not None else -(-h // LAYER_TILE) * LAYER_TILE


def _kernel_dims(params, x: torch.Tensor):
    lib = _lib()
    max_io = lib.sine_mlp_max_io()
    depth = len(params)
    in_size, h = params[0]["w"].shape[-2:]
    out_size = params[-1]["w"].shape[-1]
    if depth < 2:
        raise NotImplementedError(f"the CUDA SIREN kernels take depth >= 2; got depth {depth}")
    hidden = kernel_width(h)
    if in_size > max_io or out_size > max_io or x.shape[1] != in_size:
        raise ValueError(f"input/output widths must be <= {max_io} and match x")
    return lib, hidden, depth, in_size, out_size


def _check_rows(n: int, what: str) -> None:
    if n > MAX_ROWS:
        raise ValueError(
            f"{what}: {n} pixel rows in one launch; the kernel takes at most {MAX_ROWS} "
            "(int row indices). Render in bands: decompress --tile-rows / "
            "render_region(tile_rows=...)")


def _planes_of(wm: torch.Tensor, hidden: int, bf16: bool, mixed: bool):
    """W's planes as the kernels of width `hidden` stream them (None where
    no kernel takes them): one where W is a bf16 value already."""
    if hidden not in PLANE_WIDTHS:
        return None
    return weight_planes(wm, 1 if bf16 or mixed else 3)


def _fwd_launch(members, x: torch.Tensor, cfg, bf16: bool, mixed: bool,
                kernel: str, keep: bool = False, stash: bool = False):
    """Pack, check and launch the forward once over `members` (params tuples
    of one shape, or one params tuple with a leading member axis) on x,
    (N, in) shared or (M, N, in) one per member -> (M, N, out); counted
    under `kernel`. At widths 128 and 192 (`PLANE_WIDTHS`) the forward
    takes W's planes (`weight_planes`); `keep` returns (out, planes, z), so
    that the backward takes the same planes (None on the layer-wise
    kernels, which pack their own) and, above 192 with `stash`, the z stash
    that the layer-wise forward filled (`_layer_fwd`; else None)."""
    n = x.shape[-2]
    _check_rows(n, kernel)
    lib, hidden, depth, in_size, out_size = _kernel_dims(_first_member(members),
                                                         x.reshape(-1, x.shape[-1]))
    if hidden > KERNEL_WIDTHS[-1]:
        out, z = _layer_fwd(members, x, cfg, bf16, mixed,
                            kernel.replace("sine_mlp_", "sine_mlp_layer_"), stash=stash)
        return (out, None, z) if keep else out
    om = _omegas(cfg, depth)
    dev = x.device
    m = _member_count(members)
    w0, wm, wl, bs, bl = _pack_members(members, hidden, mixed)
    planes = _planes_of(wm, hidden, bf16, mixed)
    x = _rnd(x.float(), mixed).contiguous()
    x_stride = n * in_size if x.dim() == 3 else 0
    out = torch.empty((m, n, out_size), dtype=torch.float32, device=dev)
    for name, t in (("x", x), ("w0", w0), ("wm", wm), ("wl", wl), ("bs", bs),
                    ("bl", bl), ("out", out)):
        _check_cuda(name, t, dev)
    if planes is not None:
        _check_cuda("planes", planes.view(torch.float32), dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sine_mlp_fwd_batched(
            x.data_ptr(), w0.data_ptr(), wm.data_ptr(),
            planes.data_ptr() if planes is not None else None, wl.data_ptr(),
            bs.data_ptr(), bl.data_ptr(), out.data_ptr(), m, x_stride, n, in_size,
            out_size, depth, hidden, om[0], om[1], _mode_flags(bf16, mixed), stream,
        )
    _raise_on(err, kernel)
    _count(kernel, bf16, mixed)
    return (out, planes, None) if keep else out


def sine_mlp_fwd(params, x: torch.Tensor, cfg, precision: str) -> torch.Tensor:
    """Launch the forward kernel: mapped coords x (N, in) on the card ->
    chain output (N, out). N above MAX_ROWS raises ValueError."""
    bf16, mixed = precision_modes(precision)
    return _fwd_launch([params], x, cfg, bf16, mixed, "sine_mlp_fwd")[0]


def _check_one_shape(members, what: str = "sine_mlp_fwd_batched") -> None:
    """A batched launch's members share their layer shapes (a stacked params
    tuple does by construction); a mismatch, or no member, raises
    ValueError."""
    if not len(members):
        raise ValueError(f"{what}: no members")
    if _is_stacked(members):
        return
    shapes = [tuple((tuple(layer["w"].shape), tuple(layer["b"].shape)) for layer in p)
              for p in members]
    for i, sh in enumerate(shapes[1:], 1):
        if sh != shapes[0]:
            raise ValueError(f"{what}: member {i} has layer shapes {sh}, "
                             f"member 0 {shapes[0]}; a batched launch takes one shape")


def sine_mlp_fwd_batched(members, x: torch.Tensor, cfg, precision: str, keep: bool = False):
    """Launch the forward kernel once over a member axis: M params tuples of
    one shape (`members`; or one params tuple whose leaves carry a leading
    member axis, the batched fit's) on mapped coords x on the card, (N, in)
    shared by every member or (M, N, in) one per member -> (M, N, out),
    member m's rows the bits of `sine_mlp_fwd(members[m], x[m], ...)`, in
    every mode. Members of different layer shapes, or N above MAX_ROWS,
    raise ValueError. `keep` returns (out, planes), W's planes as the
    backward takes them (`sine_mlp_bwd_batched(..., planes=)`; None above
    width 192)."""
    bf16, mixed = precision_modes(precision)
    _check_fwd_batched(members, x)
    got = _fwd_launch(members, x, cfg, bf16, mixed, "sine_mlp_fwd_batched", keep=keep)
    return got[:2] if keep else got


def _check_fwd_batched(members, x: torch.Tensor) -> None:
    """sine_mlp_fwd_batched's checks of its members and x."""
    _check_one_shape(members)
    m = _member_count(members)
    if x.dim() == 3 and x.shape[0] != m:
        raise ValueError(f"sine_mlp_fwd_batched: x holds {x.shape[0]} members' coordinates, "
                         f"there are {m} members")
    if x.dim() not in (2, 3) or m > 65535:
        raise ValueError("sine_mlp_fwd_batched: x must be (N, in) or (M, N, in), M <= 65535")


def partial_layout(n: int, depth: int, in_size: int, width: int, out_size: int, device):
    """The backward kernel's partial-gradient buffer for n pixel rows of a
    SIREN of hidden width `width`: returns (grid, n_part, sizes) — one slice
    of n_part floats per block (one block per SM, at most one per tile; for
    the layer-wise kernels above 192, one per row slice, `layer_slices`),
    holding dw0, dwm, dwl, dbs, dbl (`sizes` floats each, at the kernel
    width) in that order."""
    hidden = kernel_width(width)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sizes = (
        in_size * hidden,                 # dw0
        (depth - 2) * hidden * hidden,    # dwm
        hidden * out_size,                # dwl
        (depth - 1) * hidden,             # dbs
        out_size,                         # dbl
    )
    # each block's slice starts 16-byte aligned: the kernel moves dW partials as float2
    n_part = -(-sum(sizes) // 4) * 4
    if hidden > KERNEL_WIDTHS[-1]:  # the layer-wise kernels: one slice per row slice
        return layer_slices(n, hidden, sms), n_part, sizes
    return max(1, min(-(-n // KERNEL_TILE_ROWS[hidden]), sms)), n_part, sizes


# W rows of a ring slice of the wgmma kernels (BW_KS of csrc/sine_mlp.cu)
_RING_ROWS = 16


def _bf16_planes(wm: torch.Tensor, planes: int) -> torch.Tensor:
    """wm (..., L, h, h) -> its first `planes` bf16 planes (..., L, planes,
    h, h): plane p = bf16(W - planes 0 .. p-1), nearest even (three hold an
    fp32 W exactly, one is the bf16 mode's rounding)."""
    rest, parts = wm.float(), []
    for p in range(planes):
        parts.append(rest.to(torch.bfloat16))
        if p + 1 < planes:
            rest = rest - parts[-1]  # fp32: the bf16 plane converts exactly
    return torch.stack(parts, dim=-3)


def weight_planes(wm: torch.Tensor, planes: int) -> torch.Tensor:
    """The hidden weights as the wgmma kernels' rings stream them (the
    forward and backward of widths 128 and 192): wm (...,
    L, h, h) fp32, h in PLANE_WIDTHS -> bf16 (..., 2, L, h / 16, planes, 2,
    h / 8, 8, 8).

    Plane p of W is bf16(W - planes 0 .. p-1) (nearest even; three planes
    hold an fp32 W exactly, one is the bf16 mode's rounding). Image 0 (a.W,
    the forward pass) cuts W into h / 16 slices of 16 rows, image 1 (gz.W^T,
    the backward pass) into h / 16 slices of 16 columns; a slice's planes
    follow each other, and each plane is 2 x h / 8 core matrices of 8 x 8
    values, 8 consecutive columns of W a row: [.., u, p, kg, ng, r, c] =
    W[16 u + 8 kg + r][8 ng + c] in image 0 and W[8 ng + r][16 u + 8 kg + c]
    in image 1 (kg the slice's K group, ng the N group: csrc/hopper.cuh's
    layout)."""
    lead, layers, h = wm.shape[:-3], wm.shape[-3], wm.shape[-1]
    if h not in PLANE_WIDTHS or wm.shape[-2] != h:
        raise ValueError(f"weight_planes: expected (..., L, h, h) with h in {PLANE_WIDTHS}, "
                         f"got {tuple(wm.shape)}")
    pl = _bf16_planes(wm, planes)  # (..., L, planes, h, h)
    n, u = len(lead), h // _RING_ROWS
    shape = lead + (layers, planes)
    fwd = pl.reshape(shape + (u, _RING_ROWS // 8, 8, h // 8, 8)).permute(
        *range(n), n, n + 2, n + 1, n + 3, n + 5, n + 4, n + 6)
    bwd = pl.reshape(shape + (h // 8, 8, u, _RING_ROWS // 8, 8)).permute(
        *range(n), n, n + 4, n + 1, n + 5, n + 2, n + 3, n + 6)
    return torch.stack([fwd, bwd], dim=n).contiguous()


# K of a stage of the layer-wise hidden forward's ring (LF_KC of
# csrc/sine_mlp.cu): W's planes stream in chunks of this many rows
_LAYER_CHUNK = 32


def layer_weight_planes(wm: torch.Tensor, planes: int) -> torch.Tensor:
    """The hidden weights as the layer-wise forward's ring streams them (the
    hidden layers' sine_mlp_layer_fwd above width 192): wm (..., L, h, h)
    fp32, h a multiple of LAYER_TILE -> bf16 (..., L, h / 128, h / 32,
    planes, 4, 16, 8, 8).

    Plane p as in `weight_planes`. Column tile c (128 columns, a block's)
    holds h / 32 chunks of 32 rows in order, a chunk its planes one after
    another, each plane 4 x 16 core matrices of 8 x 8 values, 8 consecutive
    columns of W a row: [.., c, k, p, kg, ng, r, cc] = plane p of W[32 k + 8
    kg + r][128 c + 8 ng + cc] (csrc/hopper.cuh's layout, B N-major); a
    chunk is one bulk copy of planes x 8 KB."""
    if (wm.dim() < 3 or wm.shape[-1] % LAYER_TILE or wm.shape[-2] != wm.shape[-1]
            or wm.shape[-1] < LAYER_TILE):
        raise ValueError(f"layer_weight_planes: expected (..., L, h, h) with h a multiple of "
                         f"{LAYER_TILE}, got {tuple(wm.shape)}")
    lead, layers, h = wm.shape[:-3], wm.shape[-3], wm.shape[-1]
    pl = _bf16_planes(wm, planes)  # (..., L, planes, h, h)
    n, k = len(lead), _LAYER_CHUNK
    pl = pl.reshape(lead + (layers, planes, h // k, k // 8, 8, h // LAYER_TILE,
                            LAYER_TILE // 8, 8))
    # (L, planes, k, kg, r, c, ng, cc) -> (L, c, k, planes, kg, ng, r, cc)
    return pl.permute(*range(n), n, n + 5, n + 2, n + 1, n + 3, n + 6, n + 4,
                      n + 7).contiguous()


def dw_turn_index(hidden: int = 128) -> torch.Tensor:
    """Where the width-128 backward leaves dW[i][j] in row i of its partial:
    the row's 16-byte chunks turned by i % 8 (column ((j / 4 + i % 8) mod
    hidden / 4) * 4 + j % 4), as it stages dW for its reduce-add."""
    i = torch.arange(hidden).view(-1, 1)
    j = torch.arange(hidden).view(1, -1)
    return (((j >> 2) + (i & 7)) & (hidden // 4 - 1)) * 4 + (j & 3)


# the width-192 backward's dW pieces: 64 rows of dW by the 96 columns of a
# warpgroup (B2_PIECE of csrc/sine_mlp.cu)
_PIECE_ROWS, _PIECE_COLS = 64, 96


def dw_position_index(hidden: int) -> torch.Tensor:
    """Where the wgmma backward of kernel width `hidden` (128 or 192) leaves
    dW[i][j] in a layer's hidden^2 floats of its partial: (hidden, hidden)
    flat positions. At 128 row i holds row i, its 16-byte chunks turned
    (`dw_turn_index`). At 192 the layer is 6 pieces of 64 x 96 in the order
    (i / 64, j / 96), each in the order its warpgroup's threads hold it:
    element (16 wi + g + 8 h, 8 ni + 2 t + q) of a piece at ((2 ni + h) *
    128 + 32 wi + 4 g + t) * 2 + q (csrc b2_stage_at)."""
    if hidden == KERNEL_WIDTHS[0]:
        return torch.arange(hidden).view(-1, 1) * hidden + dw_turn_index(hidden)
    if hidden != 192:
        raise ValueError(f"dw_position_index: no wgmma backward of width {hidden}")
    i = torch.arange(hidden).view(-1, 1)
    j = torch.arange(hidden).view(1, -1)
    pi, pj = i % _PIECE_ROWS, j % _PIECE_COLS
    piece = (i // _PIECE_ROWS) * (hidden // _PIECE_COLS) + j // _PIECE_COLS
    wi, g, h = pi // 16, pi % 8, (pi % 16) // 8
    ni, t, q = pj // 8, (pj % 8) // 2, pj % 2
    return (piece * _PIECE_ROWS * _PIECE_COLS
            + ((2 * ni + h) * 128 + 32 * wi + 4 * g + t) * 2 + q)


# (device, width) -> dw_position_index there (a host copy each step would sync)
_POSITION_INDEX = {}


def _unturn_dw(dwm: torch.Tensor) -> torch.Tensor:
    """The wgmma backward's summed dW_m (..., L, h, h), in its partial's
    order (`dw_position_index`), back in row-major order."""
    h = dwm.shape[-1]
    key = (dwm.device, h)
    idx = _POSITION_INDEX.get(key)
    if idx is None:
        idx = _POSITION_INDEX[key] = dw_position_index(h).reshape(-1).to(dwm.device)
    flat = dwm.reshape(dwm.shape[:-2] + (h * h,))
    return torch.gather(flat, -1, idx.expand(flat.shape)).reshape(dwm.shape)


def _check_fits(nbytes: int, dev, what: str) -> None:
    """Raise ValueError, before anything is allocated, when a launch's
    buffers (`nbytes`) exceed the device's free memory."""
    free, _ = torch.cuda.mem_get_info(dev)
    if nbytes > free:
        raise ValueError(f"{what} needs {nbytes / 2**30:.2f} GiB of buffers and {dev} has "
                         f"{free / 2**30:.2f} GiB free: fit fewer members at once")


def _bwd_launch(members, x: torch.Tensor, g: torch.Tensor, cfg, precision: str,
                batched: bool, planes: Optional[torch.Tensor] = None,
                z: Optional[torch.Tensor] = None):
    """Pack, check and launch the backward, then the partial sum, once over
    `members` (params tuples of one shape, or one params tuple with a
    leading member axis): x (N, in) shared or (M, N, in), g (M, N, out)
    when `batched`, else one member with x (N, in) and g (N, out).
    `planes`: W's planes (`weight_planes`) where the forward packed them,
    else packed here at widths 128 and 192. `z`: above 192, the z stash that
    the forward filled (`_layer_fwd(..., stash=True)`), which the backward
    then consumes in place of its recompute. Returns (dx, grads), every
    leaf with a leading member axis when `batched`; the launches count
    under the batched keys when `batched`."""
    bf16, mixed = precision_modes(precision)
    first = _first_member(members)
    lib, hidden, depth, in_size, out_size = _kernel_dims(first, x.reshape(-1, x.shape[-1]))
    if hidden > KERNEL_WIDTHS[-1]:
        dx, partials, sizes = _layer_bwd(members, x, g, cfg, precision, batched, z=z)
        flat = (sum_partials_batched if batched else sum_partials)(partials, precision)
        lead = (_member_count(members),) if batched else ()
        return dx, _split_grads(_rnd(flat, True) if mixed else flat, lead, sizes, depth,
                                in_size, hidden, first[0]["w"].shape[1], out_size, turned=False)
    om = _omegas(cfg, depth)
    dev = x.device
    m = _member_count(members)
    h = first[0]["w"].shape[1]
    n = x.shape[-2]
    tile = KERNEL_TILE_ROWS[hidden]
    grid, n_part, sizes = partial_layout(n, depth, in_size, h, out_size, dev)
    stash = max(depth - 3, 1)
    lead = (m,) if batched else ()
    if batched:
        # dx, the z stash, the partials and their sums, per member (module
        # note on sine_mlp_bwd_batched)
        _check_fits(4 * m * (n * in_size + grid * stash * tile * hidden + (grid + 1) * n_part),
                    dev, f"sine_mlp_bwd_batched over {m} members")
    w0, wm, wl, bs, _ = _pack_members(members, hidden, mixed)
    # W's bf16 planes (one where W is a bf16 value already), the products' B
    planes = planes if planes is not None else _planes_of(wm, hidden, bf16, mixed)
    x = _rnd(x.float(), mixed).contiguous()
    g = g.float().contiguous()
    x_stride = n * in_size if x.dim() == 3 else 0
    flags = _mode_flags(bf16, mixed)
    dx = torch.empty(lead + (n, in_size), dtype=torch.float32, device=dev)
    # the z stash: one (tile, hidden) slice per block for z_1 .. z_{depth-3}
    z_scratch = torch.empty(lead + (grid, stash, tile, hidden), dtype=torch.float32,
                            device=dev)
    partials = torch.empty(lead + (grid, n_part), dtype=torch.float32, device=dev)
    for name, t in (("x", x), ("w0", w0), ("wm", wm), ("wl", wl), ("bs", bs), ("dx", dx),
                    ("z_scratch", z_scratch), ("partials", partials)):
        _check_cuda(name, t, dev)
    _check_cuda("planes", planes.view(torch.float32), dev)
    _check_cuda("g", g, dev, lead + (n, out_size))
    kernel = "sine_mlp_bwd_batched" if batched else "sine_mlp_bwd"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sine_mlp_bwd_batched(
            x.data_ptr(), g.data_ptr(), w0.data_ptr(), wm.data_ptr(), planes.data_ptr(),
            wl.data_ptr(), bs.data_ptr(), dx.data_ptr(), z_scratch.data_ptr(),
            partials.data_ptr(), m, x_stride, grid, n_part, n, in_size, out_size, depth, hidden,
            om[0], om[1], flags, stream,
        )
    _raise_on(err, kernel)
    _count(kernel, bf16, mixed)
    flat = (sum_partials_batched if batched else sum_partials)(partials, precision)
    if mixed:
        flat = _rnd(flat, True)
    return dx, _split_grads(flat, lead, sizes, depth, in_size, hidden, h, out_size, turned=True)


def _split_grads(flat: torch.Tensor, lead, sizes, depth: int, in_size: int, hidden: int, h: int,
                 out_size: int, turned: bool):
    """The summed partial (lead + (n_part,)) -> the gradients' params tuple
    at the model's width h (`turned`: dW_m in the wgmma backward's order,
    `dw_position_index`)."""
    dw0, dwm, dwl, dbs, dbl = torch.split(flat[..., : sum(sizes)], sizes, dim=-1)
    dw0 = dw0.reshape(lead + (in_size, hidden))[..., :h]
    dwm = dwm.reshape(lead + (depth - 2, hidden, hidden))
    if turned:
        dwm = _unturn_dw(dwm)
    dwm = dwm[..., :h, :h]
    dwl = dwl.reshape(lead + (hidden, out_size))[..., :h, :]
    dbs = dbs.reshape(lead + (depth - 1, hidden))[..., :h]
    grads = [{"w": dw0, "b": dbs[..., 0, :]}]
    grads += [{"w": dwm[..., i - 1, :, :], "b": dbs[..., i, :]} for i in range(1, depth - 1)]
    grads.append({"w": dwl, "b": dbl})
    return tuple(grads)


def sine_mlp_bwd(params, x: torch.Tensor, g: torch.Tensor, cfg, precision: str):
    """Launch the backward kernel(s) and the partial-sum kernel: returns
    (dx, grads) in the layout of `siren_chain_backward_reference`. Above
    kernel width 192 the layer-wise kernels (`_layer_bwd`). Under "+mixed"
    dW and db come out rounded to bf16, as
    `siren_chain_backward_reference`'s."""
    return _bwd_launch([params], x, g, cfg, precision, batched=False)


def sine_mlp_bwd_batched(members, x: torch.Tensor, g: torch.Tensor, cfg, precision: str,
                         planes: Optional[torch.Tensor] = None):
    """Launch the backward once over a member axis: M params tuples of one
    shape (`members`; or one params tuple whose leaves carry a leading member
    axis, the batched fit's), mapped coords x on the card, (N, in) shared by every
    member or (M, N, in) one per member, and output cotangents g (M, N, out)
    -> (dx (M, N, in), grads), every leaf of grads with a leading member
    axis; member m's outputs the bits of `sine_mlp_bwd(members[m], x[m],
    g[m], ...)`. One launch each of the backward (grid y = member) and of
    sum_partials, counted under "sine_mlp_bwd_batched" and
    "sum_partials_batched" (above kernel width 192 the layer-wise kernels'
    launches, under their "_batched" keys). `planes`: W's planes from the
    forward (`sine_mlp_fwd_batched(..., keep=True)`), else packed here.

    Memory per member, in fp32 buffers, at 512² pixels and depth 8: at
    width 128 the partials, 132 blocks x 99,844 floats = 53 MB, and the z
    stash, 132 x 5 x 128 x 128 floats = 43 MB; at width 182 (kernel width
    192) the partials, 132 x 200,931 floats = 106 MB, and the z stash, 132
    x 5 x 64 x 192 floats = 32 MB; above 192 the layer-wise backward's
    (`_layer_bwd`). When the M members' buffers exceed the device's free
    memory this raises ValueError before allocating; it never falls back to
    single launches. Members of different layer shapes
    or more than 65,535 members raise ValueError too. Every mode has its
    instantiation, "+mixed" too: member m's dW and db then come out rounded
    to bf16, as sine_mlp_bwd's."""
    _check_bwd_batched(members, x, g)
    return _bwd_launch(members, x, g, cfg, precision, batched=True, planes=planes)


def _check_bwd_batched(members, x: torch.Tensor, g: torch.Tensor) -> None:
    """sine_mlp_bwd_batched's checks of its members, x and g."""
    _check_one_shape(members, "sine_mlp_bwd_batched")
    n = x.shape[-2]
    m = _member_count(members)
    if x.dim() not in (2, 3) or (x.dim() == 3 and x.shape[0] != m):
        raise ValueError(f"sine_mlp_bwd_batched: x must be (N, in) or ({m}, N, in), "
                         f"got {tuple(x.shape)}")
    out_size = _first_member(members)[-1]["w"].shape[1]
    if tuple(g.shape) != (m, n, out_size) or m > 65535:
        raise ValueError(f"sine_mlp_bwd_batched: g must be ({m}, {n}, {out_size}) "
                         f"with at most 65,535 members, got {tuple(g.shape)}")


def _members_lead(packed):
    """The packed operands (w0, wm, wl, bs, bl) each with a leading member
    axis (a view with one where a single member's have none)."""
    return [t if t.dim() > d else t.unsqueeze(0) for t, d in zip(packed, (2, 3, 2, 2, 1))]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _mstride(t: Optional[torch.Tensor]) -> int:
    """Floats from one member's matrix to the next along t's leading member
    axis (0: one matrix, shared)."""
    return 0 if t is None or t.shape[0] == 1 else t.stride(0)


def _layer_args(n: int, in_size: int, hidden: int, out_size: int, slices: int, members: int,
                omega: float = 0.0, n_part: int = 0, offsets=None, **mats):
    """csrc LayerArgs for one launch: `mats` the matrices by field name
    (src, g, w, b, dst, z, x, part), each with a leading member axis or
    shared; `offsets` the partial slice's regions by field name."""
    from implicit_image_tpu_torch.ops.cuda_build import LayerArgs

    a = LayerArgs(n=n, n_part=n_part, in_size=in_size, hidden=hidden, out_size=out_size,
                  slices=slices, omega=omega, members=members,
                  off_db=-1, off_dw0=-1, off_dwl=-1, off_dbl=-1, off_dw=-1)
    for k, t in mats.items():
        setattr(a, k, _ptr(t))
        setattr(a, f"{k}_m", _mstride(t))
    for k, v in (offsets or {}).items():
        setattr(a, k, v)
    return a


def _layer_launch(lib, fn: str, args, kind: Optional[int], bf16: bool, mixed: bool,
                  name: str, dev) -> None:
    import ctypes

    stream = torch.cuda.current_stream(dev).cuda_stream
    extra = () if kind is None else (kind,)
    err = getattr(lib, fn)(ctypes.byref(args), *extra, _mode_flags(bf16, mixed), stream)
    _raise_on(err, name)
    _count(name, bf16, mixed, kind)


# the layer kernels' kinds (LwKind of csrc/sine_mlp.cu)
_FIRST, _HIDDEN, _LAST = 0, 1, 2


def _layer_planes(wm: torch.Tensor, bf16: bool, mixed: bool) -> torch.Tensor:
    """W's planes as the layer-wise hidden forward streams them
    (`layer_weight_planes`; one plane where W is a bf16 value already), as
    float32 words: the kernel reads them as bf16 pairs, and LayerArgs's
    member stride counts floats."""
    return layer_weight_planes(wm, 1 if bf16 or mixed else 3).view(torch.float32)


def _layer_chain_fwd(lib, ops, x, n: int, dims, om, acts, bf16: bool, mixed: bool, name: str,
                     z=None, out=None) -> None:
    """The forward's layer launches over rows [0, n) of x (n rows): a_l into
    acts[:, l % 2] (the last hidden layer's only where `out` is given), z_l
    into z[:, l] where the stash (M, D-1, n, H), or a view of its rows, is
    given, and with `out`, out = a_L W_{D-1} + b_{D-1}. ops: (W_0, the
    hidden W's planes (`_layer_planes`), W_{D-1}, the biases, b_{D-1}), each
    with a leading member axis."""
    w0, wp, wl, bs, bl = ops
    in_size, hidden, out_size, depth, m = dims
    dev = x.device
    slices = layer_slices(n, hidden, torch.cuda.get_device_properties(dev).multi_processor_count)
    layers = depth - 2
    common = dict(n=n, in_size=in_size, hidden=hidden, out_size=out_size, slices=slices,
                  members=m)
    for l in range(layers + 1):
        dst = acts[:, l % 2] if (l < layers or out is not None) else None
        args = _layer_args(omega=om[l], src=x if l == 0 else acts[:, (l - 1) % 2],
                           w=w0 if l == 0 else wp[:, l - 1], b=bs[:, l], dst=dst,
                           z=None if z is None else z[:, l], **common)
        _layer_launch(lib, "sine_mlp_layer_fwd", args, _FIRST if l == 0 else _HIDDEN, bf16,
                      mixed, name, dev)
    if out is not None:
        args = _layer_args(src=acts[:, layers % 2], w=wl, b=bl, dst=out, **common)
        _layer_launch(lib, "sine_mlp_layer_fwd", args, _LAST, bf16, mixed, name, dev)


def _layer_fwd(members, x: torch.Tensor, cfg, bf16: bool, mixed: bool, name: str,
               stash: bool = False):
    """The forward on the layer-wise kernels (kernel width above 192) over
    `members` on x, (N, in) shared or (M, N, in) -> (out (M, N, out), z), in
    bands of `layer_band_rows` rows; counted per launch under `name`. With
    `stash` (a backward will follow: the autograd Functions under grad) z
    is the z stash (M, D-1, N, H) that K2 takes in place of its recompute,
    each band's layers writing their rows of it; else None. The stash is
    allocated once, the activations stay band-sized; when the stash and the
    band's buffers exceed the device's free memory this raises ValueError
    first."""
    lib, hidden, depth, in_size, out_size = _kernel_dims(_first_member(members),
                                                         x.reshape(-1, x.shape[-1]))
    om = _omegas(cfg, depth)
    dev = x.device
    m = _member_count(members)
    n = x.shape[-2]
    band = layer_band_rows(hidden, m)
    if stash:
        _check_fits(4 * m * ((depth - 1) * n * hidden + 2 * min(band, n) * hidden
                             + n * out_size), dev,
                    f"the layer-wise forward's z stash at width {hidden} over {n} rows"
                    + (f" and {m} members" if m > 1 else "")
                    + " (train.pixel_chunks splits the rows)")
    ops = _members_lead(_pack_members(members, hidden, mixed))
    ops[1] = _layer_planes(ops[1], bf16, mixed)  # once per call
    x = _rnd(x.float(), mixed).contiguous()
    xm = x if x.dim() == 3 else x.unsqueeze(0)
    out = torch.empty((m, n, out_size), dtype=torch.float32, device=dev)
    z = (torch.empty((m, depth - 1, n, hidden), dtype=torch.float32, device=dev)
         if stash else None)
    for name_, t in zip(("w0", "planes", "wl", "bs", "bl"), ops):
        _check_cuda(name_, t, dev)
    _check_cuda("x", x, dev, aligned=False)  # read a value at a time
    acts = torch.empty((m, 2, min(band, n), hidden), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        for r0 in range(0, n, band):
            r1 = min(n, r0 + band)
            _layer_chain_fwd(lib, ops, xm[:, r0:r1], r1 - r0,
                             (in_size, hidden, out_size, depth, m), om, acts, bf16, mixed,
                             name, z=None if z is None else z[:, :, r0:r1],
                             out=out[:, r0:r1])
    return out, z


def _layer_bwd(members, x: torch.Tensor, g: torch.Tensor, cfg, precision: str, batched: bool,
               z: Optional[torch.Tensor] = None):
    """The backward on the layer-wise kernels (kernel width above 192), up
    to the partial sum: without `z` the forward's layer launches again to
    fill the z stash (`_layer_stash`), with `z` (the stash that K1 filled
    under autograd) none of them; then per layer, last first,
    `sine_mlp_layer_bwd` and (hidden layers)
    `sine_mlp_layer_dw`, then dx; the hidden launches write A_{l-1} over
    z_{l-1}, so the stash is used up. Returns (dx, partials, sizes): dx (M,
    N, in) and partials (M, S, n_part) when `batched`, else one member's.
    Buffers: the z stash (M, D-1, N, H) unless given, two (M, N, H) buffers
    (the recompute's activations, then G_l in buffer l % 2), the partials
    and the hidden W^T's planes (`_layer_planes`, packed once a call), and
    W's for the recompute; when they exceed the device's free memory this
    raises ValueError first."""
    bf16, mixed = precision_modes(precision)
    first = _first_member(members)
    lib, hidden, depth, in_size, out_size = _kernel_dims(first, x.reshape(-1, x.shape[-1]))
    om = _omegas(cfg, depth)
    dev = x.device
    m = _member_count(members)
    n = x.shape[-2]
    layers = depth - 2
    # the row slices of the layer-wise kernels (partial_layout's at every
    # kernel width above 192)
    _, n_part, sizes = partial_layout(n, depth, in_size, first[0]["w"].shape[1], out_size, dev)
    slices = layer_slices(n, hidden, torch.cuda.get_device_properties(dev).multi_processor_count)
    # one set of the hidden layers' bf16 planes, in floats
    plane_floats = (1 if bf16 or mixed else 3) * layers * hidden * hidden // 2
    recompute = z is None
    _check_fits(4 * m * ((layers + 1) * n * hidden * recompute + 2 * n * hidden
                         + slices * n_part + n * in_size + (1 + recompute) * plane_floats), dev,
                f"the layer-wise backward at width {hidden} over {n} rows"
                + (f" and {m} members" if batched else "")
                + " (train.pixel_chunks splits the rows)")
    ops = _members_lead(_pack_members(members, hidden, mixed))
    w0, wm, wl, bs, bl = ops
    wtp = _layer_planes(wm.transpose(-1, -2), bf16, mixed)  # W^T's, the backward's, once
    x = _rnd(x.float(), mixed).contiguous()
    xm = x if x.dim() == 3 else x.unsqueeze(0)
    g = g.float().contiguous()
    gm = g if g.dim() == 3 else g.unsqueeze(0)
    for name_, t in zip(("w0", "wm", "wl", "bs", "planes"), (*ops[:4], wtp)):
        _check_cuda(name_, t, dev)
    # x and g are read a value at a time
    _check_cuda("x", x, dev, aligned=False)
    _check_cuda("g", gm, dev, (m, n, out_size), aligned=False)
    if not recompute:
        _check_cuda("z", z, dev, (m, layers + 1, n, hidden))
    bufs = torch.empty((m, 2, n, hidden), dtype=torch.float32, device=dev)
    partials = torch.empty((m, slices, n_part), dtype=torch.float32, device=dev)
    dx = torch.empty((m, n, in_size), dtype=torch.float32, device=dev)
    suffix = "_batched" if batched else ""
    dims = (in_size, hidden, out_size, depth, m)
    # regions of a partial slice: dw0, dwm, dwl, dbs, dbl (partial_layout)
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    common = dict(n=n, in_size=in_size, hidden=hidden, out_size=out_size, slices=slices,
                  members=m, n_part=n_part)
    with torch.cuda.device(dev):
        if recompute:
            z = _layer_stash(lib, ops, xm, n, dims, om, bufs, bf16, mixed,
                             "sine_mlp_layer_fwd" + suffix)
        # the last layer: G_L into bufs[:, L % 2]; dW_0 here too at depth 2
        args = _layer_args(
            omega=om[layers], src=gm, w=wl, z=z[:, layers], dst=bufs[:, layers % 2],
            x=xm if layers == 0 else None, part=partials,
            offsets=dict(off_db=starts[3] + layers * hidden, off_dw0=starts[0],
                         off_dwl=starts[2], off_dbl=starts[4]), **common)
        _layer_launch(lib, "sine_mlp_layer_bwd", args, _LAST, bf16, mixed,
                      "sine_mlp_layer_bwd" + suffix, dev)
        for l in range(layers, 0, -1):  # ga_{l-1} = G_l W_l^T, then dW_l = A_l^T G_l
            args = _layer_args(
                omega=om[l - 1], g=bufs[:, l % 2], w=wtp[:, l - 1], z=z[:, l - 1],
                dst=bufs[:, (l - 1) % 2], x=xm if l == 1 else None, part=partials,
                offsets=dict(off_db=starts[3] + (l - 1) * hidden, off_dw0=starts[0]), **common)
            _layer_launch(lib, "sine_mlp_layer_bwd", args, _HIDDEN, bf16, mixed,
                          "sine_mlp_layer_bwd" + suffix, dev)
            _layer_dw_launch(lib, z[:, l - 1], bufs[:, l % 2], partials,
                             starts[1] + (l - 1) * hidden * hidden, bf16, mixed,
                             "sine_mlp_layer_dw" + suffix)
        args = _layer_args(g=bufs[:, 0], w=w0, dst=dx, **common)
        _layer_launch(lib, "sine_mlp_layer_bwd", args, _FIRST, bf16, mixed,
                      "sine_mlp_layer_bwd" + suffix, dev)
    if batched:
        return dx, partials, sizes
    return dx[0], partials[0], sizes


def _layer_stash(lib, ops, xm: torch.Tensor, n: int, dims, om, acts: torch.Tensor, bf16: bool,
                 mixed: bool, name: str) -> torch.Tensor:
    """K2's recompute of the z stash: the forward's layer launches over all
    n rows of xm in one pass (one row slicing, where K1 bands the rows),
    through the activation buffers acts (M, 2, n, H) -> z (M, D-1, n, H).
    ops: the packed (W_0, W_m, W_{D-1}, biases, b_{D-1}), each with a
    leading member axis; W_m's planes are made here."""
    in_size, hidden, out_size, depth, m = dims
    w0, wm, wl, bs, bl = ops
    z = torch.empty((m, depth - 1, n, hidden), dtype=torch.float32, device=xm.device)
    _layer_chain_fwd(lib, (w0, _layer_planes(wm, bf16, mixed), wl, bs, bl), xm, n, dims, om,
                     acts, bf16, mixed, name, z=z)
    return z


def sine_mlp_layer_stash(members, x: torch.Tensor, cfg, precision: str) -> torch.Tensor:
    """The z stash that K2 recomputes above width 192 (`sine_mlp_bwd` and
    `sine_mlp_bwd_batched` without a stash from the forward), on the card:
    members as sine_mlp_fwd_batched takes them (a sequence of params tuples
    of one shape, or one params tuple with a leading member axis), x (N, in)
    or (M, N, in) -> z (M, D-1, N, H), z_l of layer l = 0 .. D-2 at the
    kernel width. chip_smoke.py and the card tests hold the stash that K1
    fills under autograd against it bit for bit. Counted as the recompute
    is, under "sine_mlp_layer_fwd" (its "_batched" key over more than one
    member)."""
    bf16, mixed = precision_modes(precision)
    _check_fwd_batched(members, x)
    lib, hidden, depth, in_size, out_size = _kernel_dims(_first_member(members),
                                                         x.reshape(-1, x.shape[-1]))
    if hidden <= KERNEL_WIDTHS[-1]:
        raise ValueError("sine_mlp_layer_stash: the layer-wise kernels run widths above "
                         f"{KERNEL_WIDTHS[-1]} only")
    dev = x.device
    m, n = _member_count(members), x.shape[-2]
    ops = _members_lead(_pack_members(members, hidden, mixed))
    x = _rnd(x.float(), mixed).contiguous()
    xm = x if x.dim() == 3 else x.unsqueeze(0)
    _check_cuda("x", x, dev, aligned=False)
    acts = torch.empty((m, 2, n, hidden), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        return _layer_stash(lib, ops, xm, n, (in_size, hidden, out_size, depth, m),
                            _omegas(cfg, depth), acts, bf16, mixed,
                            "sine_mlp_layer_fwd" + ("_batched" if m > 1 else ""))


def _layer_dw_launch(lib, a: torch.Tensor, g: torch.Tensor, partials: torch.Tensor,
                     offset: int, bf16: bool, mixed: bool, name: str) -> None:
    """One sine_mlp_layer_dw launch: a and g (M, N, H), partials (M, S,
    n_part)."""
    m, n, hidden = a.shape
    args = _layer_args(n=n, in_size=1, hidden=hidden, out_size=1, slices=partials.shape[-2],
                       members=m, n_part=partials.shape[-1], offsets=dict(off_dw=offset),
                       src=a, g=g, part=partials)
    _layer_launch(lib, "sine_mlp_layer_dw", args, None, bf16, mixed, name, a.device)


def sine_mlp_layer_dw(a: torch.Tensor, g: torch.Tensor, partials: torch.Tensor, offset: int,
                      precision: str) -> None:
    """Launch sine_mlp_layer_dw for one hidden layer: a = rnd(a_{l-1}) and
    g = rnd(gz_l), (N, H) fp32 on the card (H a multiple of LAYER_TILE) ->
    for each of the S = partials.shape[-2] row splits of `dw_row_splits(N,
    S)`, partials[s, offset ..] = the row-major H x H sum of a^T g over the
    split's rows (`layer_dw_reference` of a[None], g[None]). With a
    leading member axis on a, g (M, N, H) and partials (M, S, P): one launch
    over the members, counted as "sine_mlp_layer_dw_batched". Shapes,
    alignment or a CPU tensor it does not take raise ValueError before the
    library is built. No atomics: a call repeats bit for bit."""
    batched = a.dim() == 3
    name = "sine_mlp_layer_dw_batched" if batched else "sine_mlp_layer_dw"
    if (a.dim() not in (2, 3) or tuple(a.shape) != tuple(g.shape)
            or a.shape[-1] % LAYER_TILE or partials.dim() != a.dim()
            or (batched and partials.shape[0] != a.shape[0])):
        raise ValueError(f"{name}: expected a and g of one shape ([M,] N, H), H a multiple of "
                         f"{LAYER_TILE}, and partials ([M,] S, P); got {tuple(a.shape)}, "
                         f"{tuple(g.shape)} and {tuple(partials.shape)}")
    hidden = a.shape[-1]
    if (partials.shape[-1] % 4 or offset % 2 or offset < 0
            or offset + hidden * hidden > partials.shape[-1]
            or partials.shape[-2] > -(-a.shape[-2] // LAYER_TILE)):
        raise ValueError(f"{name}: {hidden}^2 floats at offset {offset} do not fit a row of "
                         f"{partials.shape[-1]}, or more splits than 128-row tiles")
    for label, t in (("a", a), ("g", g), ("partials", partials)):
        _check_cuda(label, t, a.device)
    bf16, mixed = precision_modes(precision)
    lead = (lambda t: t) if batched else (lambda t: t.unsqueeze(0))
    with torch.cuda.device(a.device):
        _layer_dw_launch(_lib(), lead(a), lead(g), lead(partials), offset, bf16, mixed, name)


def layer_fwd_reference(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, omega: float,
                        precision: str = "fp32"):
    """Plain version of one hidden layer of the layer-wise forward
    (`sine_mlp_layer_fwd`): a = a_{l-1} (N, H) as the chain keeps it, W (H,
    H), b (H,) -> (z, a_l): z = a W + b, a_l = rnd(sin(omega z)), W rounded
    in the bf16 mode as the chain rounds it."""
    bf16, mixed = precision_modes(precision)
    z = a.float() @ _rnd(w.float(), bf16) + b.float()
    return z, _rnd(fast_sin(omega * z), bf16 or mixed)


def sine_mlp_layer_fwd(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, omega: float,
                       precision: str, stash: bool = False):
    """Launch the layer-wise forward for one hidden layer (kind kLwHidden):
    a = a_{l-1} (N, H) fp32 on the card as the chain keeps it (bf16 values
    in the bf16 mode and under "+mixed"), w = W (H, H) or its planes as
    `_layer_planes` makes them (a caller timing launches makes them once),
    b (H,), H a multiple of LAYER_TILE -> a_l (N, H), and with `stash` (z_l,
    a_l), `layer_fwd_reference` in the kernel's summation order. Counted as
    "sine_mlp_layer_fwd". Shapes or a CPU tensor it does not take raise
    ValueError before the library is built."""
    bf16, mixed = precision_modes(precision)
    n, hidden = a.shape if a.dim() == 2 else (0, 0)
    if (a.dim() != 2 or hidden % LAYER_TILE or hidden < LAYER_TILE
            or tuple(b.shape) != (hidden,)):
        raise ValueError(f"sine_mlp_layer_fwd: expected a (N, H), H a multiple of "
                         f"{LAYER_TILE}, and b (H,); got {tuple(a.shape)}, {tuple(b.shape)}")
    if w.dim() == 2:  # W itself: its planes, made here
        if tuple(w.shape) != (hidden, hidden):
            raise ValueError(f"sine_mlp_layer_fwd: W {tuple(w.shape)} for a of {tuple(a.shape)}")
        w = _layer_planes(_rnd(w.float(), mixed)[None], bf16, mixed)[0]
    planes = 1 if bf16 or mixed else 3
    if w.numel() != planes * hidden * hidden // 2:
        raise ValueError(f"sine_mlp_layer_fwd: {w.numel()} words of W's planes, expected "
                         f"{planes * hidden * hidden // 2} ({planes} planes of {hidden}^2)")
    b = b.float().contiguous()
    for label, t in (("a", a), ("planes", w), ("b", b)):
        _check_cuda(label, t, a.device)
    dev = a.device
    out = torch.empty_like(a)
    z = torch.empty_like(a) if stash else None
    slices = layer_slices(n, hidden, torch.cuda.get_device_properties(dev).multi_processor_count)
    args = _layer_args(n=n, in_size=1, hidden=hidden, out_size=1, slices=slices, members=1,
                       omega=omega, src=a[None], w=w[None], b=b[None], dst=out[None],
                       z=None if z is None else z[None])
    with torch.cuda.device(dev):
        _layer_launch(_lib(), "sine_mlp_layer_fwd", args, _HIDDEN, bf16, mixed,
                      "sine_mlp_layer_fwd", dev)
    return (z, out) if stash else out


def layer_bwd_reference(g: torch.Tensor, w: torch.Tensor, z: torch.Tensor, omega: float,
                        precision: str = "fp32", x: Optional[torch.Tensor] = None):
    """Plain version of one hidden layer of the layer-wise backward
    (`sine_mlp_layer_bwd`, kind hidden), in the chain's rounding: G_l = g (N,
    H) as the chain keeps it, W_l = w (H, H), z = z_{l-1} (N, H) the
    pre-activation below, omega that layer's -> (G_{l-1}, A_{l-1}, db,
    dW_0): ga = G_l W_l^T, gz = rnd<mixed>(ga) omega cos(omega z), G_{l-1} =
    rnd<bf16>(gz), A_{l-1} = rnd(sin(omega z)) (the next dW's A), db =
    sum_rows gz (H,), and with x (N, in) (the layer below is the first)
    dW_0 = rnd(x)^T G_{l-1} (in, H), else None. W rounded in the bf16 mode
    as the chain rounds it."""
    bf16, mixed = precision_modes(precision)
    ga = g.float() @ _rnd(w.float(), bf16).t()
    gz = _rnd(ga, mixed) * (omega * fast_cos(omega * z.float()))
    gzb = _rnd(gz, bf16)
    a = _rnd(fast_sin(omega * z.float()), bf16 or mixed)
    dw0 = None if x is None else _rnd(x.float(), bf16 or mixed).t() @ gzb
    return gzb, a, gz.sum(0), dw0


def sine_mlp_layer_bwd(g: torch.Tensor, w: torch.Tensor, z: torch.Tensor, omega: float,
                       precision: str, x: Optional[torch.Tensor] = None,
                       inplace: bool = False):
    """Launch the layer-wise backward for one hidden layer (kind hidden): g
    = G_l (N, H) fp32 on the card as the chain keeps it, w = W_l (H, H) or
    its transpose's planes as `_layer_planes(W^T)` makes them (a caller
    timing launches makes them once), z = z_{l-1} (N, H), H a multiple of
    LAYER_TILE, and with x (N, in) the dW_0 sums of the first layer ->
    (G_{l-1}, A_{l-1}, db, dW_0): `layer_bwd_reference` in the kernel's
    summation order, except that db (S, H) and dW_0 (S, in, H) (None
    without x) are the sums of each of the S = `layer_slices` row slices
    (`layer_slice_rows`), which add up to the reference's. A_{l-1} is
    written over a copy of z, or with `inplace` over z itself (as K2 does;
    z is returned as A_{l-1}). Counted as "sine_mlp_layer_bwd". Shapes or a
    CPU tensor it does not take raise ValueError before the library is
    built."""
    bf16, mixed = precision_modes(precision)
    n, hidden = g.shape if g.dim() == 2 else (0, 0)
    if (g.dim() != 2 or hidden % LAYER_TILE or hidden < LAYER_TILE
            or tuple(z.shape) != tuple(g.shape)):
        raise ValueError(f"sine_mlp_layer_bwd: expected g and z (N, H), H a multiple of "
                         f"{LAYER_TILE}; got {tuple(g.shape)}, {tuple(z.shape)}")
    if x is not None and (x.dim() != 2 or x.shape[0] != n or not 1 <= x.shape[1] <= 8):
        raise ValueError(f"sine_mlp_layer_bwd: expected x (N, in), in <= 8, got "
                         f"{tuple(x.shape)} for g of {tuple(g.shape)}")
    if w.dim() == 2:  # W itself: its transpose's planes, made here
        if tuple(w.shape) != (hidden, hidden):
            raise ValueError(f"sine_mlp_layer_bwd: W {tuple(w.shape)} for g of {tuple(g.shape)}")
        w = _layer_planes(_rnd(w.float(), mixed).t()[None], bf16, mixed)[0]
    planes = 1 if bf16 or mixed else 3
    if w.numel() != planes * hidden * hidden // 2:
        raise ValueError(f"sine_mlp_layer_bwd: {w.numel()} words of W^T's planes, expected "
                         f"{planes * hidden * hidden // 2} ({planes} planes of {hidden}^2)")
    for label, t in (("g", g), ("planes", w), ("z", z)):
        _check_cuda(label, t, g.device)
    dev = g.device
    if x is not None:
        x = _rnd(x.float(), mixed).contiguous()
        _check_cuda("x", x, dev, aligned=False)  # read a value at a time
    in_size = 1 if x is None else x.shape[1]
    slices = layer_slices(n, hidden, torch.cuda.get_device_properties(dev).multi_processor_count)
    # a partial slice: db, then dW_0's rows
    n_part = -(-(hidden + (0 if x is None else in_size * hidden)) // 4) * 4
    part = torch.zeros((slices, n_part), dtype=torch.float32, device=dev)
    out = torch.empty_like(g)
    a = z if inplace else z.clone()
    args = _layer_args(n=n, in_size=in_size, hidden=hidden, out_size=1, slices=slices,
                       members=1, omega=omega, n_part=n_part,
                       offsets=dict(off_db=0, off_dw0=hidden), g=g[None], w=w[None], z=a[None],
                       dst=out[None], x=None if x is None else x[None], part=part[None])
    with torch.cuda.device(dev):
        _layer_launch(_lib(), "sine_mlp_layer_bwd", args, _HIDDEN, bf16, mixed,
                      "sine_mlp_layer_bwd", dev)
    dw0 = None if x is None else part[:, hidden: hidden + in_size * hidden].view(
        slices, in_size, hidden)
    return out, a, part[:, :hidden], dw0


# The first and last layers' kinds alone (csrc/sine_mlp.cu, "the first and
# last layers: streaming passes"): plain versions in the chain's rounding,
# and a launch of each on the card. Each wrapper takes one SIREN's
# operands, or with a leading member axis M models' (one launch over the
# members, counted under the kernel's "_batched" key); it rounds x, W and b
# to bf16 under "+mixed" as the chain's wrappers do. Shapes, or a CPU
# tensor, that a kernel does not take raise ValueError before the library
# is built. The tests and chip_smoke.py call them; the chain launches the
# same kinds itself.


def layer_fwd_first_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, omega: float,
                              precision: str = "fp32"):
    """Plain version of the layer-wise forward's first layer (kind first):
    x (N, in), W_0 (in, H), b_0 (H,) as the chain takes them -> (z_0, a_0):
    z_0 = rnd(x) W_0 + b_0, a_0 = rnd(sin(omega z_0)); x rounded in the bf16
    mode and under "+mixed", W in the bf16 mode, as the chain rounds them."""
    bf16, mixed = precision_modes(precision)
    z = _rnd(x.float(), bf16 or mixed) @ _rnd(w.float(), bf16) + b.float()
    return z, _rnd(fast_sin(omega * z), bf16 or mixed)


def layer_fwd_last_reference(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             precision: str = "fp32") -> torch.Tensor:
    """Plain version of the layer-wise forward's last layer (kind last): a_L
    (N, H) as the chain keeps it, W_{D-1} (H, out), b_{D-1} (out,) -> out =
    a_L W_{D-1} + b_{D-1}, W rounded in the bf16 mode."""
    return a.float() @ _rnd(w.float(), precision_modes(precision)[0]) + b.float()


def layer_bwd_last_reference(g: torch.Tensor, w: torch.Tensor, z: torch.Tensor, omega: float,
                             precision: str = "fp32", x: Optional[torch.Tensor] = None):
    """Plain version of the layer-wise backward's last layer (kind last), in
    the chain's rounding: g (N, out) the output's cotangent, W_{D-1} (H,
    out), z = z_L (N, H) the last hidden pre-activation, omega its layer's
    -> (G_L, db_L, dW_{D-1}, db_{D-1}, dW_0): ga = rnd(g) W_{D-1}^T, gz =
    rnd<mixed>(ga) omega cos(omega z), G_L = rnd<bf16>(gz), db_L = sum_rows
    gz (H,), dW_{D-1} = a_L^T rnd(g) (H, out) with a_L = rnd(sin(omega z)),
    db_{D-1} = sum_rows g (out,), and with x (N, in) (depth 2: the layer
    below is the first) dW_0 = rnd(x)^T G_L (in, H), else None."""
    bf16, mixed = precision_modes(precision)
    g = g.float()
    gb = _rnd(g, bf16)
    gz = _rnd(gb @ _rnd(w.float(), bf16).t(), mixed) * (omega * fast_cos(omega * z.float()))
    gzb = _rnd(gz, bf16)
    a = _rnd(fast_sin(omega * z.float()), bf16 or mixed)
    dw0 = None if x is None else _rnd(x.float(), bf16 or mixed).t() @ gzb
    return gzb, gz.sum(0), a.t() @ gb, g.sum(0), dw0


def layer_bwd_first_reference(g: torch.Tensor, w: torch.Tensor,
                              precision: str = "fp32") -> torch.Tensor:
    """Plain version of the layer-wise backward's first layer (kind first):
    G_0 (N, H) as the chain keeps it, W_0 (in, H) -> dx = G_0 W_0^T (N,
    in), W rounded in the bf16 mode."""
    return g.float() @ _rnd(w.float(), precision_modes(precision)[0]).t()


def _kind_members(name: str, w: torch.Tensor, *tensors) -> tuple:
    """(batched, M, lead, unlead) of a kind wrapper's call: batched when W
    carries a member axis, every other operand then (M, ...) too (x may be
    shared: (N, in)); lead gives an operand its leading member axis, unlead
    takes it off a result where the call had none."""
    batched = w.dim() == 3
    m = w.shape[0] if batched else 1
    for t in tensors:
        if t is not None and batched and t.shape[0] != m:
            raise ValueError(f"{name}: operands of {m} members expected, got {tuple(t.shape)}")
    lead = (lambda t: t) if batched else (lambda t: None if t is None else t[None])
    unlead = (lambda t: t) if batched else (lambda t: None if t is None else t[0])
    return batched, m, lead, unlead


def _kind_launch(fn: str, kind: int, precision: str, batched: bool, dev, **kw) -> None:
    bf16, mixed = precision_modes(precision)
    name = fn + ("_batched" if batched else "")
    args = _layer_args(**kw)
    with torch.cuda.device(dev):
        _layer_launch(_lib(), fn, args, kind, bf16, mixed, name, dev)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def sine_mlp_layer_fwd_first(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, omega: float,
                             precision: str, stash: bool = False):
    """Launch the layer-wise forward's first layer alone (kind first): x
    ([M,] N, in) fp32 on the card (or (N, in) shared by the members), W_0
    ([M,] in, H), b_0 ([M,] H), in <= 8, H a multiple of LAYER_TILE -> a_0
    ([M,] N, H), with `stash` (z_0, a_0): `layer_fwd_first_reference`, its
    product an FMA a k in order from zero."""
    bf16, mixed = precision_modes(precision)
    what = "sine_mlp_layer_fwd_first"
    if (w.dim() not in (2, 3) or not 1 <= w.shape[-2] <= 8 or w.shape[-1] % LAYER_TILE
            or w.shape[-1] < LAYER_TILE or tuple(b.shape) != (*w.shape[:-2], w.shape[-1])
            or x.dim() not in (2, 3) or x.shape[-1] != w.shape[-2]
            or (x.dim() == 3 and w.dim() != 3)):
        raise ValueError(f"{what}: expected x ([M,] N, in), W_0 ([M,] in, H), in <= 8 and H a "
                         f"multiple of {LAYER_TILE}, b_0 ([M,] H); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    batched, m, lead, unlead = _kind_members(what, w, b, x if x.dim() == 3 else None)
    in_size, hidden = w.shape[-2:]
    n = x.shape[-2]
    x, w, b = (_rnd(t.float(), mixed).contiguous() for t in (x, w, b))
    dev = w.device
    _check_cuda("x", x, dev, aligned=False)  # read a value at a time
    _check_cuda("W_0", w, dev)
    _check_cuda("b_0", b, dev)
    a = torch.empty((m, n, hidden), dtype=torch.float32, device=dev)
    z = torch.empty_like(a) if stash else None
    _kind_launch("sine_mlp_layer_fwd", _FIRST, precision, batched, dev, n=n, in_size=in_size,
                 hidden=hidden, out_size=1, slices=layer_slices(n, hidden, _sms(dev)),
                 members=m, omega=omega, src=x if x.dim() == 3 else x[None], w=lead(w),
                 b=lead(b), dst=a, z=z)
    return (unlead(z), unlead(a)) if stash else unlead(a)


def sine_mlp_layer_fwd_last(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            precision: str) -> torch.Tensor:
    """Launch the layer-wise forward's last layer alone (kind last): a_L
    ([M,] N, H) fp32 on the card as the chain keeps it, W_{D-1} ([M,] H,
    out), b_{D-1} ([M,] out), out <= 8, H a multiple of LAYER_TILE -> out
    ([M,] N, out): `layer_fwd_last_reference`, each output summed over H in
    the kernel's order."""
    mixed = precision_modes(precision)[1]
    what = "sine_mlp_layer_fwd_last"
    if (w.dim() not in (2, 3) or a.dim() != w.dim() or a.shape[-1] != w.shape[-2]
            or w.shape[-2] % LAYER_TILE or w.shape[-2] < LAYER_TILE
            or not 1 <= w.shape[-1] <= 8 or tuple(b.shape) != (*w.shape[:-2], w.shape[-1])):
        raise ValueError(f"{what}: expected a_L ([M,] N, H), W_{{D-1}} ([M,] H, out), H a "
                         f"multiple of {LAYER_TILE} and out <= 8, b ([M,] out); got "
                         f"{tuple(a.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    batched, m, lead, unlead = _kind_members(what, w, a, b)
    hidden, out_size = w.shape[-2:]
    n = a.shape[-2]
    w, b = (_rnd(t.float(), mixed).contiguous() for t in (w, b))
    dev = w.device
    _check_cuda("a_L", a, dev)
    _check_cuda("W_{D-1}", w, dev, aligned=False)
    _check_cuda("b_{D-1}", b, dev, aligned=False)
    out = torch.empty((m, n, out_size), dtype=torch.float32, device=dev)
    _kind_launch("sine_mlp_layer_fwd", _LAST, precision, batched, dev, n=n, in_size=1,
                 hidden=hidden, out_size=out_size, slices=layer_slices(n, hidden, _sms(dev)),
                 members=m, src=lead(a), w=lead(w), b=lead(b), dst=out)
    return unlead(out)


def sine_mlp_layer_bwd_last(g: torch.Tensor, w: torch.Tensor, z: torch.Tensor, omega: float,
                            precision: str, x: Optional[torch.Tensor] = None):
    """Launch the layer-wise backward's last layer alone (kind last): g
    ([M,] N, out) fp32 on the card, W_{D-1} ([M,] H, out), z = z_L ([M,] N,
    H), and with x ([M,] N, in), or (N, in) shared, dW_0's sums (depth 2)
    -> (G_L, db_L, dW_{D-1}, db_{D-1}, dW_0): `layer_bwd_last_reference`
    (G_L its bits), except that db_L (S, H), dW_{D-1} (S, H, out), db_{D-1}
    (S, out) and dW_0 (S, in, H) (None without x) are the sums of each of
    the S = `layer_slices` row slices (`layer_slice_rows`), which add up to
    the reference's; each with a leading member axis over M members."""
    mixed = precision_modes(precision)[1]
    what = "sine_mlp_layer_bwd_last"
    if (w.dim() not in (2, 3) or g.dim() != w.dim() or z.dim() != w.dim()
            or w.shape[-2] % LAYER_TILE or w.shape[-2] < LAYER_TILE
            or not 1 <= w.shape[-1] <= 8 or g.shape[-1] != w.shape[-1]
            or tuple(z.shape) != (*g.shape[:-1], w.shape[-2])):
        raise ValueError(f"{what}: expected g ([M,] N, out), W_{{D-1}} ([M,] H, out), H a "
                         f"multiple of {LAYER_TILE} and out <= 8, z ([M,] N, H); got "
                         f"{tuple(g.shape)}, {tuple(w.shape)}, {tuple(z.shape)}")
    n = g.shape[-2]
    if x is not None and (x.dim() not in (2, 3) or x.shape[-2] != n
                          or not 1 <= x.shape[-1] <= 8 or (x.dim() == 3 and w.dim() != 3)):
        raise ValueError(f"{what}: expected x ([M,] N, in), in <= 8, got {tuple(x.shape)} "
                         f"for g of {tuple(g.shape)}")
    batched, m, lead, unlead = _kind_members(what, w, g, z,
                                             x if x is not None and x.dim() == 3 else None)
    hidden, out_size = w.shape[-2:]
    in_size = 1 if x is None else x.shape[-1]
    w = _rnd(w.float(), mixed).contiguous()
    dev = w.device
    _check_cuda("g", g, dev, aligned=False)  # read a value at a time
    _check_cuda("W_{D-1}", w, dev, aligned=False)
    _check_cuda("z", z, dev)
    if x is not None:
        x = _rnd(x.float(), mixed).contiguous()
        _check_cuda("x", x, dev, aligned=False)
    slices = layer_slices(n, hidden, _sms(dev))
    # a partial slice: db_L, dW_{D-1}, db_{D-1}, then dW_0's rows
    sizes = (hidden, hidden * out_size, out_size, 0 if x is None else in_size * hidden)
    starts = [sum(sizes[:i]) for i in range(4)]
    part = torch.zeros((m, slices, -(-sum(sizes) // 4) * 4), dtype=torch.float32, device=dev)
    out = torch.empty((m, n, hidden), dtype=torch.float32, device=dev)
    _kind_launch("sine_mlp_layer_bwd", _LAST, precision, batched, dev, n=n, in_size=in_size,
                 hidden=hidden, out_size=out_size, slices=slices, members=m, omega=omega,
                 n_part=part.shape[-1],
                 offsets=dict(off_db=starts[0], off_dwl=starts[1], off_dbl=starts[2],
                              off_dw0=starts[3]),
                 src=lead(g), w=lead(w), z=lead(z), dst=out, part=part,
                 x=None if x is None else (x if x.dim() == 3 else x[None]))
    pieces = (part[..., : starts[1]], part[..., starts[1]: starts[2]].unflatten(-1, (hidden, out_size)),
              part[..., starts[2]: starts[3]],
              None if x is None else part[..., starts[3]: starts[3] + sizes[3]].unflatten(
                  -1, (in_size, hidden)))
    return (unlead(out), *(unlead(t) for t in pieces))


def sine_mlp_layer_bwd_first(g: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """Launch the layer-wise backward's first layer alone (kind first): G_0
    ([M,] N, H) fp32 on the card as the chain keeps it, W_0 ([M,] in, H),
    in <= 8, H a multiple of LAYER_TILE -> dx ([M,] N, in):
    `layer_bwd_first_reference`, each input summed over H in the kernel's
    order."""
    mixed = precision_modes(precision)[1]
    what = "sine_mlp_layer_bwd_first"
    if (w.dim() not in (2, 3) or g.dim() != w.dim() or g.shape[-1] != w.shape[-1]
            or w.shape[-1] % LAYER_TILE or w.shape[-1] < LAYER_TILE
            or not 1 <= w.shape[-2] <= 8):
        raise ValueError(f"{what}: expected G_0 ([M,] N, H), W_0 ([M,] in, H), H a multiple of "
                         f"{LAYER_TILE} and in <= 8; got {tuple(g.shape)}, {tuple(w.shape)}")
    batched, m, lead, unlead = _kind_members(what, w, g)
    in_size, hidden = w.shape[-2:]
    n = g.shape[-2]
    w = _rnd(w.float(), mixed).contiguous()
    dev = w.device
    _check_cuda("G_0", g, dev)
    _check_cuda("W_0", w, dev, aligned=False)
    dx = torch.empty((m, n, in_size), dtype=torch.float32, device=dev)
    _kind_launch("sine_mlp_layer_bwd", _FIRST, precision, batched, dev, n=n, in_size=in_size,
                 hidden=hidden, out_size=1, slices=layer_slices(n, hidden, _sms(dev)),
                 members=m, g=lead(g), w=lead(w), dst=dx)
    return unlead(dx)


def sine_mlp_layer_partials(params, x: torch.Tensor, g: torch.Tensor, cfg, precision: str):
    """The layer-wise backward (a SIREN wider than 192) up to its partial
    buffer, on the card: (dx (N, in), partials (S, n_part)), as
    `siren_chain_layer_partials` lays them out; `sum_partials` of the
    partials is the backward's gradients. The tests and chip_smoke.py call
    it; the launches count as the backward's."""
    if kernel_width(params[0]["w"].shape[1]) <= KERNEL_WIDTHS[-1]:
        raise ValueError("sine_mlp_layer_partials: the layer-wise kernels run widths above "
                         f"{KERNEL_WIDTHS[-1]} only")
    dx, partials, _ = _layer_bwd([params], x, g, cfg, precision, batched=False)
    return dx, partials


def sum_partials_row_groups(n_blocks: int, groups: int):
    """The kernel's row split: min(groups, n_blocks) contiguous (start, stop)
    ranges, group g holding rows [g B / G, (g + 1) B / G)."""
    g = min(groups, n_blocks)
    return [(i * n_blocks // g, (i + 1) * n_blocks // g) for i in range(g)]


def sum_partials_reference(partials: torch.Tensor, groups: int = SUM_PARTIALS_GROUPS):
    """Plain-torch mirror of the partial-sum kernel's order: per row group,
    0 plus its rows in index order (fp32 adds of whole rows), then the group
    sums in group order. With the kernel's `groups` it equals the kernel bit
    for bit; `partials.sum(0)` computes the same function in another order."""
    sums = []
    for r0, r1 in sum_partials_row_groups(partials.shape[0], groups):
        s = torch.zeros_like(partials[0])
        for r in range(r0, r1):
            s = s + partials[r]
        sums.append(s)
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def sum_partials(partials: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """Launch the partial-sum kernel: (blocks, P) fp32 on the card -> (P,).
    `precision`, the mode of the backward that wrote the partials, only
    says where `LAUNCHES_BY_MODE` counts the launch: the sum is fp32.

    P must be a multiple of 4 and the tensor contiguous and 16-byte aligned
    (float4 loads); anything else, a CPU tensor included, raises ValueError
    before the library is built. The rows are split into
    min(SUM_PARTIALS_GROUPS, blocks) contiguous groups; each group is summed
    from 0 in row order and the group sums are added in group order, which
    `sum_partials_reference` mirrors bit for bit. No atomics: a call repeats
    bit for bit."""
    return _sum_launch(partials, precision, batched=False)


def sum_partials_batched(partials: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """The partial sum over a leading member axis in one launch (grid y =
    member): (M, blocks, P) fp32 on the card -> (M, P), row m the bits of
    `sum_partials(partials[m])`. Raises as sum_partials does."""
    return _sum_launch(partials, precision, batched=True)


def _sum_launch(partials: torch.Tensor, precision: str, batched: bool) -> torch.Tensor:
    """Check and launch sum_partials, over a leading member axis of partials
    when `batched`."""
    name = "sum_partials_batched" if batched else "sum_partials"
    if (partials.dim() != (3 if batched else 2) or partials.shape[-2] < 1
            or partials.shape[-1] % 4):
        raise ValueError(
            f"{name}: expected ({'M, ' if batched else ''}blocks >= 1, P) with P a multiple "
            f"of 4, got {tuple(partials.shape)}")
    bf16, mixed = precision_modes(precision)
    dev = partials.device
    _check_cuda("partials", partials, dev)
    lib = _lib()
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _sum_launch(partials, precision, batched)
    # The kernel takes ~0.02 ms on the card, about what this call costs the
    # host, so the path stays lean: no device context switch, the raw stream
    # handle (tools/sum_partials_ab.py times each part).
    n_blocks, n_part = partials.shape[-2:]
    out = torch.empty(partials.shape[:-2] + (n_part,), dtype=torch.float32, device=dev)
    members = (partials.shape[0],) if batched else ()
    err = getattr(lib, name)(partials.data_ptr(), out.data_ptr(), *members, n_blocks, n_part,
                             torch._C._cuda_getCurrentRawStream(dev.index))
    _raise_on(err, name)
    _count(name, bf16, mixed)
    return out


# ------------------------------------------------------------ autograd glue


def _unflatten(flat: Sequence[torch.Tensor]):
    return tuple({"w": flat[2 * i], "b": flat[2 * i + 1]} for i in range(len(flat) // 2))


def _layer_wise(params) -> bool:
    """Whether a SIREN of these params (leaves with or without a member
    axis) runs on the layer-wise kernels (kernel width above 192)."""
    return kernel_width(params[0]["w"].shape[-1]) > KERNEL_WIDTHS[-1]


def _wants_stash(*tensors: torch.Tensor) -> bool:
    """Whether a backward may follow a forward on these inputs: grad mode
    is on and one of them requires grad. Decided outside the Functions,
    where `ctx.needs_input_grad` cannot tell (inside forward grad mode is
    always off): a render, eval or decode under no_grad keeps no stash."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class SineMLPFunction(torch.autograd.Function):
    """out = chain(x; W, b). Forward: kernel K1 on a CUDA tensor, the plain
    chain on a CPU tensor. Backward: kernel K2 (above width 192 the
    layer-wise kernels) + sum_partials, or the plain backward. Returns
    cotangents for x and every W and b.

    `stash` (`_wants_stash`, the caller's): above width 192 the forward
    keeps the pre-activations z of every layer but the last (K1 writes
    them beside the activations, the plain chain keeps its own) and the
    backward takes them in place of its recompute, with the same bits. The
    backward uses the stash up (K2 writes A_{l-1} over z_{l-1}) and drops
    it; a second backward through the graph (retain_graph=True) recomputes
    it, as K2 does without a stash. At 192 and below nothing is kept."""

    @staticmethod
    def forward(ctx, x, cfg, precision, stash, *flat):
        params = _unflatten(flat)
        stash = stash and _layer_wise(params)
        ctx.planes = ctx.z = None
        if x.is_cuda:  # W's planes (widths 128 and 192), packed once for K1 and K2
            bf16, mixed = precision_modes(precision)
            out, ctx.planes, ctx.z = _fwd_launch([params], x, cfg, bf16, mixed, "sine_mlp_fwd",
                                                 keep=True, stash=stash)
            out = out[0]
        else:
            out, ctx.z = _chain_forward(params, x, cfg, precision, keep=stash)
        ctx.save_for_backward(x, *flat)
        ctx.cfg, ctx.precision = cfg, precision
        return out

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        params = _unflatten(flat)
        z, ctx.z = ctx.z, None  # used up by this backward
        if x.is_cuda:
            dx, grads = _bwd_launch([params], x, g, ctx.cfg, ctx.precision, batched=False,
                                    planes=ctx.planes, z=z)
        else:
            dx, grads = siren_chain_backward_reference(params, x, g, ctx.cfg, ctx.precision,
                                                       zs=z)
        out = [dx if ctx.needs_input_grad[0] else None, None, None, None]
        for layer in grads:
            out += [layer["w"], layer["b"]]
        return tuple(out)


def _members(flat: Sequence[torch.Tensor]):
    """Leaves with a leading member axis (w0, b0, w1, ...) -> one params tuple
    per member, copies in their own allocations, so the plain chain runs
    each member on tensors laid out as a single fit's (the kernels take the
    stacked leaves as they are)."""
    return [_unflatten([t[m].clone() for t in flat]) for m in range(flat[0].shape[0])]


class SineMLPBatchedFunction(torch.autograd.Function):
    """out (M, N, out) = the chains of M members of one shape on x (N, in),
    shared, or (M, N, in); every W and b a leaf with a leading member axis.
    Forward: `sine_mlp_fwd_batched` on a CUDA tensor, the plain chain member
    by member on a CPU tensor. Backward: `sine_mlp_bwd_batched`, or the plain
    backward member by member. Member m's outputs and cotangents have the
    bits of `SineMLPFunction` on member m alone, in every mode; `stash` as
    there (one stash holds every member's z, (M, D-1, N, H) on the card)."""

    @staticmethod
    def forward(ctx, x, cfg, precision, stash, *flat):
        members = _unflatten(flat)
        stash = stash and _layer_wise(members)
        ctx.planes = ctx.z = None
        if x.is_cuda:  # the stacked leaves and W's planes, packed in one pass each
            bf16, mixed = precision_modes(precision)
            _check_fwd_batched(members, x)
            out, ctx.planes, ctx.z = _fwd_launch(members, x, cfg, bf16, mixed,
                                                 "sine_mlp_fwd_batched", keep=True,
                                                 stash=stash)
        else:
            xs = [x] * flat[0].shape[0] if x.dim() == 2 else list(x)
            runs = [_chain_forward(p, xm, cfg, precision, keep=stash)
                    for p, xm in zip(_members(flat), xs)]
            out = torch.stack([o for o, _ in runs])
            ctx.z = [zs for _, zs in runs] if stash else None
        ctx.save_for_backward(x, *flat)
        ctx.cfg, ctx.precision = cfg, precision
        return out

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        z, ctx.z = ctx.z, None  # used up by this backward
        if x.is_cuda:
            members = _unflatten(flat)
            _check_bwd_batched(members, x, g)
            dx, grads = _bwd_launch(members, x, g, ctx.cfg, ctx.precision, batched=True,
                                    planes=ctx.planes, z=z)
        else:
            dx, grads = siren_chain_backward_reference_batched(_members(flat), x, g,
                                                               ctx.cfg, ctx.precision, zs=z)
        if not ctx.needs_input_grad[0]:
            dx = None
        elif x.dim() == 2:  # one x shared by every member
            dx = dx.sum(0)
        out = [dx, None, None, None]
        for layer in grads:
            out += [layer["w"], layer["b"]]
        return tuple(out)


def siren_apply_flat_fused(
    params, coords: torch.Tensor, cfg, precision: str = "fp32"
) -> torch.Tensor:
    """SIREN forward over flat coords (N, in) in [0, 1] -> (N, out), through
    the fused chain (kernels on CUDA, plain versions on CPU)."""
    x = (coords - 0.5) * 2.0
    flat = [t for layer in params for t in (layer["w"], layer["b"])]
    out = SineMLPFunction.apply(x, cfg, precision, _wants_stash(x, *flat), *flat)
    return out / 2.0 + 0.5


def siren_apply_flat_batched_fused(params, coords: torch.Tensor, cfg,
                                   precision: str = "fp32") -> torch.Tensor:
    """Forward of M SIRENs of one shape, `params` one tuple whose W and b
    carry a leading member axis, over flat coords (N, in) in [0, 1] -> (M, N,
    out), differentiable: through `SineMLPBatchedFunction` (one K1 and one K2
    launch over the member axis on the card, the plain versions on the CPU),
    with `siren_apply_flat_fused`'s input and output maps."""
    x = (coords - 0.5) * 2.0
    flat = [t for layer in params for t in (layer["w"], layer["b"])]
    out = SineMLPBatchedFunction.apply(x, cfg, precision, _wants_stash(x, *flat), *flat)
    return out / 2.0 + 0.5
