"""The precision modes of the products outside the SIREN kernels (CoordX,
hashgrid, SIREN under mlp.fast_sine=false), in plain torch.

A precision string is the kernels' (ops/sine_mlp.py): "fp32" or "bf16",
with or without the "+mixed" suffix.

  * "bf16" is what `train.matmul_precision=bfloat16` (or null) means to the
    JAX package on its TPU: one bf16 pass per product, operands rounded to
    bf16 and products accumulated in fp32, in the forward and in both
    transposes of the backward (`jax.default_matmul_precision` is baked
    into the primal dots, and their transposes inherit it). `matmul` here.
    "fp32" is a true fp32 product (TF32 off on the card).
  * "+mixed" is `train.mixed_precision` (compute_dtype=bfloat16): the
    models cast their inputs, weights and activations to bf16 explicitly,
    and under autodiff each cast rounds the cotangent that flows back
    through it. `maybe_cast` here: rounds on the way in and on the way back.
"""
from __future__ import annotations

import torch

from implicit_image_tpu_torch.ops.sine_mlp import precision_modes as modes

__all__ = ["modes", "maybe_cast", "matmul"]


def _rnd(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to fp32."""
    return t.to(torch.bfloat16).float()


class _CastBf16(torch.autograd.Function):
    """x.astype(bfloat16) as autodiff sees it: the value rounded, and the
    cotangent that flows back rounded too (it is a bf16 array there). Its
    vmap rule is generated (the member-axis forwards, models/__init__.py)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _rnd(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _rnd(g)


def maybe_cast(x: torch.Tensor, mixed: bool) -> torch.Tensor:
    """x cast to bf16 as JAX's astype under mixed precision, else x."""
    return _CastBf16.apply(x) if mixed else x


class _Bf16Matmul(torch.autograd.Function):
    """a @ b in one bf16 pass: the operands rounded to bf16, the products
    (exact in fp32) accumulated in fp32; the backward's two products take
    the same one pass (the cotangent rounded as their operand). Its vmap
    rule is generated."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return _rnd(a) @ _rnd(b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b = inputs
        ctx.save_for_backward(_rnd(a), _rnd(b))

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = _rnd(g)
        ga = gr @ br.t() if ctx.needs_input_grad[0] else None
        gb = ar.t() @ gr if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a (M, K) @ b (K, N): one bf16 pass when bf16, else fp32."""
    return _Bf16Matmul.apply(a, b) if bf16 else a @ b
