"""The collectives of the multi-device layer: one axis of a mesh as seen by
this rank (`AxisGroup`), with the ordered cross-rank sum the sharded fit
reduces its pixels through.

`torch.distributed.all_reduce` adds in an order of its backend's choosing,
so beyond two ranks its result may differ from rank to rank and from a
single process's sum. `AxisGroup.chunk_sum` instead gathers every rank's
terms and adds them left to right in rank order: every rank gets the same
bits, and they are the bits of the single fit's own chunk sum
(training.fit.make_grad_fn: chunk gradients added left to right) when rank
r holds chunks r·k .. r·k + k - 1 of k·size.

Gloo takes CPU tensors in every collective; a group on gloo whose tensors
lie on the card (two processes sharing one GPU, which NCCL refuses)
stages them through host memory here, and only here: the computation stays
on the card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AxisGroup", "gather_members"]


class AxisGroup:
    """The ranks along one mesh axis that share this rank's other
    coordinate: `ranks` (global ranks, in axis order), this rank's place
    `rank` among them, and `size`. `pg` is their process group; `device`
    the device the callers' tensors lie on."""

    def __init__(self, pg, ranks: Sequence[int], device):
        self.pg = pg
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.device = torch.device(device)
        # what the collectives move: host memory on gloo, else the device
        self.transport = torch.device("cpu") if dist.get_backend(pg) == "gloo" else self.device

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (same shape and dtype on every rank), in axis
        order, on t's device."""
        if t.dtype == torch.bool:
            return [x.bool() for x in self.all_gather(t.to(torch.uint8))]
        src = t.detach().to(self.transport).contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.pg)
        return [x.to(t.device) for x in out]

    def chunk_sum(self, parts: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """`parts`: this rank's k chunks, each a list of tensors (the same
        shapes and one dtype in every chunk and on every rank). Returns the
        left-to-right sum over all k·size chunks in axis order (rank 0's
        chunks first), identical on every rank."""
        shapes = [p.shape for p in parts[0]]
        local = torch.stack([torch.cat([p.reshape(-1) for p in part]) for part in parts])
        terms = [row for block in self.all_gather(local) for row in block.unbind(0)]
        acc = terms[0]
        for term in terms[1:]:
            acc = acc + term
        out, i = [], 0
        for shape in shapes:
            n = int(np.prod(shape))
            out.append(acc[i:i + n].reshape(shape))
            i += n
        return out

    def sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """chunk_sum of one chunk per rank."""
        return self.chunk_sum([tensors])

    def cat(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `t` concatenated along `dim` in axis order."""
        return torch.cat(self.all_gather(t), dim=dim)

    def cat_shares(self, t: torch.Tensor, counts: Sequence[int], dim: int = 0) -> torch.Tensor:
        """cat of shares that may differ in size along `dim`: counts[r] on
        the rank at place r (t's other dimensions the same everywhere). Each
        is padded to the largest for the all-gather and cut back after."""
        top = max(counts)
        pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, top - t.shape[dim]]
        parts = self.all_gather(torch.nn.functional.pad(t, pad))
        return torch.cat([p.narrow(dim, 0, c) for p, c in zip(parts, counts)], dim=dim)

    def broadcast_object(self, obj, src: int = 0):
        """`obj` (a small picklable host object) of the rank at place `src`,
        on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[src], group=self.pg,
                                   device=self.transport)
        return box[0]

    def all_gather_object(self, obj) -> list:
        """Every rank's `obj` (a picklable host object), in axis order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out


def gather_members(tree, group: AxisGroup):
    """A tree of per-member results (tensors and numpy arrays whose leading
    axis is this rank's members; tuples, named tuples, lists, dicts and
    dataclasses of them) gathered over `group` and concatenated in axis
    order. Leaves without a member axis (0-d tensors, Python scalars, None)
    must agree across the ranks and stay as they are."""
    if isinstance(tree, torch.Tensor):
        return group.cat(tree) if tree.dim() else tree
    if isinstance(tree, np.ndarray):
        if tree.ndim == 0:
            return tree
        return group.cat(torch.from_numpy(np.ascontiguousarray(tree))).numpy()
    if isinstance(tree, dict):
        return {k: gather_members(v, group) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_members(v, group) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_members(v, group) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: gather_members(getattr(tree, f.name), group)
                                            for f in dataclasses.fields(tree)})
    return tree
