"""The ("image", "pixel") mesh over a process group (counterpart of
implicit_image_tpu/parallel/mesh.py).

The JAX package is one controller over many devices; the port is one
process per device, joined in a torch.distributed process group
(parallel/multihost.init_multihost). The mesh lays those ranks out on two
axes, row-major as the JAX package reshapes its devices (rank = i · pixel
+ p):

  * "image": independent fits, the members of a batched fit, a ladder or a
    fleet split over the image ranks (parallel/batched.py);
  * "pixel": one image's rows split over the pixel ranks, the gradients
    summed across them in rank order (parallel/sharded.py).

Either axis may be 1. Each rank holds its two axis groups
(parallel/collectives.AxisGroup): `pixel`, the ranks that share its image
coordinate, and `image`, those that share its pixel coordinate; `world`
holds every rank.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from implicit_image_tpu_torch.parallel.collectives import AxisGroup

__all__ = ["Mesh", "make_mesh"]


@dataclass(frozen=True)
class Mesh:
    shape: dict  # {"image": image, "pixel": pixel}
    device: torch.device
    image: AxisGroup  # the ranks along "image" at this rank's pixel coordinate
    pixel: AxisGroup  # the ranks along "pixel" at this rank's image coordinate
    world: AxisGroup


def _axis_group(ranks, world: int, device) -> AxisGroup:
    """The axis group of `ranks`; every rank calls this for every group of an
    axis, in the same order, as torch.distributed.new_group requires."""
    pg = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
    return AxisGroup(pg, ranks, device) if dist.get_rank() in ranks else None


def make_mesh(image: int = 1, pixel: int = 1, device="cuda") -> Mesh:
    """Build an ("image", "pixel") mesh over the initialized process group,
    this rank's tensors on `device` (default "cuda": the card this process
    was given, torch.cuda.current_device()).

    The mesh covers every rank: image · pixel above the world size raises
    ValueError, as in the JAX package, and so does a product below it (the
    JAX package builds a small mesh over a prefix of its devices; here a
    rank outside the mesh would have no part in its collectives, so a
    smaller mesh takes a smaller process group). Every rank of the group
    must call make_mesh with the same arguments. Each of this rank's groups
    runs one collective here, so that its communicators (NCCL creates them at
    a group's first collective) exist before any timed work. Raises
    RuntimeError when no process group is initialized, or for "cuda" without
    a CUDA device."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.init_multihost)")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device} but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    need = int(image) * int(pixel)
    if need > world:
        raise ValueError(f"mesh {image}x{pixel} needs {need} ranks, have {world}")
    if need < world:
        raise ValueError(f"mesh {image}x{pixel} covers {need} of {world} ranks; the port's "
                         "mesh takes every rank of its process group")
    mine = {}
    for i in range(image):  # the pixel groups, one per image coordinate
        g = _axis_group([i * pixel + p for p in range(pixel)], world, device)
        if g is not None:
            mine["pixel"] = g
    for p in range(pixel):  # the image groups, one per pixel coordinate
        g = _axis_group([i * pixel + p for i in range(image)], world, device)
        if g is not None:
            mine["image"] = g
    mesh = Mesh(shape={"image": int(image), "pixel": int(pixel)}, device=device,
                image=mine["image"], pixel=mine["pixel"],
                world=AxisGroup(dist.group.WORLD, list(range(world)), device))
    for group in (mesh.pixel, mesh.image, mesh.world):
        group.all_gather(torch.zeros(1, device=device))
    return mesh
