"""The device mesh: one process driving a list of torch devices.

Port of colmap_pcd_tpu/parallel/mesh.py. The JAX package is single-
controller: one Python process holds a `jax.sharding.Mesh` of its local
devices and runs sharded programs over them (its `initialize_multihost` is
never called in the repository). The counterpart here is one process that
drives a tuple of `torch.device`s along one axis, which data-parallels
independent work items: image pairs in matching, reference
views in stereo, point blocks in BA. It is not one process per GPU.

A mesh may repeat a device: `make_mesh(8, devices=["cpu"] * 8)` is the
counterpart of the JAX tests' `--xla_force_host_platform_device_count=8`
CPU devices, and `make_mesh(2, devices=["cuda:0"] * 2)` runs the sharded
paths on a machine with one card. The collectives below do the same thing
whether the devices are distinct or repeated.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import device as device_mod

Tensor = torch.Tensor


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of devices; shard s of a batch lives on devices[s]."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        """Where reductions land and replicated solves run."""
        return self.devices[0]

    def reduce_sum(self, parts: list[Tensor]) -> Tensor:
        """The shards' tensors (one each, of one shape) summed in shard
        order on the root device: one code path, deterministic, the same
        for distinct and repeated devices."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for a mesh of {self.size}")
        total = parts[0].to(self.root)
        for p in parts[1:]:
            total = total + p.to(self.root)
        return total

    def broadcast(self, x: Tensor) -> list[Tensor]:
        """x copied to every shard's device (no copy where it already is)."""
        return [x.to(d) for d in self.devices]

    def gather(self, parts: list[Tensor]) -> Tensor:
        """The shards' blocks concatenated along dim 0 on the root device."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for a mesh of {self.size}")
        return torch.cat([p.to(self.root) for p in parts])


def blocks(n: int, shards: int) -> list[slice]:
    """Contiguous blocks of a batch of n over `shards` shards, as a
    PartitionSpec over the batch axis lays them out."""
    if n % shards:
        raise ValueError(f"batch {n} not divisible by mesh size {shards}")
    b = n // shards
    return [slice(s * b, (s + 1) * b) for s in range(shards)]


def shard_devices(mesh: Mesh | None, device=None) -> tuple[torch.device, ...]:
    """The devices a batch's shards run on: the mesh's, or without a mesh
    the one device `device` resolves to (None: CUDA)."""
    if mesh is None:
        return (device_mod.resolve(device),)
    return mesh.devices


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of `n_devices` devices.

    Without `devices`: the visible CUDA devices (all of them, or the first
    n_devices); it raises without CUDA, as `device.resolve(None)` does, and
    when fewer cards are visible than asked for: a mesh never shrinks
    silently. With `devices` (names or torch.devices, repeats allowed): the
    first n_devices of them, each resolved by `device.resolve`."""
    if devices is None:
        device_mod.resolve(None)
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [device_mod.resolve(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} asked for, {len(devs)} devices available; "
                             "pass devices=[...] to repeat one device")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs))


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None):
    """Multi-process bring-up: a no-op for one process. A mesh spans the
    devices of one process only, so more processes raise until a mesh over
    process groups exists."""
    if num_processes is not None and num_processes > 1:
        raise NotImplementedError("a mesh spans one process; multi-process meshes are not supported")
