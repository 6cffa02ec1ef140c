"""Device mesh and sharding helpers (port of ``rwm_pt_tpu.parallel.mesh``).

The port is single-process and single-controller, like JAX's mesh: a
:class:`Mesh` is a grid of ``torch.device`` objects, one per shard, named
by axis.  ``chains`` is the data-parallel axis (every replica is
independent) and ``temps`` the temperature axis of a PT ladder split
across shards.  A mesh may repeat a device: on one card,
``make_mesh(devices=[torch.device("cuda:0")] * k)`` gives k virtual
shards, and on a host with several cards ``make_mesh()`` puts one shard
on each.  The sharded fused runs (``kernels/fused_sharded.py``) run one
launch a shard on its device; their boundary rows move between shards
with ``Tensor.to``, so no NCCL is needed.  Meshes across processes
(``--multihost`` with ``WORLD_SIZE`` > 1) are not ported.
"""
from __future__ import annotations

import itertools
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


def initialize_distributed(**kwargs) -> None:
    """Multi-host bring-up.  A lone host (a torch launcher's ``WORLD_SIZE``
    of 1 or unset) prints JAX's single-host line and continues, so CLIs can
    pass ``--multihost`` unconditionally (``scripts/launch_pt_pod.sh``);
    ``WORLD_SIZE`` > 1 raises: meshes across processes are not ported."""
    world = int(os.environ.get("WORLD_SIZE", "1") or "1")
    if world > 1 or kwargs:
        raise NotImplementedError(
            f"a mesh across processes (WORLD_SIZE={world}) is not ported to "
            f"the PyTorch package yet (ROADMAP Queue A item 13's remainder: "
            f"multi-process meshes over NCCL)")
    print("[parallel] single-host run (distributed init skipped: "
          f"WORLD_SIZE={world})")


class Mesh:
    """``devices``: an object array of ``torch.device`` shaped like the
    axis sizes; ``axis_names`` names its axes; ``shape`` maps each name to
    its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.devices.flat]})"


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("chains",),
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA card; with none
    it raises, never falling back to the CPU).  ``devices`` may repeat a
    device, which makes virtual shards (the tests pass
    ``[torch.device("cpu")] * 8``).  Default: a 1-D ``("chains",)`` mesh;
    ``axis_sizes=(n_chain_shards, n_temp_shards)`` with
    ``axis_names=("chains", "temps")`` gives the 2-D PT layout."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() covers the visible CUDA cards and "
                "torch.cuda.is_available() is False; pass devices= (e.g. "
                "[torch.device('cpu')] * 8) for a mesh of virtual shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    flat = [torch.device(d) for d in np.asarray(devices, dtype=object).flat]
    grid = np.empty(len(flat), dtype=object)
    grid[:] = flat
    if axis_sizes is None:
        axis_sizes = (grid.size,)
    if int(np.prod(axis_sizes)) != grid.size:
        raise ValueError(f"mesh {tuple(axis_sizes)} does not cover "
                         f"{grid.size} devices")
    return Mesh(grid.reshape(tuple(axis_sizes)), axis_names)


class NamedSharding(NamedTuple):
    """Where a tensor lies on a mesh: ``spec`` holds, for each tensor axis,
    the mesh axis it is split over or None (replicated), as JAX's
    ``PartitionSpec`` entries."""
    mesh: Mesh
    spec: tuple


def chain_sharding(mesh: Mesh, ndim: int, chain_axis: int = -1
                   ) -> NamedSharding:
    """The chain axis (minor-most by convention) on the ``chains`` mesh
    axis, everything else replicated."""
    spec = [None] * ndim
    spec[chain_axis] = "chains"
    return NamedSharding(mesh, tuple(spec))


def pt_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """PT state laid out ``(..., T, C)``: temps on the ``temps`` mesh axis
    (if present), chains on ``chains``."""
    spec = [None] * ndim
    spec[-1] = "chains"
    if "temps" in mesh.axis_names and ndim >= 2:
        spec[-2] = "temps"
    return NamedSharding(mesh, tuple(spec))


class ShardedTensor(NamedTuple):
    """A global tensor of ``shape`` split by ``sharding``: ``pieces``, an
    object array shaped like the mesh, holds each mesh device's piece on
    that device (a replicated axis repeats it)."""
    pieces: np.ndarray
    sharding: NamedSharding
    shape: tuple

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first)."""
        mesh, spec = self.sharding.mesh, self.sharding.spec
        device = device if device is not None else mesh.devices.flat[0]
        # one piece of every split, in mesh order along each split axis
        index = tuple(slice(None) if a in spec else 0
                      for a in mesh.axis_names)
        names = [a for a in mesh.axis_names if a in spec]

        def cat(arr, names):
            if not names:
                return arr.item().to(device) if isinstance(arr, np.ndarray) \
                    else arr.to(device)
            return torch.cat([cat(arr[i], names[1:])
                              for i in range(arr.shape[0])],
                             dim=spec.index(names[0]))
        return cat(self.pieces[index], names)


def _shard(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` split by ``sharding``: each mesh device gets its piece, in
    order along every split axis; a split must divide its tensor axis."""
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} does not fit a {x.ndim}-d tensor")
    for dim, a in enumerate(spec):
        if a is not None and x.shape[dim] % mesh.shape[a]:
            raise ValueError(f"axis {dim} of size {x.shape[dim]} is not "
                             f"divisible by mesh axis {a!r} of size "
                             f"{mesh.shape[a]}")
    pieces = np.empty(mesh.devices.shape, dtype=object)
    for pos in itertools.product(*map(range, mesh.devices.shape)):
        where = dict(zip(mesh.axis_names, pos))
        piece = x
        for dim, a in enumerate(spec):
            if a is not None:
                n = x.shape[dim] // mesh.shape[a]
                piece = piece.narrow(dim, where[a] * n, n)
        pieces[pos] = piece.contiguous().to(mesh.devices[pos])
    return ShardedTensor(pieces, sharding, tuple(x.shape))


def shard_init_states(x, mesh: Mesh, pt: bool = False) -> ShardedTensor:
    """Place initial states on the mesh: ``(d, C)`` for RWM, ``(d, T, C)``
    for PT.  The sharded runs on this mesh take the result as
    ``init_states`` piece by piece, where each piece lies; other consumers
    (the eager engines, a run on another mesh) gather it."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    sh = pt_sharding(mesh, x.ndim) if pt else chain_sharding(mesh, x.ndim)
    return _shard(x, sh)


def pooled_mean(per_chain) -> torch.Tensor:
    """Global mean of a per-chain diagnostic, gathered first if sharded."""
    if isinstance(per_chain, ShardedTensor):
        per_chain = per_chain.gather()
    return torch.mean(per_chain)
