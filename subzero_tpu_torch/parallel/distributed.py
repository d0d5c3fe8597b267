"""Multi-process runtime setup and the device mesh — port of
``subzero_tpu/parallel/distributed.py`` on ``torch.distributed``.

The JAX package runs one program over every global device (``shard_map``
over a ``jax.sharding.Mesh``).  Here the program is SPMD: one process per
device, every process runs the same code on its own slab, and the mesh's
collectives are ``torch.distributed`` calls over the process group:

    JAX                     port
    ``axis_index``          ``Mesh.coords`` (this rank's mesh coordinate)
    ``pmax`` / ``psum``     ``Mesh.pmax`` / ``Mesh.psum`` (all_reduce)
    ``ppermute`` (ring)     ``Mesh.shift`` (all_to_all_single)

NCCL serves CUDA tensors and gloo CPU tensors.  A tensor on a device the
group's backend does not serve raises; nothing moves to the CPU on its own.

Usage (the same script in every process, launched for example by
``torchrun --nproc-per-node=S``):

    from subzero_tpu_torch.parallel.distributed import (
        initialize, spatial_mesh)
    initialize()                      # no-op in one plain process
    mesh = spatial_mesh()             # 1-D "shards" mesh over all ranks
    sim = Simulation(..., mesh=mesh)
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "initialize", "spatial_mesh", "local_slab_bounds"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(init_method: str | None = None,
               world_size: int | None = None,
               rank: int | None = None,
               device=None) -> bool:
    """Initialize the default process group when running distributed.

    Returns True when a group was initialized.  The arguments fall back to
    the launcher's environment (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE``, as ``torchrun`` sets them); a single process with
    neither is a no-op, as in the JAX package.  The backend follows the
    device: NCCL for CUDA (the default), gloo for the CPU.  With CUDA each
    process takes the card ``LOCAL_RANK`` (default 0).
    """
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and world_size is None:
        return False  # single-process run
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    dev = _process_device(device)
    dist.init_process_group(
        _BACKENDS[dev.type], init_method=init_method or "env://",
        world_size=world_size, rank=rank)
    return True


def _process_device(device=None) -> torch.device:
    """This process's device: the CUDA card ``LOCAL_RANK`` unless the caller
    names another device."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


class Mesh:
    """The port's counterpart of ``jax.sharding.Mesh``: a device grid of
    ``shape`` named by ``axis_names`` (``("shards",)`` or ``("sx", "sy")``)
    over the ranks of ``group``, one rank per grid point in row-major
    order (tile ``(i, j)`` of an ``(sx, sy)`` grid is rank ``i * sy + j``),
    and this rank's device.

    ``device=None`` is CUDA card ``LOCAL_RANK``; the device must be the
    kind the group's backend serves (NCCL: CUDA, gloo: CPU).
    """

    def __init__(self, shape, axis_names, device=None, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "initialize() first")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axis "
                             f"names {self.axis_names}")
        self.group = group
        self.size = dist.get_world_size(group)
        if int(np.prod(self.shape)) != self.size:
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{int(np.prod(self.shape))} ranks, the group "
                             f"has {self.size}")
        self.rank = dist.get_rank(group)
        self.coords = tuple(int(c) for c in
                            np.unravel_index(self.rank, self.shape))
        self.device = _process_device(device)
        backend = dist.get_backend(group)
        if backend != _BACKENDS[self.device.type]:
            raise ValueError(f"a {backend} group does not serve "
                             f"{self.device.type} tensors")

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"rank={self.rank}, device={self.device})")

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def _check(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != self.device.type:
            raise ValueError(f"a tensor on {t.device} cannot join a "
                             f"collective of the {self.device.type} mesh")
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over every rank of the mesh (``psum`` over all its axes)."""
        out = self._check(t).clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Maximum over every rank of the mesh."""
        out = self._check(t).clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def peer(self, axis: str, offset: int) -> int:
        """The rank ``offset`` steps along ``axis`` from this one, on the
        periodic ring of that axis."""
        a = self.axis_names.index(axis)
        c = list(self.coords)
        c[a] = (c[a] + offset) % self.shape[a]
        return int(np.ravel_multi_index(c, self.shape))

    def shift(self, buf: torch.Tensor, axis: str, offset: int
              ) -> torch.Tensor:
        """``ppermute`` along the ring of ``axis``: ``buf`` goes to the rank
        ``offset`` steps ahead; returns what the rank ``offset`` steps
        behind sent.  Built on ``all_to_all_single`` with split sizes for
        the one peer, so it also runs when the peer is this rank (gloo
        cannot send to itself); each direction is its own collective."""
        self._check(buf)
        flat = buf.contiguous().reshape(-1)
        ins = [0] * self.size
        outs = [0] * self.size
        ins[self.peer(axis, offset)] = flat.numel()
        outs[self.peer(axis, -offset)] = flat.numel()
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat, outs, ins, group=self.group)
        return out.reshape(buf.shape)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, in rank order."""
        t = self._check(t).contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=0)


def spatial_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """1-D ``("shards",)`` mesh over every rank (each holds one stripe;
    ``n_shards``, when given, must equal the world size)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh((size if n_shards is None else int(n_shards),),
                ("shards",), device=device)


def local_slab_bounds(mesh: Mesh, cfg) -> list[tuple[float, float]]:
    """[(x_lo, x_hi)] of the stripes owned by THIS process — for host-side
    IO that should touch only local floes."""
    w = 2.0 * cfg.domain.lx / mesh.size
    i = mesh.rank
    return [(-cfg.domain.lx + i * w, -cfg.domain.lx + (i + 1) * w)]
