"""2-D (x, y) tile decomposition over a two-axis mesh — port of
``subzero_tpu/parallel/spatial2d.py`` on ``torch.distributed``.

The domain is cut into ``Sx x Sy`` tiles over a ``("sx", "sy")`` mesh; each
rank holds the floes whose centroid lies inside its tile.  Halo exchange
follows the reference's ghost construction order
(floe_interactions_all.m:18-66: x ghosts first, then y ghosts over the
extended list): a ring shift along "sx" exchanges x-edge floes, then a ring
shift along "sy" exchanges y-edge floes *including the just-received
x-ghosts*, which yields the diagonal corner ghosts with no extra
collective.  Migration is likewise two-phase (x then y), so a diagonal
crosser settles in its new tile within one step.

Tile ``(i, j)`` is rank ``i * Sy + j`` and owns global slot block
``i * Sy + j``.  An axis's ring peers are ranks of the one process group,
so no sub-groups are needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..dynamics.step import domain_polygon
from ..forcing import Forcing
from ..state import FloeState
from .distributed import Mesh
from .spatial import (
    GHOST_FIELDS, _cat, _direction_masks, _exchange, _local_physics,
    _migrate, _rebalance, _step_aux, make_spatial_step, rebalance_slabs,
    shard_state,
)

AX, AY = "sx", "sy"


def make_spatial_step_2d(cfg: SimConfig, forcing: Forcing, modulus: float,
                         heat_flux: float, mesh: Mesh):
    """``step(state, step_idx, domain=None, timer=None) -> (state, aux)``
    over a 2-D ("sx", "sy") mesh, run by every rank on its tile's slab
    (see ``spatial.make_spatial_step``)."""
    if mesh.axis_names != (AX, AY):
        raise ValueError(f"a tile step needs an ('sx', 'sy') mesh, got "
                         f"{mesh.axis_names}")
    sx, sy = mesh.shape
    cap_total = cfg.capacity.max_floes
    if cap_total % (sx * sy):
        raise ValueError(f"max_floes {cap_total} does not divide by "
                         f"{sx * sy} tiles")
    n_loc = cap_total // (sx * sy)
    n_ghost = max(min(cfg.capacity.max_ghosts, n_loc), 1)
    dev = mesh.device
    forcing = forcing.to(device=dev)
    domain_verts = domain_polygon(cfg, device=dev)
    lx, ly = cfg.domain.lx, cfg.domain.ly
    tile_w = 2.0 * lx / sx
    tile_h = 2.0 * ly / sy
    periodic = cfg.processes.periodic
    ix, iy = mesh.axis_index(AX), mesh.axis_index(AY)
    x_lo = -lx + ix * tile_w
    x_hi = x_lo + tile_w
    y_lo = -ly + iy * tile_h
    y_hi = y_lo + tile_h
    reducers = (mesh.psum,)

    def step(state: FloeState, step_idx: int, domain=None, timer=None):
        if state.device != dev or state.n != n_loc:
            raise ValueError(f"the step takes this rank's slab of {n_loc} "
                             f"slots on {dev}, got {state.n} on "
                             f"{state.device}")
        mark = timer or (lambda name: None)
        dom = domain_verts if domain is None else domain
        mark("exchange")
        halo = 2.0 * mesh.pmax(torch.max(torch.where(
            state.alive, state.rmax, torch.zeros_like(state.rmax))))

        # ---- 1a. x halo exchange --------------------------------------
        right = state.alive & (state.x > x_hi - halo)
        left = state.alive & (state.x < x_lo + halo)
        ghosts_x, x_of = _exchange(
            mesh, {f: getattr(state, f) for f in GHOST_FIELDS}, right, left,
            n_ghost, AX, "x", ix == 0, ix == sx - 1, 2.0 * lx, periodic)

        # ---- 1b. y halo exchange over local + x-ghosts ----------------
        # (x then y yields the corner ghosts, floe_interactions_all.m:18-66)
        union = {f: torch.cat([getattr(state, f), ghosts_x[f]])
                 for f in GHOST_FIELDS}
        up = union["alive"] & (union["y"] > y_hi - halo)
        dn = union["alive"] & (union["y"] < y_lo + halo)
        ghosts_y, y_of = _exchange(
            mesh, union, up, dn, n_ghost, AY, "y", iy == 0, iy == sy - 1,
            2.0 * ly, periodic)
        ghosts = _cat(ghosts_x, ghosts_y)

        # ---- 2.-3. contact, trajectory (both periodic axes are realized
        # by the ghost rings) --------------------------------------------
        up_loc = state.alive & (state.y > y_hi - halo)
        dn_loc = state.alive & (state.y < y_lo + halo)
        state, p = _local_physics(
            state, ghosts, right | left | up_loc | dn_loc, step_idx,
            forcing, dom, modulus, heat_flux, cfg, n_loc, reducers,
            False, lx, ly, mark)

        # ---- 4. two-phase migration (x then y) ------------------------
        mark("migration")
        go_r, go_l = _direction_masks(state, x_lo, x_hi, state.x, 2 * lx,
                                      periodic, ix == 0, ix == sx - 1)
        state, mig_of_x = _migrate(state, go_r, go_l, n_ghost, mesh, AX)
        go_u, go_d = _direction_masks(state, y_lo, y_hi, state.y, 2 * ly,
                                      periodic, iy == 0, iy == sy - 1)
        state, mig_of_y = _migrate(state, go_u, go_d, n_ghost, mesh, AY)
        aux, step.overflow = _step_aux(mesh, state, p,
                                       x_of | y_of | mig_of_x | mig_of_y)
        mark("end")
        return state, aux

    step.overflow = None
    return step


def mesh_step(cfg: SimConfig, forcing: Forcing, modulus: float,
              heat_flux: float, mesh: Mesh):
    """(step, rebalance) of ``mesh``: the tile step and ``rebalance_tiles``
    on an ("sx", "sy") mesh, the slab step and ``rebalance_slabs`` on a
    ("shards",) one."""
    if mesh.axis_names == (AX, AY):
        return (make_spatial_step_2d(cfg, forcing, modulus, heat_flux, mesh),
                lambda st: rebalance_tiles(st, cfg, *mesh.shape))
    return (make_spatial_step(cfg, forcing, modulus, heat_flux, mesh),
            lambda st: rebalance_slabs(st, cfg, mesh.size))


def shard_state_2d(state: FloeState, mesh: Mesh) -> FloeState:
    """This rank's tile slab: tile (i, j) is rank i*Sy + j and owns slot
    block i*Sy + j, so it is ``shard_state``'s slab."""
    return shard_state(state, mesh)


def _tile_owner(cfg: SimConfig, sx: int, sy: int, x, y):
    lx, ly = cfg.domain.lx, cfg.domain.ly
    ox = np.clip(((x + lx) // (2.0 * lx / sx)).astype(int), 0, sx - 1)
    oy = np.clip(((y + ly) // (2.0 * ly / sy)).astype(int), 0, sy - 1)
    return ox * sy + oy


def rebalance_tiles(state: FloeState, cfg: SimConfig, sx: int, sy: int
                    ) -> FloeState:
    """Host-side: reorder floes so each lives in the tile owning its
    centroid; tile (i, j) owns slot block ``i*sy + j``."""
    if state.n != cfg.capacity.max_floes:
        raise ValueError(f"state has {state.n} slots, cfg.capacity "
                         f"{cfg.capacity.max_floes}")
    return _rebalance(
        state, lambda a: _tile_owner(cfg, sx, sy, a["x"], a["y"]),
        sx * sy, "tile")


def load_imbalance(state: FloeState, cfg: SimConfig, sx: int, sy: int
                   ) -> float:
    """max/mean live-floe count over tiles (1.0 = perfectly balanced)."""
    alive = state.alive.cpu().numpy()
    owner = _tile_owner(cfg, sx, sy, state.x.cpu().numpy(),
                        state.y.cpu().numpy())
    counts = np.bincount(owner[alive], minlength=sx * sy)
    mean = counts.mean()
    return float(counts.max() / mean) if mean > 0 else 1.0
