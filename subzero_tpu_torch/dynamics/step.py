"""The physics step — port of ``subzero_tpu/dynamics/step.py``
(``floe_interactions_all.m``: broad phase -> narrow phase -> force/torque
reduction -> trajectory update -> periodic wrap).

``make_step_fn(cfg, forcing, modulus, heat_flux, device=None)`` returns
``step(state, step_idx) -> (state, aux)`` running eagerly on ``device``
(CUDA unless the caller names another).  ``step_idx`` is a Python int, so the
host decides the ocean-refresh cadence and the stress-ring reset.  Kill and
merge events are flagged in the aux output, not applied, as in the JAX step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from ..device import resolve_device
from ..forcing import Forcing
from ..geometry.polygon import pad_polygon
from ..state import FloeState, torch_dtype
from ..trace import span
from .broadphase import neighbor_candidates, neighbor_candidates_cells
from .contact import (
    BoundaryContact, PairContacts, boundary_contact, contact_forces,
)
from .trajectory import push_stress, stress_from_sums, trajectory_update


class StepAux(NamedTuple):
    """Per-step auxiliary outputs (diagnostics + lifecycle flags)."""

    n_collisions: torch.Tensor     # [] int32 collision count
    merge_i: torch.Tensor          # [N, K] floe i to be absorbed into nbr k
    merge_j: torch.Tensor          # [N, K] nbr k to be absorbed into floe i
    absorb_boundary: torch.Tensor  # [N] floe >75% outside domain
    killed: torch.Tensor           # [N] floes newly dead this step
    exported: torch.Tensor         # [N] killed floes whose mass LEFT the domain
    nbr_overflow: torch.Tensor     # [] broad-phase candidate overflow
    nbr_demand: torch.Tensor       # [] int32 max broad-phase candidates of a row
    overlap_area: torch.Tensor     # [N] total overlap area per floe
    collision_force: torch.Tensor  # [N, 2]
    collision_torque: torch.Tensor  # [N]
    nbr_idx: torch.Tensor          # [N, K] int32 neighbour slot per candidate
    pair_valid: torch.Tensor       # [N, K] contact force present
    pair_px: torch.Tensor          # [N, K] contact point
    pair_py: torch.Tensor          # [N, K]
    pair_fx: torch.Tensor          # [N, K] contact force on i from nbr
    pair_fy: torch.Tensor          # [N, K]
    pair_overlap: torch.Tensor     # [N, K] overlap area
    boundary_contact: torch.Tensor  # [N] floe touches the domain boundary
    region_overflow: torch.Tensor  # [] >=4-crossing contacts exceeded the
                                   # per-region pool (aggregate fallback)
    region_pool_need: torch.Tensor  # [] int32 >=4-crossing contact slots
    pair_pool_overflow: torch.Tensor  # [] bbox-active pairs exceeded the
                                      # active-pair pool (contacts zeroed)
    pair_pool_need: torch.Tensor   # [] int32 bbox-active pair slots


def domain_polygon(cfg: SimConfig, v_cap: int = 8, device=None) -> torch.Tensor:
    """Padded CCW rectangle |x|<=lx, |y|<=ly (initialize_boundaries.m)."""
    lx, ly = cfg.domain.lx, cfg.domain.ly
    rect = np.array([[-lx, -ly], [lx, -ly], [lx, ly], [-lx, ly]])
    padded, _ = pad_polygon(rect, v_cap)
    return torch.from_numpy(padded).to(device=resolve_device(device),
                                       dtype=torch_dtype(cfg.numerics.dtype))


def physics_step(
    state: FloeState,
    forcing: Forcing,
    step_idx: int,
    domain_verts: torch.Tensor,
    modulus: float,
    heat_flux: float,
    cfg: SimConfig,
    timer=None,
) -> tuple[FloeState, StepAux]:
    """One full physics step (floe_interactions_all.m + calc_trajectory.m).

    ``timer``: optional callable ``timer(name)`` called at the start of each
    phase ("broadphase", "contact", "wall", "trajectory") and with "end";
    the caller may record CUDA events there.  Each phase is also a host
    span of the same name (``trace.span``).
    """
    mark = timer or (lambda name: None)
    proc = cfg.processes
    periodic = proc.periodic
    dtype = state.x.dtype
    dev = state.x.device
    n = state.n
    idx_arange = torch.arange(n, device=dev)

    do_int = (int(step_idx) % proc.n_ocean_force) == 0

    with span("broadphase"):
        mark("broadphase")
        verts_world = state.verts_world()

        # ---- broad phase ----------------------------------------------------
        # The JAX step's rule: the cell list only on a grid of >= 3 cells a
        # side, the dense test otherwise.
        num = cfg.numerics
        use_cells = (
            num.broadphase == "cells" and num.cell_size > 0
            and int(2 * cfg.domain.lx / num.cell_size) >= 3
            and int(2 * cfg.domain.ly / num.cell_size) >= 3
        )
        if use_cells:
            nbr = neighbor_candidates_cells(
                state.x, state.y, state.rmax, state.alive,
                cfg.capacity.max_neighbors, periodic,
                cfg.domain.lx, cfg.domain.ly,
                num.cell_size, cfg.capacity.max_per_cell,
                n_skip_rows=cfg.n_boundary,
            )
        else:
            nbr = neighbor_candidates(
                state.x, state.y, state.rmax, state.alive,
                cfg.capacity.max_neighbors, periodic,
                cfg.domain.lx, cfg.domain.ly,
                n_skip_rows=cfg.n_boundary,
            )

    # ---- narrow phase: floe-floe ------------------------------------------
    with span("contact"):
        mark("contact")
        no = torch.zeros((), dtype=torch.bool, device=dev)
        none = torch.zeros((), dtype=torch.int32, device=dev)
        if proc.collision:
            pc = contact_forces(
                verts_world, state.x, state.y, state.u, state.v, state.ksi,
                state.h, state.area, nbr, modulus, cfg,
                nv=state.nv, domain_verts=domain_verts,
            )
        else:
            zk = torch.zeros(nbr.idx.shape, dtype=dtype, device=dev)
            zb = torch.zeros(nbr.idx.shape, dtype=torch.bool, device=dev)
            pc = PairContacts(fx=zk, fy=zk, px=zk, py=zk, tq=zk,
                              sxx=zk, syy=zk, sxy=zk, overlap=zk,
                              merge_i=zb, merge_j=zb,
                              region_overflow=no, region_need=none,
                              pair_pool_overflow=no, pair_pool_need=none)

    # ---- narrow phase: boundary -------------------------------------------
    with span("wall"):
        mark("wall")
        if not periodic:
            # Rectangular-wall force-component zeroing is applied inside; the
            # default wall_zero_tol=0.0 reproduces the reference's never-firing
            # == test (wall friction survives).
            bc = boundary_contact(
                verts_world, state.x, state.y, state.u, state.v, state.ksi,
                state.h, state.area, state.alive, domain_verts, modulus, cfg,
                nv=state.nv,
            )
        else:
            zn = torch.zeros((n,), dtype=dtype, device=dev)
            zb = torch.zeros((n,), dtype=torch.bool, device=dev)
            bc = BoundaryContact(
                fx=zn, fy=zn, px=zn, py=zn, tq=zn, sxx=zn, syy=zn, sxy=zn,
                overlap=zn, absorb=zb, out=zb,
                region_overflow=no, region_need=none,
            )

    # ---- reduce forces & torques -----------------------------------------
    with span("trajectory"):
        mark("trajectory")
        f_valid = (torch.abs(pc.fx) + torch.abs(pc.fy)) > 0
        b_valid = (torch.abs(bc.fx) + torch.abs(bc.fy)) > 0

        cf_x = torch.sum(pc.fx, dim=1) + bc.fx
        cf_y = torch.sum(pc.fy, dim=1) + bc.fy
        # torque about own centroid (floe_interactions_all.m:255-259)
        cf_t = torch.sum(pc.tq, dim=1) + bc.tq

        overlap_total = torch.sum(pc.overlap, dim=1) + bc.overlap

        # ---- stress ring buffer ---------------------------------------------
        s_new = stress_from_sums(
            state,
            torch.sum(pc.sxx, dim=1) + bc.sxx,
            torch.sum(pc.syy, dim=1) + bc.syy,
            torch.sum(pc.sxy, dim=1) + bc.sxy,
        )
        state = push_stress(state, s_new, step_idx)

        state = state.replace(overlap_area=overlap_total)

        # ---- kill flags -----------------------------------------------------
        alive_before = state.alive
        killed_boundary = bc.absorb | bc.out
        if proc.kill_below_ymin:
            # Nares export rule: a floe whose lowest vertex drops below the
            # southern wall dies (padded slots repeat vertex 0).
            y_min_wall = torch.amin(domain_verts[:, 1])
            below = state.alive & (
                torch.amin(verts_world[..., 1], dim=1) < y_min_wall)
            killed_boundary = killed_boundary | below
        exported = alive_before & killed_boundary  # mass leaves the domain
        if not proc.keep_min:
            # small-floe cull, device-side (Subzero.m:366-372)
            too_small = (state.area < cfg.min_floe_size) & (
                idx_arange >= cfg.n_boundary)
            killed_boundary = killed_boundary | too_small
        state = state.replace(alive=state.alive & ~killed_boundary)

        # ---- trajectory update ----------------------------------------------
        state = trajectory_update(
            state, forcing, cf_x, cf_y, cf_t, heat_flux, do_int, cfg)

        # ---- periodic wrap (floe_interactions_all.m:267-277) ----------------
        if periodic:
            lx, ly = cfg.domain.lx, cfg.domain.ly
            x = state.x
            y = state.y
            x = torch.where(torch.abs(x) > lx, x - 2 * lx * torch.sign(x), x)
            y = torch.where(torch.abs(y) > ly, y - 2 * ly * torch.sign(y), y)
            state = state.replace(x=x, y=y)

        # ---- diagnostics ----------------------------------------------------
        # calc_collisionNum.m: floe-floe contact pairs /2 + boundary
        # contacts; a floe-vs-topography contact appears once and counts at
        # full weight.
        i32 = torch.int32
        if cfg.n_boundary > 0:
            vs_topo = nbr.idx < cfg.n_boundary
            n_collisions = (
                torch.sum(f_valid & ~vs_topo) // 2
                + torch.sum(f_valid & vs_topo)
                + torch.sum(b_valid)
            ).to(i32)
        else:
            n_collisions = (torch.sum(f_valid) // 2
                            + torch.sum(b_valid)).to(i32)

        aux = StepAux(
            n_collisions=n_collisions,
            merge_i=pc.merge_i,
            merge_j=pc.merge_j,
            absorb_boundary=bc.absorb,
            killed=alive_before & ~state.alive,
            exported=exported,
            nbr_overflow=nbr.overflow,
            nbr_demand=nbr.demand,
            overlap_area=overlap_total,
            collision_force=torch.stack([cf_x, cf_y], dim=-1),
            collision_torque=cf_t,
            nbr_idx=nbr.idx,
            pair_valid=f_valid,
            pair_px=pc.px,
            pair_py=pc.py,
            pair_fx=pc.fx,
            pair_fy=pc.fy,
            pair_overlap=pc.overlap,
            boundary_contact=b_valid | (bc.overlap > 0),
            region_overflow=pc.region_overflow | bc.region_overflow,
            region_pool_need=pc.region_need + bc.region_need,
            pair_pool_overflow=pc.pair_pool_overflow,
            pair_pool_need=pc.pair_pool_need,
        )
        mark("end")
    return state, aux


def make_step_fn(cfg: SimConfig, forcing: Forcing, modulus: float,
                 heat_flux: float = 0.0, device=None):
    """Build ``step(state, step_idx: int) -> (state, aux)`` on ``device``.

    ``device=None`` means CUDA and raises if CUDA is absent; pass
    ``device="cpu"`` for the plain PyTorch path.  Every contact and
    broad-phase option of the JAX step runs, ``contact_impl="xla"``
    included.  The forcing grids and the domain polygon are moved to the
    device once.
    """
    dev = resolve_device(device)
    forcing = forcing.to(device=dev)
    domain_verts = domain_polygon(cfg, device=dev)

    def step(state: FloeState, step_idx: int, timer=None):
        if state.device != dev:
            raise ValueError(f"state is on {state.device}, the step on {dev}")
        return physics_step(state, forcing, int(step_idx), domain_verts,
                            modulus, heat_flux, cfg, timer=timer)

    return step
