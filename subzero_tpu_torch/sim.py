"""Simulation driver — port of ``subzero_tpu/sim.py`` (the functional
replacement of the ``Subzero.m`` script loop).

The reference interleaves physics steps with process passes gated on
``mod(i_step, K)`` (Subzero.m:151-378).  Here a chunk is an eager loop of
physics steps on the state's device (the JAX package's ``lax.scan``); every
per-step duty of the reference rides in the loop (the kill-mass ledger, the
per-step export slots, the optional dissolved-ice advection, the AVERAGE
accumulation), and the chunk ends with ONE summary tensor fetched with one
device->host copy.  Host-side work (lifecycle topology surgery, output,
checkpoints) happens only at chunk boundaries.

A step's only host sync is the one ``physics_step`` already has (the
thin-floe test of the trajectory update); the chunk adds one per chunk for
the AVERAGE window and one for the summary.  Nothing here writes into a
tensor it was given, so an overflowed chunk re-runs from its untouched
input state.

With a ``mesh`` (``parallel.distributed.Mesh``) the driver is SPMD: every
rank runs the same ``Simulation``.  ``self.state`` is the global state on
every rank; a chunk runs the slab or tile step on this rank's slab, sums
the per-step ledger over the mesh and gathers the slabs at its end.  The
lifecycle, rebalancing and capacity growth then run on identical global
states on every rank, and rank 0 alone writes outputs and checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .config import SimConfig
from .diagnostics import (
    EulerianData, cell_window, dissolved_mass_grid, eulerian_data, total_mass,
)
from .dynamics.step import StepAux, domain_polygon, physics_step
from .forcing import Forcing, gyre_ocean
from .state import FloeState
from .trace import Table, recording, span, sync

__all__ = ["Simulation", "out_of_box_sim", "chunk_merge_pairs"]


class ChunkAux:
    """The StepAux of every step of one chunk.  Field ``f`` reads as the
    ``[c, ...]`` stack over the chunk's steps (built on first access, like
    the JAX scan's stacked aux); ``last`` is the last step's StepAux."""

    def __init__(self, steps: list):
        self._steps = steps
        self._stacked = {}
        self.last = steps[-1]

    def __getattr__(self, name):
        if name.startswith("_") or name not in StepAux._fields:
            raise AttributeError(name)
        if name not in self._stacked:
            self._stacked[name] = torch.stack(
                [getattr(a, name) for a in self._steps])
        return self._stacked[name]


@dataclasses.dataclass
class Simulation:
    """Owns the state + step function and runs the time loop."""

    cfg: SimConfig
    state: FloeState
    forcing: Forcing
    modulus: float
    heat_flux: float = 0.0
    nx_coarse: int = 10
    ny_coarse: int = 10
    step_idx: int = 0
    dissolved: np.ndarray | None = None
    seed: int = 0
    pack_target: float = 1.0
    # Automatic output cadence (Subzero.m:220-298): when set, every
    # cfg.processes.n_dt_out steps the driver writes a full-state snapshot +
    # Eulerian fields under this directory and appends to the total-mass
    # series.  With cfg.processes.average the Eulerian fields are the time
    # mean since the previous output, accumulated EVERY STEP inside the
    # chunk — exactly the reference's accumulation at Subzero.m:304-314.
    output_dir: "str | Path | None" = None
    # also write a figure (plot_basic) at each output
    plot_output: bool = False
    # moving walls (uniaxial case): step_idx -> (lx, ly) of the domain box.
    # wall_cadence = the stride (in steps) at which wall_fn changes value;
    # it bounds the chunk size so wall moves land on chunk boundaries
    # (README.md Validation 1j: 15 m every 30 steps).
    wall_fn: "Callable[[int], tuple[float, float]] | None" = None
    wall_cadence: int = 30
    # multi-device: a parallel.distributed.Mesh switches the inner loop to
    # the spatial-decomposition step — axis ("shards",) = 1-D x-slabs
    # (parallel/spatial.py), axes ("sx", "sy") = 2-D tiles
    # (parallel/spatial2d.py).  Rebalance at lifecycle changes.
    mesh: "object | None" = None

    def __post_init__(self):
        if self.mesh is not None:
            from .parallel.distributed import Mesh

            if not isinstance(self.mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.distributed.Mesh, "
                                f"not {type(self.mesh).__name__}")
            if self.state.device != self.mesh.device:
                # the mesh's backend serves only its device: a state
                # elsewhere is the caller's to move, never moved here
                raise ValueError(f"the state is on {self.state.device}, the "
                                 f"mesh on {self.mesh.device}")
        if self.dissolved is None:
            self.dissolved = np.zeros((self.ny_coarse, self.nx_coarse))
        # invariant: the config's vertex rung always equals the state
        # arrays' actual vertex axis (empty_state / make_floe_arrays /
        # _grow_floes all build from cfg.capacity.verts_now)
        if self.cfg.capacity.verts_now != self.state.v_cap:
            self.cfg = self.cfg.replace(capacity=dataclasses.replace(
                self.cfg.capacity, active_verts=int(self.state.v_cap)))
        dev = self.state.device
        self._domain = domain_polygon(self.cfg, device=dev)
        # Re-init after a post-hoc ``sim.cfg = sim.cfg.replace(...)``: keep
        # the lifecycle's run state (RNG stream, exported-mass ledger).
        old_lc = getattr(self, "lifecycle", None)
        # lifecycle orchestrator (host-side topology surgery)
        from .forcing import thermo_params
        from .processes.lifecycle import Lifecycle

        _, pack_h0 = thermo_params(
            self.cfg.numerics.dt, self.cfg.processes.n_pack,
            k=self.cfg.physics.k_thermal, t_air=self.cfg.physics.t_air,
            t_ocean=self.cfg.physics.t_ocean,
            rho_ice=self.cfg.physics.rho_ice,
            latent=self.cfg.physics.latent_heat,
        )
        areas = self.state.area[self.state.alive].cpu().numpy()
        amax = float(areas.max()) if len(areas) else None
        self.lifecycle = Lifecycle(
            self.cfg, domain_polygon(self.cfg, device="cpu").to(
                torch.float64).numpy()[:4],
            seed=self.seed + 1, amax=amax,
            pack_h0=pack_h0 if self.heat_flux < 0 else 0.0,
            pack_target=self.pack_target,
            nx=self.nx_coarse, ny=self.ny_coarse,
        )
        if old_lc is not None:
            self.lifecycle.rng = old_lc.rng
            # birth vertex need of the current boundary (the rung-shrink
            # floor) must survive a mid-boundary re-init (floe-pool growth
            # recreates the Lifecycle before _maybe_shrink_pools runs)
            self.lifecycle.last_birth_nv = getattr(
                old_lc, "last_birth_nv", 0)
            # keep accumulated pass timings across mid-run rebuilds (the
            # same table: a rebuild inside Lifecycle.step records on)
            self.lifecycle.pass_times = old_lc.pass_times
            self.lifecycle.exported_mass = old_lc.exported_mass
            self.lifecycle.shadow_ledger = old_lc.shadow_ledger
            self.lifecycle.ledger_drift = old_lc.ledger_drift
            self.lifecycle.ledger_drift_max = old_lc.ledger_drift_max
            if old_lc.amax is not None and (
                    self.lifecycle.amax is None
                    or old_lc.amax > self.lifecycle.amax):
                # the weld pyramid cap only ever grows (Subzero.m:321-323)
                self.lifecycle.amax = old_lc.amax
        self.lifecycle.grow_fn = self._grow_floes
        # growth only under verts_auto: a pinned active_verts with
        # verts_auto=False is an explicit static rung (births truncate
        # there, like a static max_verts=rung build)
        self.lifecycle.grow_verts_fn = (
            self._grow_verts if self.cfg.capacity.verts_auto else None)
        # A mid-run re-init (pool growth, floe-capacity growth) resets both
        # _domain and the fresh lifecycle's domain_poly to the static cfg
        # box; forget the wall cache and rebuild the moved domain now so
        # the next chunk (including the re-run of an overflowed chunk)
        # doesn't silently run against unmoved walls until the next
        # wall_cadence change.
        self._wall_now = None
        if getattr(self, "wall_fn", None) is not None:
            self._update_walls()
        # the forcing grids live on the state's device
        self.forcing = self.forcing.to(device=dev)
        if self.mesh is not None:
            self._build_spatial()
        # chunk = gcd of the ACTIVE host-pass cadences (plus the output and
        # moving-wall cadences) so every boundary that needs host work lands
        # on a chunk boundary
        self._chunk = self._pick_chunk()
        self._chunk_frozen = False
        self._built_cfg = self.cfg

    def _build_spatial(self) -> None:
        """The slab or tile step by the mesh's axis names, the matching
        rebalance, and the state rebalanced for it."""
        from .parallel.spatial2d import mesh_step

        self._spatial_step, self._reshard = mesh_step(
            self.cfg, self.forcing, self.modulus, self.heat_flux, self.mesh)
        self.state = self._reshard(self.state)

    def _pick_chunk(self) -> int:
        """gcd of the active host-pass cadences (+ output + moving walls),
        capped at 30 — every boundary that may need host work lands on a
        chunk boundary, and inactive processes don't shrink the chunk."""
        proc = self.cfg.processes
        cads = [proc.n_simplify, proc.n_dt_out]
        if proc.ridging or proc.rafting:
            cads.append(proc.n_ocean_force)
        if proc.fractures:
            cads.append(proc.n_fracture)
        if proc.corners:
            cads.append(proc.n_corners)
        if proc.packing:
            cads.append(proc.n_pack)
        if proc.welding:
            cads += [proc.n_weld, proc.n_weld_mid, proc.n_weld_coarse]
        if self.wall_fn is not None:
            cads.append(self.wall_cadence)
        g = 0
        for c in cads:
            if c and c > 0:
                g = math.gcd(g, c)
        g = g or 5
        if g <= 30:
            return max(1, g)
        # cap at 30 while preserving the invariant that every cadence
        # boundary (all multiples of g) lands on a chunk boundary: use the
        # largest divisor of g that is <= 30, not min(g, 30) (e.g. g=40
        # with chunk 30 would fire host passes only every 120 steps)
        return max(d for d in range(1, 31) if g % d == 0)

    def _zero_eul(self) -> EulerianData:
        dt = self.state.x.dtype
        dev = self.state.device
        ny, nx = self.ny_coarse, self.nx_coarse
        z = torch.zeros((ny, nx), dtype=dt, device=dev)
        z3 = torch.zeros((ny, nx, 3), dtype=dt, device=dev)
        return EulerianData(u=z, v=z, du=z, dv=z, h=z, c=z, mtot=z, area=z,
                            over=z, stress=z3, strain=z3, stress_max_eig=z)

    def _run_chunk(self, state: FloeState, start: int, n: int,
                   dissolved: torch.Tensor, vd_tend, eul_acc,
                   domain_verts: torch.Tensor):
        """Run ``n`` physics steps from ``start``.

        Everything that the reference driver does EVERY step rides in the
        loop: dissolved/exported kill-mass ledgers, the dissolved-ice
        advection-diffusion (Advect_Dissolved_Ice.m), and the AVERAGE
        Eulerian accumulation (Subzero.m:304-314 — exact every-step
        accumulation).  The returned ``summary`` is ONE small tensor, so the
        host pays a single device->host copy per chunk.  The inputs are
        never written.
        """
        cfg = self.cfg
        mesh = self.mesh
        nx, ny = self.nx_coarse, self.ny_coarse
        sdt = dissolved.dtype
        # a floe's rmax changes only at lifecycle boundaries: size the
        # AVERAGE cell window once for the whole chunk
        window = (cell_window(state, cfg, nx, ny)
                  if cfg.processes.average else None)
        if mesh is not None:
            from .parallel import gather_state, shard_state

            state = shard_state(state, mesh)
        auxes, exported = [], []
        for i in range(n):
            if mesh is None:
                st2, aux = physics_step(
                    state, self.forcing, start + i, domain_verts,
                    self.modulus, self.heat_flux, cfg,
                )
            else:
                st2, aux = self._spatial_step(state, start + i,
                                              domain_verts)
            # Kill-mass ledger: exported kills (out-of-domain / absorb /
            # below-ymin) leave the domain; the rest dissolve onto the
            # coarse grid (calc_dissolved_mass.m).
            grid = dissolved_mass_grid(
                state, aux.killed & ~aux.exported, cfg, nx, ny)
            # per-step export recorded into a slot (not a running f32 sum):
            # the host accumulates the slots in float64
            exp_i = torch.sum(torch.where(
                aux.exported, state.mass, torch.zeros_like(state.mass)))
            if mesh is not None:
                # this rank's kills: one sum over the mesh for both
                both = mesh.psum(torch.cat([grid.reshape(-1).to(sdt),
                                            exp_i[None].to(sdt)]))
                grid, exp_i = both[:-1].reshape(grid.shape), both[-1]
            dissolved = dissolved + grid
            exported.append(exp_i)
            if cfg.processes.advect_dissolved:
                from .dissolved import advect_dissolved

                dis2, tend2 = advect_dissolved(
                    dissolved, vd_tend, self.forcing, cfg, cfg.numerics.dt,
                    nx, ny)
                dissolved = dis2.to(sdt)
                vd_tend = tend2.to(vd_tend.dtype)
            if cfg.processes.average:
                eul = eulerian_data(
                    st2 if mesh is None else gather_state(st2, mesh),
                    cfg, nx, ny, window=window, exact_boundary=False)
                eul_acc = EulerianData(*(a + b.to(a.dtype)
                                         for a, b in zip(eul_acc, eul)))
            state = st2
            auxes.append(aux)

        if mesh is not None:
            state = gather_state(state, mesh)
        chunk = ChunkAux(auxes)
        last = chunk.last
        exp = torch.zeros((self._chunk,), dtype=sdt, device=dissolved.device)
        exp[:n] = torch.stack(exported).to(sdt)
        i32 = torch.int32
        summary = torch.stack([t.to(sdt) for t in (
            chunk.merge_i.any(),
            exp.sum(),
            chunk.region_overflow.to(i32).sum(),
            chunk.region_pool_need.max(),
            chunk.n_collisions.max(),
            # lifecycle skip hints (Lifecycle.dues)
            torch.any(state.alive & (
                state.nv > cfg.processes.simplify_max_verts)),
            torch.any(last.pair_valid) | torch.any(last.boundary_contact),
            torch.any(last.overlap_area > 0),
            chunk.nbr_overflow.any(),
            chunk.nbr_demand.max(),
            chunk.pair_pool_overflow.to(i32).sum(),
            chunk.pair_pool_need.max(),
            # max live vertex count (drives the two-way vertex-rung
            # auto-sizing in _maybe_shrink_pools)
            torch.max(torch.where(state.alive, state.nv,
                                  torch.zeros_like(state.nv))),
        )])
        if mesh is not None:
            # the flags read from this rank's slab; every other entry is
            # global already
            summary = mesh.pmax(summary)
        # per-step export slots ride the same single-fetch vector; the host
        # sums them in float64 (s[1] keeps the chunk total in the state
        # dtype for quick checks)
        summary = torch.cat([summary, exp])
        return state, dissolved, vd_tend, eul_acc, chunk, summary

    def _grow_pools(self, s: np.ndarray) -> bool:
        """Auto-size fixed capacity pools from chunk telemetry
        (ContactConfig.region_pool_auto): on per-region pool overflow, grow
        region_pair_frac to the measured demand; on broad-phase candidate
        overflow, grow max_neighbors.  Returns True when the cfg changed
        (the caller re-runs the chunk with the rebuilt step so no step
        ever executes with degraded physics).

        Targets are quantized — max_neighbors to a geometric ladder
        (8, 13, 20, 31, ...) and pool slots to powers of two — as in the
        JAX driver, so both packages size their pools alike."""
        if not self.cfg.contact.region_pool_auto:
            return False
        dc = dataclasses
        n_rov = int(s[2])
        need = int(s[3])
        nbr_ovf = bool(s[8])
        nbr_demand = int(s[9])
        pp_ovf = int(s[10])
        pp_need = int(s[11])
        grew = False
        cfg = self.cfg
        if pp_ovf and cfg.contact.pair_pool \
                and cfg.contact.pair_pool_frac < 1.0:
            p_count = self.state.n * cfg.capacity.max_neighbors
            frac = cfg.contact.pair_pool_frac
            new_frac = min(1.0, _pool_slots(int(pp_need * 1.25) + 1)
                           / max(p_count, 1))
            if new_frac > frac:
                print(f"[sim] step {self.step_idx}: active-pair pool "
                      f"demand {pp_need} exceeded the pool — growing "
                      f"pair_pool_frac {frac:.4g} -> {new_frac:.4g} and "
                      "re-running the chunk")
                cfg = cfg.replace(contact=dc.replace(
                    cfg.contact, pair_pool_frac=new_frac))
                grew = True
        if n_rov and cfg.contact.region_pair_frac < 1.0:
            p_count = self.state.n * cfg.capacity.max_neighbors
            frac = cfg.contact.region_pair_frac
            new_frac = min(1.0, _pool_slots(int(need * 1.25) + 1)
                           / max(p_count, 1))
            if new_frac > frac:
                print(f"[sim] step {self.step_idx}: per-region pool demand "
                      f"{need} exceeded the pool — growing region_pair_frac "
                      f"{frac:.4g} -> {new_frac:.4g} and re-running the "
                      "chunk")
                cfg = cfg.replace(contact=dc.replace(
                    cfg.contact, region_pair_frac=new_frac))
                grew = True
        if nbr_ovf:
            k = cfg.capacity.max_neighbors
            new_k = min(_ladder_k(max(int(nbr_demand * 1.1) + 1, k + 1)),
                        self.state.n)
            if new_k > k:
                print(f"[sim] step {self.step_idx}: broad-phase candidate "
                      f"demand {nbr_demand} — growing max_neighbors "
                      f"{k} -> {new_k} and re-running the chunk")
                cfg = cfg.replace(capacity=dc.replace(
                    cfg.capacity, max_neighbors=new_k))
                grew = True
        if grew:
            self.cfg = cfg
            self.__post_init__()   # rebuild; lifecycle RNG/ledger kept
        return grew

    # window (in chunks) over which pool demand maxima are taken before a
    # shrink; long enough that a periodic lifecycle spike stays in view
    _SHRINK_WINDOW = 64

    def _maybe_shrink_pools(self, s: np.ndarray) -> None:
        """Two-way auto-sizing: when the windowed demand maxima sit far
        below the current pools, shrink them (growth ratcheted pools stay
        at their historical peak otherwise — the resumed Nares campaign
        carried max_neighbors 152 / frac 0.67 for a measured demand of ~30
        / ~2k, paying >5x the narrow-phase work every step).  Runs AFTER a
        chunk is committed: a shrink never invalidates computed physics —
        if it undershoots, the next chunk's overflow grows it back (and
        re-runs that chunk), so physics is never degraded either way.

        As in the JAX driver, the ``region_pool_auto`` gate below also gates
        the vertex-rung shrink (a quirk of the reference kept for parity,
        ROADMAP §C)."""
        if not self.cfg.contact.region_pool_auto:
            return
        dc = dataclasses
        win = getattr(self, "_demand_win", None)
        if win is None:
            win = self._demand_win = []
        # fold in this boundary's birth vertex need: the chunk summaries
        # predate the lifecycle's births, so without it a window that fills
        # at this boundary could shrink the rung below a floe born moments
        # ago (silent geometry truncation, nv > v_cap)
        birth_nv = getattr(self.lifecycle, "last_birth_nv", 0)
        self.lifecycle.last_birth_nv = 0
        win.append((int(s[3]), int(s[9]), int(s[11]),
                    max(int(s[12]), birth_nv)))
        if len(win) < self._SHRINK_WINDOW:
            return
        need_max = max(w[0] for w in win)
        nbr_max = max(w[1] for w in win)
        pp_max = max(w[2] for w in win)
        nv_max = max(w[3] for w in win)
        del win[:]
        cfg = self.cfg
        changed = False
        if cfg.capacity.verts_auto:
            v_new = _ladder_v(nv_max, cfg.capacity.max_verts)
            if v_new < self.state.v_cap:
                print(f"[sim] step {self.step_idx}: vertex rung shrink "
                      f"{self.state.v_cap} -> {v_new} (windowed max live "
                      f"nv {nv_max})")
                self.state = _resize_verts(self.state, v_new)
                cfg = cfg.replace(capacity=dc.replace(
                    cfg.capacity, active_verts=v_new))
                changed = True
        k = cfg.capacity.max_neighbors
        k_new = max(_ladder_k(int(nbr_max * 1.25) + 1), 8)
        if k_new < k:
            cfg = cfg.replace(capacity=dc.replace(
                cfg.capacity, max_neighbors=k_new))
            changed = True
        # region pool: shrink to the EXACT demand (128-aligned) — shrinks
        # happen once per steady regime so the one compile is cheap, and
        # pool cost is linear in slots (the concave star bench runs 225k
        # floe-steps/s exactly-sized vs 174k at the next pow2).  Growth
        # stays pow2 for fast reaction + compile-cache reuse.
        p_count = self.state.n * cfg.capacity.max_neighbors
        slots_cur = max(128, math.ceil(
            p_count * cfg.contact.region_pair_frac))
        slots_new = max(128, -(-int(need_max * 1.25 + 1) // 128) * 128)
        if slots_new < slots_cur:
            cfg = cfg.replace(contact=dc.replace(
                cfg.contact,
                region_pair_frac=min(1.0, slots_new / max(p_count, 1))))
            changed = True
        if cfg.contact.pair_pool:
            pp_cur = max(256, math.ceil(
                p_count * cfg.contact.pair_pool_frac))
            pp_new = max(256, -(-int(pp_max * 1.25 + 1) // 128) * 128)
            if pp_new < pp_cur:
                cfg = cfg.replace(contact=dc.replace(
                    cfg.contact,
                    pair_pool_frac=min(1.0, pp_new / max(p_count, 1))))
                changed = True
        if changed:
            print(f"[sim] step {self.step_idx}: pool shrink — "
                  f"max_neighbors {k} -> {cfg.capacity.max_neighbors}, "
                  f"region pool -> {max(128, math.ceil(self.state.n * cfg.capacity.max_neighbors * cfg.contact.region_pair_frac))} "
                  f"slots (windowed demand: nbr {nbr_max}, region "
                  f"{need_max})")
            self.cfg = cfg
            self.__post_init__()

    def _grow_floes(self, state: FloeState, need: int) -> FloeState:
        """Grow the floe capacity to at least ``need`` slots (padding every
        state array with dead slots).  Hooked into the lifecycle
        as ``grow_fn``: a fracture storm grows the pool instead of the
        capacity guard dissolving births (the reference's arrays grow
        without bound, fracture.m:51-55) — and runs before the storm don't
        pay for headroom they don't use yet."""
        dc = dataclasses
        mult = 8
        if self.mesh is not None:
            mult = math.lcm(8, self.mesh.size)
        new_cap = max(need, int(state.n * 1.5))
        new_cap = -(-new_cap // mult) * mult
        print(f"[sim] step {self.step_idx}: growing floe capacity "
              f"{state.n} -> {new_cap}")
        self.cfg = self.cfg.replace(capacity=dc.replace(
            self.cfg.capacity, max_floes=new_cap))
        from .state import empty_state

        proto = empty_state(self.cfg, dtype=state.x.dtype,
                            device=state.device)
        upd = {}
        for f in dataclasses.fields(state):
            arr = getattr(state, f.name)
            tail = getattr(proto, f.name)[arr.shape[0]:]
            upd[f.name] = torch.cat([arr, tail], dim=0)
        state = proto.replace(**upd)
        # defer the rebuild to the run loop (self.cfg is not self._built_cfg)
        return state

    def _grow_verts(self, state: FloeState, need: int) -> FloeState:
        """Widen the vertex axis to the ladder rung covering ``need``
        (bounded by the max_verts fidelity cap).  Hooked into the lifecycle
        as ``grow_verts_fn``: a fusion/weld/pack birth wider than the
        auto-shrunk rung widens the arrays instead of being truncated
        below the fidelity bound.  The rebuild is deferred to the run loop."""
        dc = dataclasses
        cap = self.cfg.capacity.max_verts
        new_v = _ladder_v(need, cap)
        if new_v <= state.v_cap:
            return state
        print(f"[sim] step {self.step_idx}: growing vertex rung "
              f"{state.v_cap} -> {new_v} (birth needs {need} vertices)")
        state = _resize_verts(state, new_v)
        self.cfg = self.cfg.replace(capacity=dc.replace(
            self.cfg.capacity, active_verts=new_v))
        self.lifecycle.cfg = self.cfg
        return state

    def _fit_verts(self) -> None:
        """One-time initial fit of the vertex rung to the population
        (CapacityConfig.verts_auto): initial fields are built at the
        max_verts fidelity cap, but e.g. Voronoi floes carry 6-15 vertices
        — clip cost is O(V^2) per pair, so starting at the population's
        actual rung is a ~(cap/need)^2 narrow-phase saving."""
        nv = self.state.nv.cpu().numpy()
        al = self.state.alive.cpu().numpy()
        mx = int(nv[al].max()) if al.any() else 3
        new_v = _ladder_v(mx, self.cfg.capacity.max_verts)
        if new_v != self.state.v_cap:
            print(f"[sim] vertex rung fitted to population: "
                  f"{self.state.v_cap} -> {new_v} (max live nv {mx})")
            self.state = _resize_verts(self.state, new_v)
            self.__post_init__()   # syncs cfg.active_verts

    def _update_walls(self) -> None:
        """Moving walls (uniaxial case): rebuild the domain polygon only
        when the wall position actually changed (it moves every
        ``wall_cadence`` steps)."""
        lx, ly = self.wall_fn(self.step_idx)
        if getattr(self, "_wall_now", None) == (lx, ly):
            return
        self._wall_now = (lx, ly)
        dom_np = np.array([[-lx, -ly], [lx, -ly], [lx, ly], [-lx, ly]])
        pad, _ = _pad_domain(dom_np)
        self._domain = torch.as_tensor(pad, dtype=self.state.x.dtype,
                                       device=self.state.device)
        self.lifecycle.domain_poly = dom_np

    # -- main loop ---------------------------------------------------------

    def run(self, n_steps: int,
            on_chunk: "Callable[[Simulation, ChunkAux], None] | None" = None,
            log_every: int = 0) -> "Simulation":
        """Advance ``n_steps``; host callbacks at chunk boundaries.

        Host work per chunk is one small-tensor copy (the chunk summary);
        the lifecycle — including its state extraction — runs only when a
        pass is actually due (by cadence AND the device-derived skip hints)
        or a merge was flagged.  Everything else stays on the device
        between output boundaries.  The host seconds of each phase go to
        :attr:`phase_times`, the physics step's own spans nested under
        "chunk".
        """
        with recording(self.phase_times):
            return self._advance(n_steps, on_chunk, log_every)

    def _advance(self, n_steps: int, on_chunk, log_every: int
                 ) -> "Simulation":
        """:meth:`run`'s loop, inside the recording of ``phase_times``."""
        done = 0
        t0 = time.perf_counter()
        if self.cfg.capacity.verts_auto and not getattr(
                self, "_verts_fit", False):
            self._verts_fit = True
            self._fit_verts()
        if self.cfg is not self._built_cfg:
            # cfg was replaced after construction: rebuild; lifecycle
            # RNG/ledger state is preserved across the re-init
            self.__post_init__()
        if not getattr(self, "_chunk_frozen", False):
            # wall_fn / output_dir may be attached after construction:
            # re-derive the chunk once, before the first chunk
            self._chunk = self._pick_chunk()
            self._chunk_frozen = True
        dt_ = self.state.x.dtype
        dev = self.state.device
        dissolved = torch.as_tensor(self.dissolved, dtype=dt_, device=dev)
        vd_tend = getattr(self, "_vd_tend", None)
        if self.cfg.processes.advect_dissolved:
            if vd_tend is None:
                vd_tend = torch.zeros_like(dissolved)
        else:
            vd_tend = None
        eul_acc = getattr(self, "_eul_acc", None)
        if self.cfg.processes.average:
            if eul_acc is None:
                eul_acc = self._zero_eul()
                self._eul_n = 0
        else:
            eul_acc = None
        while done < n_steps:
            # land on multiples of the chunk so process cadences stay on
            # chunk boundaries even after a partial run() call
            n = min(self._chunk - (self.step_idx % self._chunk),
                    n_steps - done)
            if self.wall_fn is not None:
                self._update_walls()
            with span("chunk"):
                for attempt in range(8):
                    (st2, dis2, vd2, eul2, auxes,
                     summary) = self._run_chunk(
                        self.state, self.step_idx, n, dissolved, vd_tend,
                        eul_acc, self._domain,
                    )
                    # ONE device->host copy per chunk
                    with sync("summary"):
                        s = summary.cpu().numpy()
                    # a capacity pool overflowed: the step ran with
                    # degraded physics (aggregate-contact fallback /
                    # dropped candidate contacts) — the cfg was grown and
                    # the step rebuilt; RE-RUN the chunk from the same
                    # inputs so no degraded step survives
                    if not self._grow_pools(s):
                        break
            self.state, dissolved, vd_tend, eul_acc = st2, dis2, vd2, eul2
            self.step_idx += n
            done += n
            merge_any = bool(s[0])
            # f64 host sum of the per-step export slots (s[13:]); s[1] is
            # the chunk total in the state dtype, kept as a sanity value
            exported = float(np.sum(s[13:].astype(np.float64)))
            n_rov = int(s[2])
            need = int(s[3])
            ncol = int(s[4])
            hints = {
                "any_oversize": bool(s[5]),
                "any_contact": bool(s[6]),
                "any_pair_overlap": bool(s[7]),
            }
            # device-side export kills (Nares below-ymin, out-of-domain,
            # boundary absorption) fold into the exported-mass ledger
            if exported:
                self.lifecycle.exported_mass += exported
            if eul_acc is not None:
                self._eul_n = getattr(self, "_eul_n", 0) + n
            # host-side lifecycle at the chunk boundary — only when due
            if merge_any or self.lifecycle.any_due(self.step_idx, hints):
                # ONE combined device->host copy for the whole boundary:
                # view + last-step aux (+ the chunk's merge-pair pool when a
                # merge was flagged)
                from .processes.host import unpack_view, view_width

                with span("aux_fetch"):
                    # a mesh's aux as the global arrays: every rank
                    # reaches this boundary (the summary is reduced over
                    # the mesh, the lifecycle is shared)
                    baux = auxes if self.mesh is None else _gather_chunk(
                        auxes, self.mesh,
                        ("merge_i", "nbr_idx") if merge_any else ())
                    nn = self.state.n
                    kk = self.cfg.capacity.max_neighbors
                    w1 = view_width(self.state.v_cap)
                    cap_a = getattr(self, "_aux_cap", 512)
                    self._aux_cap = cap_a
                    wa = -(-(8 * cap_a + 1) // nn)
                    if merge_any:
                        packed = _pack_boundary_merges(
                            self.state, baux, dissolved, cap_a).cpu().numpy()
                    else:
                        packed = _pack_boundary(
                            self.state, baux.last, dissolved,
                            cap_a).cpu().numpy()
                    view = unpack_view(packed[:, :w1], nn)
                    bc_col = packed[:, w1]
                    avals = packed[:, w1 + 1:w1 + 1 + wa].T.reshape(-1)
                    a_count = int(avals[0])
                    if a_count > cap_a:
                        # contact-entry pool overflow: dense fallback this
                        # boundary (one extra copy) and raise the cap
                        while cap_a < a_count * 1.25:
                            cap_a *= 2
                        self._aux_cap = cap_a
                        aux_last = _unpack_aux(
                            _pack_aux_last(baux.last).cpu().numpy())
                    else:
                        aux_last = _unpack_aux_compact(
                            avals[1:1 + 8 * cap_a], bc_col, nn, kk)
                    w2c = 1 + wa
                    nd = self.ny_coarse * self.nx_coarse
                    wd = -(-nd // nn)
                    dis_np = np.asarray(
                        packed[:, w1 + w2c:w1 + w2c + wd].T.reshape(-1)[:nd]
                        .reshape(self.ny_coarse, self.nx_coarse), np.float64)
                with span("merge_fetch"):
                    if merge_any:
                        vals = packed[:, w1 + w2c + wd:].T.reshape(-1)
                        cnt = int(vals[0])
                        if cnt > _MERGE_POOL:
                            # pool overflow (storm-scale merge burst): fall
                            # back to the full chunk merge tables
                            mk = _pack_merges(baux).cpu().numpy()
                            merge_pairs = _merge_pairs_from(
                                mk[..., 0] != 0,
                                mk[..., 1].astype(np.int64), n)
                        else:
                            pool = vals[1:1 + 2 * cnt].astype(np.int64
                                                              ).reshape(-1, 2)
                            merge_pairs = list(dict.fromkeys(
                                (int(i), int(j)) for i, j in pool))
                    else:
                        merge_pairs = []
                with span("lifecycle"):
                    self.state, dis_np, changed = self.lifecycle.step(
                        self.state, aux_last, self.step_idx, dis_np,
                        merge_pairs=merge_pairs, hints=hints, view=view,
                    )
                with span("rebuild"):
                    if self.cfg is not self._built_cfg:
                        # the lifecycle grew the floe capacity or the
                        # vertex rung: rebuild (which rebalances a mesh's
                        # slabs with the new cfg itself)
                        self.__post_init__()
                    elif changed and self.mesh is not None:
                        self.state = self._reshard(self.state)
                dissolved = torch.as_tensor(dis_np, dtype=dt_, device=dev)
                self.dissolved = dis_np
            # Surface per-region pool overflow: those steps fell back to
            # aggregate contacts (physics degradation — raise
            # ContactConfig.region_pair_frac if this keeps firing).
            self.region_pool_need_max = max(
                getattr(self, "region_pool_need_max", 0), need)
            if n_rov:
                self.region_overflow_steps = (
                    getattr(self, "region_overflow_steps", 0) + n_rov)
                if not getattr(self, "_rov_warned", False):
                    self._rov_warned = True
                    print(
                        f"[sim] WARNING step {self.step_idx}: per-region "
                        f"pool overflow — {n_rov} step(s) fell back to "
                        "aggregate contacts (raise ContactConfig."
                        "region_pair_frac)"
                    )
            # shrink BEFORE any output snapshot: the saved demand window
            # must already contain this chunk's entry, or a campaign
            # resumed from the snapshot fills its window one chunk later
            # than the straight run and resizes at different steps
            self._maybe_shrink_pools(s)
            if self.output_dir is not None:
                with span("output"):
                    self.dissolved = dissolved.cpu().numpy()
                    eul_acc = self._auto_output(eul_acc)
            if on_chunk is not None:
                self.dissolved = dissolved.cpu().numpy()
                on_chunk(self, auxes if self.mesh is None
                         else _gather_chunk(auxes, self.mesh))
            if log_every and (self.step_idx % log_every == 0):
                self.record_metrics(ncol)
                m = self.metrics_history()
                rate = done / max(time.perf_counter() - t0, 1e-9)
                print(
                    f"step {self.step_idx}: {m['alive'][-1]} floes, "
                    f"{m['collisions'][-1]} collisions, {rate:.1f} steps/s"
                )
        self.dissolved = dissolved.cpu().numpy()
        if vd_tend is not None:
            self._vd_tend = vd_tend
        if eul_acc is not None:
            self._eul_acc = eul_acc
        return self

    # -- automatic output (Subzero.m:220-298) --------------------------------

    def _auto_output(self, eul_acc=None):
        """Every n_dt_out steps write snapshot + Eulerian fields and append
        the mass series.  ``eul_acc``: the AVERAGE accumulator (summed every
        step inside the chunk); consumed and re-zeroed at the output
        boundary.  Returns the (possibly reset) accumulator.  With
        ``plot_output`` it also writes ``fig{step:07d}.png``.  On a mesh
        every rank resets the accumulator and rank 0 alone writes."""
        n_out = self.cfg.processes.n_dt_out
        if self.step_idx % n_out != 0:
            return eul_acc
        if self.mesh is not None and self.mesh.rank != 0:
            if self.cfg.processes.average and eul_acc is not None \
                    and getattr(self, "_eul_n", 0) > 0:
                eul_acc = self._zero_eul()
                self._eul_n = 0
                self._eul_acc = None
            return eul_acc
        out = Path(self.output_dir)
        snap = out / f"snap{self.step_idx:07d}"
        if (self.cfg.processes.average and eul_acc is not None
                and getattr(self, "_eul_n", 0) > 0):
            # sorted keys, as the JAX driver writes them
            eul = {k: v.cpu().numpy() / self._eul_n
                   for k, v in sorted(eul_acc._asdict().items())}
            eul_acc = self._zero_eul()
            self._eul_n = 0
            self._eul_acc = None  # interval complete: checkpoint saves none
        else:
            eul = {k: v.cpu().numpy()
                   for k, v in self.eulerian()._asdict().items()}
        self.save(snap)
        np.savez_compressed(snap / "eulerian.npz", **eul)
        # total-mass series (Subzero.m:294-295); continue an existing
        # on-disk series across checkpoint resumes
        series = getattr(self, "_mass_series", None)
        if series is None:
            series = []
            prior = out / "mass_series.npy"
            if prior.exists():
                series = [tuple(row) for row in np.load(prior)
                          if row[0] < self.step_idx]
        series.append((self.step_idx, self.total_mass(),
                       float(np.sum(self.dissolved if self.dissolved
                                    is not None else 0.0)),
                       self.lifecycle.exported_mass))
        # older series rows had no exported column: pad with 0
        series = [tuple(r) + (0.0,) * (4 - len(r)) for r in series]
        self._mass_series = series
        np.save(out / "mass_series.npy", np.asarray(series))
        if self.plot_output:
            try:
                from .plotting import plot_basic     # selects Agg

                fig = plot_basic(self.state, self.cfg, self.forcing)
                fig.savefig(out / f"fig{self.step_idx:07d}.png", dpi=110)
                import matplotlib.pyplot as plt

                plt.close(fig)
            except Exception as e:  # plotting must never kill a run
                print(f"[sim] plot failed: {e}")
        return eul_acc

    # -- observability -----------------------------------------------------

    def metrics_history(self) -> dict:
        """Accumulated per-chunk series: step, wall time, collisions, live
        floe count, total mass."""
        if not hasattr(self, "_metrics"):
            self._metrics = {
                "step": [], "wall_s": [], "collisions": [],
                "alive": [], "mass": [],
            }
        return self._metrics

    def record_metrics(self, n_collisions: int) -> None:
        m = self.metrics_history()
        m["step"].append(self.step_idx)
        m["wall_s"].append(time.time())
        m["collisions"].append(int(n_collisions))
        m["alive"].append(int(self.state.alive.sum()))
        m["mass"].append(float(total_mass(self.state)))

    @property
    def phase_times(self) -> Table:
        """Host seconds by span (a :class:`trace.Table`): the driver's
        phases at the top level — chunk (the steps, and the summary copy
        that waits for the card), the boundary's aux/merge copies,
        lifecycle host passes, rebuilds, output IO — and the step's spans
        nested under "chunk"; with entry counts and the named counts
        (the clip kernels' launches).  Kept at ``_phase_times``; deleting that
        attribute starts an empty table."""
        table = self.__dict__.get("_phase_times")
        if table is None:
            table = self.__dict__["_phase_times"] = Table()
        return table

    def phase_report(self) -> str:
        """Human-readable span tree with self times (a share is of the
        top-level spans' total, so nested spans count once), then the
        lifecycle's per-pass times and edit counts."""
        lines = ["phase breakdown (host seconds; self = less nested spans):"]
        lines += self.phase_times.report()
        pt = self.lifecycle.pass_times
        if pt or pt.counts:
            lines.append("lifecycle passes:")
            lines += pt.report()
        return "\n".join(lines)

    def profile(self, path: str, n_steps: int = 10) -> str:
        """Run ``n_steps`` under ``torch.profiler`` (CPU and, on a CUDA
        state, CUDA activity); the Chrome trace goes to ``path``, with the
        program's spans as ``subzero.<path>`` ranges beside the kernels."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.state.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            self.run(n_steps)
        prof.export_chrome_trace(str(path))
        return path

    # -- diagnostics -------------------------------------------------------

    def eulerian(self) -> EulerianData:
        return eulerian_data(self.state, self.cfg, self.nx_coarse,
                             self.ny_coarse)

    def total_mass(self) -> float:
        return float(total_mass(self.state))

    # -- checkpoint / resume: the JAX driver's format ------------------------

    def save(self, path: str | Path):
        """Full-run checkpoint in the JAX driver's format: SoA floe state
        (``state.npz``, each field in its own dtype) + ``meta.json`` (step
        counter, the config as ``dataclasses.asdict``, lifecycle PCG64
        state, exported-mass ledger, telemetry, metrics) + dissolved grid +
        AVERAGE accumulator + dissolved-advection AB2 tendency.  A
        checkpoint of either package loads in the other.  On a mesh only
        rank 0 writes (every rank holds the same global state)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        # ONE packed device->host copy; every field is exactly
        # representable in the state dtype (alive/nv are tiny ints)
        packed = _pack_state(self.state).cpu().numpy()
        arrays = {}
        off = 0
        for f in dataclasses.fields(self.state):
            a = getattr(self.state, f.name)
            sz = int(np.prod(a.shape[1:])) if a.ndim > 1 else 1
            chunk = packed[:, off:off + sz].reshape(tuple(a.shape))
            arrays[f.name] = np.asarray(chunk, _NP_DTYPES[a.dtype])
            off += sz
        np.savez_compressed(path / "state.npz", **arrays)
        meta = {
            "step_idx": self.step_idx,
            "modulus": self.modulus,
            "heat_flux": self.heat_flux,
            "nx_coarse": self.nx_coarse,
            "ny_coarse": self.ny_coarse,
            "seed": self.seed,
            "pack_target": self.pack_target,
            "cfg": dataclasses.asdict(self.cfg),
            # lifecycle run state: the PCG64 state dict round-trips through
            # JSON (python ints are arbitrary precision)
            "lifecycle": {
                "rng_state": self.lifecycle.rng.bit_generator.state,
                "exported_mass": self.lifecycle.exported_mass,
                "amax": self.lifecycle.amax,
            },
            "telemetry": {
                "region_overflow_steps":
                    getattr(self, "region_overflow_steps", 0),
                "region_pool_need_max":
                    getattr(self, "region_pool_need_max", 0),
                # two-way auto-sizing window: persisted so a resumed run's
                # shrink timing matches the straight run's
                "demand_win": [list(map(int, w)) for w in
                               getattr(self, "_demand_win", [])],
            },
            "metrics": getattr(self, "_metrics", None),
        }
        (path / "meta.json").write_text(json.dumps(meta, indent=1))
        np.save(path / "dissolved.npy", self.dissolved)
        # AVERAGE accumulator (partial output interval) + dissolved-advection
        # AB2 tendency
        acc = getattr(self, "_eul_acc", None)
        if acc is not None and getattr(self, "_eul_n", 0):
            np.savez_compressed(path / "eul_acc.npz", _eul_n=self._eul_n,
                                **{k: v.cpu().numpy() for k, v in
                                   sorted(acc._asdict().items())})
        tend = getattr(self, "_vd_tend", None)
        if tend is not None:
            np.save(path / "vd_tend.npy", tend.cpu().numpy())

    @classmethod
    def load(cls, path: str | Path, cfg: SimConfig, forcing: Forcing,
             device=None) -> "Simulation":
        """Resume a checkpoint of either package on ``device`` (CUDA unless
        the caller names another)."""
        from .device import resolve_device
        from .state import empty_state

        dev = resolve_device(device)
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        data = np.load(path / "state.npz")
        # Floe capacity must cover the saved state arrays.  The OTHER pools
        # (neighbor table, per-region pool) resume from the caller's lean
        # defaults when auto-sizing is on: overflow re-runs the chunk at
        # the right size (no degraded step).  Without auto-sizing the saved
        # sizes are adopted.
        saved_cfg = meta.get("cfg") or {}
        dc = dataclasses
        scap = saved_cfg.get("capacity") or {}
        scon = saved_cfg.get("contact") or {}
        cfg = cfg.replace(capacity=dc.replace(
            cfg.capacity,
            max_floes=max(cfg.capacity.max_floes,
                          scap.get("max_floes", 0)),
            # the vertex rung is part of the saved arrays' shape: adopt it;
            # the max_verts fidelity cap is adopted from the snapshot too
            # (a campaign keeps its labeled physics regime)
            max_verts=scap.get("max_verts", cfg.capacity.max_verts),
            active_verts=scap.get("active_verts")
            or scap.get("max_verts", cfg.capacity.max_verts),
        ))
        if not cfg.contact.region_pool_auto:
            cfg = cfg.replace(
                capacity=dc.replace(
                    cfg.capacity,
                    max_neighbors=max(cfg.capacity.max_neighbors,
                                      scap.get("max_neighbors", 0)),
                ),
                contact=dc.replace(
                    cfg.contact,
                    region_pair_frac=max(cfg.contact.region_pair_frac,
                                         scon.get("region_pair_frac", 0.0)),
                ),
            )
        proto = empty_state(cfg, device=dev)
        n_saved = data["alive"].shape[0]  # saved floe capacity

        def _fit(k):
            # Saved at a smaller floe capacity than cfg now asks for: pad
            # with empty slots (only the floe axis may be padded).
            tgt = getattr(proto, k)
            arr = torch.from_numpy(np.array(data[k])).to(device=dev,
                                                         dtype=tgt.dtype)
            if (tuple(arr.shape) != tuple(tgt.shape)
                    and arr.shape[1:] == tgt.shape[1:]
                    and arr.shape[0] == n_saved
                    and arr.shape[0] < tgt.shape[0]):
                arr = torch.cat([arr, tgt[arr.shape[0]:]], dim=0)
            return arr

        state = proto.replace(**{k: _fit(k) for k in data.files})
        sim = cls(
            cfg=cfg, state=state, forcing=forcing,
            modulus=meta["modulus"], heat_flux=meta["heat_flux"],
            nx_coarse=meta["nx_coarse"], ny_coarse=meta["ny_coarse"],
            step_idx=meta["step_idx"],
            seed=meta.get("seed", 0),
            pack_target=meta.get("pack_target", 1.0),
            dissolved=np.load(path / "dissolved.npy"),
        )
        lc = meta.get("lifecycle")
        if lc:
            sim.lifecycle.rng.bit_generator.state = lc["rng_state"]
            sim.lifecycle.exported_mass = lc["exported_mass"]
            if lc["amax"] is not None:
                sim.lifecycle.amax = lc["amax"]
        tel = meta.get("telemetry") or {}
        sim.region_overflow_steps = tel.get("region_overflow_steps", 0)
        sim.region_pool_need_max = tel.get("region_pool_need_max", 0)
        sim._demand_win = [tuple(w) for w in tel.get("demand_win", [])]
        # the snapshot's vertex rung is authoritative (no re-fit)
        sim._verts_fit = True
        if meta.get("metrics"):
            sim._metrics = meta["metrics"]
        if (path / "eul_acc.npz").exists():
            acc = dict(np.load(path / "eul_acc.npz"))
            sim._eul_n = int(acc.pop("_eul_n"))
            sim._eul_acc = EulerianData(
                **{k: torch.from_numpy(v).to(dev) for k, v in acc.items()})
        if (path / "vd_tend.npy").exists():
            sim._vd_tend = torch.from_numpy(
                np.load(path / "vd_tend.npy")).to(dev)
        return sim


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.int32: np.int32, torch.bool: np.bool_}


def _gather_chunk(chunk: ChunkAux, mesh, fields=StepAux._fields
                  ) -> ChunkAux:
    """A mesh chunk's aux as the global arrays: the last step whole and
    the ``fields`` of every earlier step, each per-floe field gathered from
    every rank's slab along the floe axis (scalars are global already).
    Every rank calls it at the same point of the loop, so the gathers line
    up."""
    def gather(aux: StepAux, names) -> StepAux:
        return aux._replace(**{
            f: mesh.all_gather(getattr(aux, f)) for f in names
            if getattr(aux, f).dim()})

    steps = chunk._steps
    return ChunkAux([gather(a, fields) for a in steps[:-1]]
                    + [gather(steps[-1], StepAux._fields)])


def _pack_state(state: FloeState) -> torch.Tensor:
    """All state fields flattened into ONE [N, F] tensor (single
    device->host copy for checkpoints)."""
    n = state.n
    dt = state.x.dtype
    return torch.cat([
        getattr(state, f.name).to(dt).reshape(n, -1)
        for f in dataclasses.fields(state)
    ], dim=1)


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _merge_pairs_from(mi: np.ndarray, nbr: np.ndarray, n: int
                      ) -> "list[tuple[int, int]] | None":
    mi = mi[:n]
    nbr = nbr[:n]
    if not mi.any():
        return None
    s_t, i_t, k_t = np.nonzero(mi)
    return list(dict.fromkeys(
        (int(i), int(nbr[s, i, k]))
        for s, i, k in zip(s_t, i_t, k_t)))


def chunk_merge_pairs(auxes, n: int) -> "list[tuple[int, int]] | None":
    """(absorbee, partner) merge pairs OR'd across a whole chunk
    (``auxes.merge_i`` / ``auxes.nbr_idx`` are [c, N, K]).

    The reference fuses >55%-overlap pairs EVERY step
    (floe_interactions_all.m:470-501); flags raised at any step of the chunk
    must not be dropped just because the overlap cleared by the last step —
    each flag is resolved against its own step's neighbor table."""
    return _merge_pairs_from(_np(auxes.merge_i), _np(auxes.nbr_idx), n)


def _cols(vals: torch.Tensor, nn: int) -> torch.Tensor:
    """Flatten ``vals`` into ceil(len/nn) columns of an [nn, w] block
    (column-major; host reads ``block.T.reshape(-1)[:len]``)."""
    w = -(-vals.shape[0] // nn)
    pad = torch.zeros((nn * w - vals.shape[0],), dtype=vals.dtype,
                      device=vals.device)
    return torch.cat([vals, pad]).reshape(w, nn).T


def _compact_positions(flat: torch.Tensor, cap: int) -> torch.Tensor:
    """[cap] flat indices of the first ``cap`` set entries of the bool
    vector ``flat``, in order, -1 past the last.  The prefix count places
    entry k at slot (number of set entries before it); entries past the
    pool go to a dummy slot that is dropped."""
    pos = torch.cumsum(flat.to(torch.int64), 0) - 1
    tgt = torch.where(flat & (pos < cap), pos, torch.full_like(pos, cap))
    sel = torch.full((cap + 1,), -1, dtype=torch.int64, device=flat.device)
    sel[tgt] = torch.arange(flat.shape[0], device=flat.device)
    return sel[:cap]


def _pack_boundary(state: FloeState, last: StepAux, dissolved, aux_cap: int):
    """View + compacted last-step aux + dissolved grid as ONE [N, W]
    tensor: a lifecycle boundary costs a single device->host copy, and the
    aux rides as a contact-entry pool instead of the dense [N, 7K+1]
    table."""
    from .processes.host import _pack_view

    dt = state.x.dtype
    aux_vals, count, bc = _pack_aux_compact(last, aux_cap)
    return torch.cat(
        [_pack_view(state), bc[:, None],
         _cols(torch.cat([count[None].to(dt), aux_vals]), state.n),
         _cols(dissolved.reshape(-1).to(dt), state.n)],
        dim=1)


# merge-pair pool capacity for the compact boundary fetch: merges are a
# few per chunk in every reference case; the full [c, N, K, 2] tables are
# fetched only when the pool overflows
_MERGE_POOL = 256


def _pack_boundary_merges(state: FloeState, auxes: ChunkAux, dissolved,
                          aux_cap: int):
    """View + compacted aux + dissolved + a device-compacted merge-pair
    pool, ONE copy.

    Layout: [N, W1 + W2 + W3] where the last W3 columns carry the
    flattened (count, i_0, j_0, i_1, j_1, ...) pool padded to N*W3 and
    written column-major (host reads ``packed[:, w1+w2:].T.reshape(-1)``).
    Pool order equals np.nonzero's (step, floe, slot) lexicographic order,
    so host-side first-occurrence dedup matches _merge_pairs_from exactly.
    """
    from .processes.host import _pack_view

    mi = auxes.merge_i                          # [c, N, K] bool
    c, nn, k = mi.shape
    flat = mi.reshape(-1)
    sel = _compact_positions(flat, _MERGE_POOL)
    valid = sel >= 0
    sel_c = torch.clamp(sel, min=0)
    i_f = (sel_c // k) % nn
    j_f = auxes.nbr_idx.reshape(-1)[sel_c].to(torch.int64)
    count = torch.sum(flat.to(torch.int64))
    none = torch.full_like(i_f, -1)
    pool = torch.stack([torch.where(valid, i_f, none),
                        torch.where(valid, j_f, none)], dim=1).reshape(-1)
    dt = state.x.dtype
    vals = torch.cat([count[None], pool]).to(dt)
    aux_vals, a_count, bc = _pack_aux_compact(auxes.last, aux_cap)
    return torch.cat(
        [_pack_view(state), bc[:, None],
         _cols(torch.cat([a_count[None].to(dt), aux_vals]), nn),
         _cols(dissolved.reshape(-1).to(dt), nn),
         _cols(vals, nn)], dim=1)


def _pack_aux_compact(last: StepAux, cap: int):
    """Last-step aux as a compacted contact-entry pool [cap, 8] + count.

    Only slots with a valid contact or positive overlap matter to the
    lifecycle (corner contact points, fracture deform info, ridge/raft
    selection).  Dense fallback on overflow (count > cap) costs one extra
    copy and is flagged so the driver can raise the cap."""
    valid = last.pair_valid
    over = last.pair_overlap
    keep = valid | (over > 0)                       # [N, K]
    flat = keep.reshape(-1)
    sel = _compact_positions(flat, cap)
    ok = sel >= 0
    sel_c = torch.clamp(sel, min=0)
    dt = last.pair_px.dtype

    def g(a):
        return a.reshape(-1)[sel_c].to(dt)

    rows = torch.stack([
        torch.where(ok, sel_c, torch.full_like(sel_c, -1)).to(dt),
        g(last.pair_px), g(last.pair_py),
        g(last.pair_fx), g(last.pair_fy),
        g(last.pair_overlap),
        g(last.nbr_idx),
        g(last.pair_valid),
    ], dim=1)                                       # [cap, 8]
    count = torch.sum(flat.to(torch.int64))
    bc = last.boundary_contact.to(dt)               # [N]
    return rows.reshape(-1), count, bc


def _unpack_aux_compact(vals: np.ndarray, bc: np.ndarray, n: int, k: int):
    """Dense [N, K] aux tables from the compacted entries."""
    from types import SimpleNamespace

    rows = vals.reshape(-1, 8)
    ok = rows[:, 0] >= 0
    flat_idx = rows[ok, 0].astype(np.int64)
    ii = flat_idx // k
    kk_ = flat_idx % k

    def dense(col, dtype=np.float64):
        a = np.zeros((n, k), dtype)
        a[ii, kk_] = rows[ok, col]
        return a

    return SimpleNamespace(
        pair_valid=dense(7) != 0,
        pair_px=dense(1), pair_py=dense(2),
        pair_fx=dense(3), pair_fy=dense(4),
        pair_overlap=dense(5),
        nbr_idx=dense(6).astype(np.int32),
        boundary_contact=bc != 0,
    )


def _pack_aux_last(last: StepAux) -> torch.Tensor:
    """The lifecycle's last-step aux fields as ONE [N, K*7+1] tensor."""
    dt = last.pair_px.dtype
    main = torch.stack([
        last.pair_valid.to(dt), last.pair_px, last.pair_py,
        last.pair_fx, last.pair_fy, last.pair_overlap,
        last.nbr_idx.to(dt),
    ], dim=-1)                                        # [N, K, 7]
    bc = last.boundary_contact.to(dt)[:, None]
    return torch.cat([main.reshape(main.shape[0], -1), bc], dim=1)


def _unpack_aux(packed: np.ndarray):
    from types import SimpleNamespace

    n = packed.shape[0]
    k = (packed.shape[1] - 1) // 7
    main = packed[:, :-1].reshape(n, k, 7)
    return SimpleNamespace(
        pair_valid=main[..., 0] != 0,
        pair_px=main[..., 1], pair_py=main[..., 2],
        pair_fx=main[..., 3], pair_fy=main[..., 4],
        pair_overlap=main[..., 5],
        nbr_idx=main[..., 6].astype(np.int32),
        boundary_contact=packed[:, -1] != 0,
    )


def _pack_merges(auxes: ChunkAux) -> torch.Tensor:
    """merge_i + nbr_idx over the whole chunk as ONE [c, N, K, 2] tensor."""
    dt = auxes.last.pair_px.dtype
    return torch.stack([auxes.merge_i.to(dt), auxes.nbr_idx.to(dt)], dim=-1)


def _pad_domain(rect: np.ndarray, v_cap: int = 8):
    from .geometry.polygon import pad_polygon

    return pad_polygon(rect, v_cap)


def _ladder_k(need: int) -> int:
    """Smallest rung of the geometric ladder 8, 13, 20, 31, 47, 71, ... at
    or above ``need`` — all pool resizes land on this shared ladder."""
    v = 8
    while v < need:
        v = int(v * 1.5) + 1
    return v


def _ladder_v(need: int, cap: int) -> int:
    """Vertex-rung ladder 8, 16, 24, 32, 48, 64, 96, ... clipped to the
    max_verts fidelity cap; a need above the cap returns the cap (births
    are then truncated there — exactly the static-cap semantics)."""
    v = 8
    while v < need:
        v = v + 8 if v < 32 else v + 16
    return min(v, cap)


def _resize_verts(state: FloeState, new_v: int) -> FloeState:
    """Slice or widen the vertex axis.  The pad-with-vertex-0 convention
    (geometry/polygon.py pad_polygon) makes both directions exact: every
    slot at or beyond ``nv`` holds vertex 0, so slicing above the max live
    nv drops only degenerate padding and widening appends more of it."""
    vb = state.verts_body
    if new_v < vb.shape[1]:
        vb = vb[:, :new_v].contiguous()
    elif new_v > vb.shape[1]:
        pad = vb[:, :1].expand(vb.shape[0], new_v - vb.shape[1], 2)
        vb = torch.cat([vb, pad], dim=1)
    return state.replace(verts_body=vb)


def _pool_slots(need: int) -> int:
    """Power-of-two pool size >= need (min 128), same rationale."""
    v = 128
    while v < need:
        v *= 2
    return v


def out_of_box_sim(seed: int = 0, n_floes: int = 10, device=None,
                   dtype=None) -> Simulation:
    """The reference's out-of-box configuration: ~10 Voronoi floes in a
    +-1e5 m box over the 4-gyre ocean, dt=10 s, collisions + corners only
    (README.md 'Running your first model'; Subzero.m:6-36).  On ``device``
    (CUDA unless the caller names another); ``dtype`` overrides the
    config's float32."""
    from .config import CapacityConfig, NumericsConfig
    from .init import initial_state

    # per-region pool and floe capacity auto-size from demand
    # (ContactConfig.region_pool_auto / Simulation._grow_floes): start lean
    cfg = SimConfig(capacity=CapacityConfig(max_floes=max(4 * n_floes, 16)),
                    numerics=NumericsConfig(dtype=dtype or "float32"))
    state, modulus = initial_state(cfg, 1.0, n_floes, 0.25, seed=seed,
                                   device=device)
    forcing = gyre_ocean(device=device)
    return Simulation(cfg=cfg, state=state, forcing=forcing, modulus=modulus)
