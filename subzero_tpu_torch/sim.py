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
the AVERAGE window and one for the summary.  What crosses to the host, and
how it is packed, is ``chunk_io.py``'s.  Nothing here writes into a
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
from .chunk_io import (
    ChunkAux, Summary, chunk_merge_pairs, fetch_boundary, gather_chunk,
    read_summary, summary_vector,
)
from .dynamics.step import domain_polygon, physics_step
from .forcing import Forcing, gyre_ocean
from .state import FloeState
from .trace import Table, count, recording, span, sync

__all__ = ["Simulation", "out_of_box_sim", "chunk_merge_pairs"]


def run_state_defaults() -> dict:
    """The driver's run state with its value before the first chunk: what
    a run carries from chunk to chunk besides the dataclass fields and the
    lifecycle.  A rebuild keeps it; a copy of a run copies every name."""
    return {
        "_verts_fit": False,       # the vertex rung fitted (_fit_verts)
        "_aux_cap": 512,           # the boundary fetch's contact-entry pool
        "_demand_win": [],         # pool demand per chunk (shrink window)
        "_vd_tend": None,          # dissolved-advection AB2 tendency
        "_eul_acc": None,          # AVERAGE accumulator and its step count
        "_eul_n": 0,
        "_mass_series": None,      # the outputs' total-mass series
        "_metrics": None,          # metrics_history
        "_rov_warned": False,      # per-region pool overflow reported
        "region_overflow_steps": 0,
        "region_pool_need_max": 0,
    }


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
        """The first call declares the run state and the lifecycle; every
        call, the first included, rebuilds from ``cfg`` and ``state``
        (:meth:`_rebuild`), so a later call after ``sim.cfg = ...`` keeps
        the run state."""
        if "lifecycle" not in self.__dict__:
            from .processes.lifecycle import Lifecycle

            self.__dict__.update(run_state_defaults())
            # lifecycle orchestrator (host-side topology surgery), one for
            # the run: its RNG and ledgers carry across rebuilds
            self.lifecycle = Lifecycle(self.cfg, None, seed=self.seed + 1)
            self.lifecycle.grow_fn = self._grow_floes
        self._rebuild()

    def _rebuild(self) -> None:
        """Build the step, domain and chunk from ``cfg`` and ``state``, and
        bring the lifecycle's config-derived fields up to date."""
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
        from .forcing import thermo_params

        _, pack_h0 = thermo_params(
            self.cfg.numerics.dt, self.cfg.processes.n_pack,
            k=self.cfg.physics.k_thermal, t_air=self.cfg.physics.t_air,
            t_ocean=self.cfg.physics.t_ocean,
            rho_ice=self.cfg.physics.rho_ice,
            latent=self.cfg.physics.latent_heat,
        )
        lc = self.lifecycle
        lc.cfg = self.cfg
        lc.domain_poly = domain_polygon(self.cfg, device="cpu").to(
            torch.float64).numpy()[:4]
        lc.pack_h0 = pack_h0 if self.heat_flux < 0 else 0.0
        lc.pack_target = self.pack_target
        lc.nx, lc.ny = self.nx_coarse, self.ny_coarse
        areas = self.state.area[self.state.alive].cpu().numpy()
        if len(areas) and (lc.amax is None
                           or float(areas.max()) > lc.amax):
            # the weld pyramid cap only ever grows (Subzero.m:321-323)
            lc.amax = float(areas.max())
        # growth only under verts_auto: a pinned active_verts with
        # verts_auto=False is an explicit static rung (births truncate
        # there, like a static max_verts=rung build)
        lc.grow_verts_fn = (
            self._grow_verts if self.cfg.capacity.verts_auto else None)
        # The domain above is the static cfg box: forget the wall cache and
        # rebuild the moved domain now so the next chunk (including the
        # re-run of an overflowed chunk) doesn't silently run against
        # unmoved walls until the next wall_cadence change.
        self._wall_now = None
        if self.wall_fn is not None:
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
        accumulation).  The returned ``summary`` is ONE small tensor
        (``chunk_io.summary_vector``), so the host pays a single
        device->host copy per chunk.  The inputs are never written.
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
        auxes, exported, n_exported = [], [], []
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
            nexp_i = torch.sum(aux.exported)
            if mesh is not None:
                # this rank's kills: one sum over the mesh for all three
                both = mesh.psum(torch.cat([grid.reshape(-1).to(sdt),
                                            exp_i[None].to(sdt),
                                            nexp_i[None].to(sdt)]))
                grid = both[:-2].reshape(grid.shape)
                exp_i, nexp_i = both[-2], both[-1]
            dissolved = dissolved + grid
            exported.append(exp_i)
            n_exported.append(nexp_i)
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
        summary = summary_vector(chunk, state, exported, n_exported,
                                 self._chunk, cfg, sdt, mesh)
        return state, dissolved, vd_tend, eul_acc, chunk, summary

    def _grow_pools(self, s: Summary) -> bool:
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
        need, pp_need = s.region_pool_need, s.pair_pool_need
        grew = False
        cfg = self.cfg
        if s.pair_pool_overflow and cfg.contact.pair_pool \
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
        if s.region_overflow and cfg.contact.region_pair_frac < 1.0:
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
        if s.nbr_overflow:
            k = cfg.capacity.max_neighbors
            new_k = min(_ladder_k(max(int(s.nbr_demand * 1.1) + 1, k + 1)),
                        self.state.n)
            if new_k > k:
                print(f"[sim] step {self.step_idx}: broad-phase candidate "
                      f"demand {s.nbr_demand} — growing max_neighbors "
                      f"{k} -> {new_k} and re-running the chunk")
                cfg = cfg.replace(capacity=dc.replace(
                    cfg.capacity, max_neighbors=new_k))
                grew = True
        if grew:
            self.cfg = cfg
            self._rebuild()
        return grew

    # window (in chunks) over which pool demand maxima are taken before a
    # shrink; long enough that a periodic lifecycle spike stays in view
    _SHRINK_WINDOW = 64

    def _maybe_shrink_pools(self, s: Summary) -> None:
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
        win = self._demand_win
        # fold in this boundary's birth vertex need: the chunk summaries
        # predate the lifecycle's births, so without it a window that fills
        # at this boundary could shrink the rung below a floe born moments
        # ago (silent geometry truncation, nv > v_cap)
        birth_nv = self.lifecycle.last_birth_nv
        self.lifecycle.last_birth_nv = 0
        win.append((s.region_pool_need, s.nbr_demand, s.pair_pool_need,
                    max(s.max_nv, birth_nv)))
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
            self._rebuild()

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
            self._rebuild()   # syncs cfg.active_verts

    def _update_walls(self) -> None:
        """Moving walls (uniaxial case): rebuild the domain polygon only
        when the wall position actually changed (it moves every
        ``wall_cadence`` steps)."""
        lx, ly = self.wall_fn(self.step_idx)
        if self._wall_now == (lx, ly):
            return
        self._wall_now = (lx, ly)
        from .geometry.polygon import pad_polygon

        dom_np = np.array([[-lx, -ly], [lx, -ly], [lx, ly], [-lx, ly]])
        pad, _ = pad_polygon(dom_np, 8)
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
        if self.cfg.capacity.verts_auto and not self._verts_fit:
            self._verts_fit = True
            self._fit_verts()
        if self.cfg is not self._built_cfg:
            # cfg was replaced after construction: rebuild (the run state
            # and the lifecycle are kept)
            self._rebuild()
        if not self._chunk_frozen:
            # wall_fn / output_dir may be attached after construction:
            # re-derive the chunk once, before the first chunk
            self._chunk = self._pick_chunk()
            self._chunk_frozen = True
        dt_ = self.state.x.dtype
        dev = self.state.device
        dissolved = torch.as_tensor(self.dissolved, dtype=dt_, device=dev)
        vd_tend = self._vd_tend
        if self.cfg.processes.advect_dissolved:
            if vd_tend is None:
                vd_tend = torch.zeros_like(dissolved)
        else:
            vd_tend = None
        eul_acc = self._eul_acc
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
                        vec = summary.cpu().numpy()
                    s = read_summary(vec)
                    # a capacity pool overflowed: the step ran with
                    # degraded physics (aggregate-contact fallback /
                    # dropped candidate contacts) — the cfg was grown and
                    # the step rebuilt; RE-RUN the chunk from the same
                    # inputs so no degraded step survives
                    if not self._grow_pools(s):
                        break
            count("contact.coast_pairs", s.coast_pairs)
            count("step.exported_floes", s.exported_floes)
            self.state, dissolved, vd_tend, eul_acc = st2, dis2, vd2, eul2
            self.step_idx += n
            done += n
            # device-side export kills (Nares below-ymin, out-of-domain,
            # boundary absorption) fold into the exported-mass ledger
            self.lifecycle.exported_mass += s.exported_mass
            if eul_acc is not None:
                self._eul_n += n
            # host-side lifecycle at the chunk boundary — only when due
            if s.merge_any or self.lifecycle.any_due(self.step_idx,
                                                     s.hints):
                # ONE combined device->host copy for the whole boundary
                b = fetch_boundary(self.state, auxes, dissolved,
                                   self._aux_cap, s.merge_any, self.mesh)
                self._aux_cap = b.aux_cap
                with span("lifecycle"):
                    self.state, dis_np, changed = self.lifecycle.step(
                        self.state, b.aux, self.step_idx, b.dissolved,
                        merge_pairs=b.merge_pairs, hints=s.hints,
                        view=b.view,
                    )
                with span("rebuild"):
                    if self.cfg is not self._built_cfg:
                        # the lifecycle grew the floe capacity or the
                        # vertex rung: rebuild (which rebalances a mesh's
                        # slabs with the new cfg itself)
                        self._rebuild()
                    elif changed and self.mesh is not None:
                        self.state = self._reshard(self.state)
                dissolved = torch.as_tensor(dis_np, dtype=dt_, device=dev)
                self.dissolved = dis_np
            # Surface per-region pool overflow: those steps fell back to
            # aggregate contacts (physics degradation — raise
            # ContactConfig.region_pair_frac if this keeps firing).
            self.region_pool_need_max = max(self.region_pool_need_max,
                                            s.region_pool_need)
            if s.region_overflow:
                self.region_overflow_steps += s.region_overflow
                if not self._rov_warned:
                    self._rov_warned = True
                    print(
                        f"[sim] WARNING step {self.step_idx}: per-region "
                        f"pool overflow — {s.region_overflow} step(s) fell "
                        "back to aggregate contacts (raise ContactConfig."
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
                         else gather_chunk(auxes, self.mesh))
            if log_every and (self.step_idx % log_every == 0):
                self.record_metrics(s.n_collisions)
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
                    and self._eul_n > 0:
                eul_acc = self._zero_eul()
                self._eul_n = 0
                self._eul_acc = None
            return eul_acc
        out = Path(self.output_dir)
        snap = out / f"snap{self.step_idx:07d}"
        if (self.cfg.processes.average and eul_acc is not None
                and self._eul_n > 0):
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
        series = self._mass_series
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
        if self._metrics is None:
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
                "region_overflow_steps": self.region_overflow_steps,
                "region_pool_need_max": self.region_pool_need_max,
                # two-way auto-sizing window: persisted so a resumed run's
                # shrink timing matches the straight run's
                "demand_win": [list(map(int, w)) for w in self._demand_win],
            },
            "metrics": self._metrics,
        }
        (path / "meta.json").write_text(json.dumps(meta, indent=1))
        np.save(path / "dissolved.npy", self.dissolved)
        # AVERAGE accumulator (partial output interval) + dissolved-advection
        # AB2 tendency
        acc = self._eul_acc
        if acc is not None and self._eul_n:
            np.savez_compressed(path / "eul_acc.npz", _eul_n=self._eul_n,
                                **{k: v.cpu().numpy() for k, v in
                                   sorted(acc._asdict().items())})
        tend = self._vd_tend
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


def _pack_state(state: FloeState) -> torch.Tensor:
    """All state fields flattened into ONE [N, F] tensor (single
    device->host copy for checkpoints)."""
    n = state.n
    dt = state.x.dtype
    return torch.cat([
        getattr(state, f.name).to(dt).reshape(n, -1)
        for f in dataclasses.fields(state)
    ], dim=1)


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
