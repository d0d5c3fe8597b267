"""Lifecycle orchestrator: applies the process passes at their cadences.

This is the host-side half of the reference driver loop (Subzero.m:151-378):
the device runs chunks of physics steps; at chunk boundaries this module
fires whichever processes are due, performs the topology surgery with the
native engine, and scatters the edits back into the device state.

Cadence map (Subzero.m):
  :169  every n_simplify=20   FloeSimplify (vertex cap 30)
  :275  every n_pack=500      create_new_ice (PACKING && freezing)
  inline (floe_interactions_all.m:288-465, every doInt step)
                              ridging / rafting
  :317  every 25/500/5000     weld at 3x3 / 2x2 / 1x1 pyramid scales
  :333  every n_fracture=75   Mohr-Coulomb fracture
  :339  every n_corners=10    corner grinding on ~30% random floes
  :366  every step            kill floes below min_floe_size
plus the overlap>0.55 merge kills flagged by the contact pass
(floe_interactions_all.m:470-501: area>2e4 -> fuse into partner, else
dissolve).

The port's copy of ``subzero_tpu/processes/lifecycle.py``: the passes and
their order are the JAX package's; the shadow ledger reads (alive, mass)
back with one ``.cpu()`` and the packing's coverage comes from the
port's diagnostics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..state import FloeState
from ..trace import Table, count, recording, span
from .corners import corners_pass
from .fracture import fracture_pass
from .fuse import fuse_floes
from .host import StateEdit, apply_edits, extract_view
from .pack import pack_pass
from .ridge_raft import ridge_raft_pass
from .simplify import simplify_pass
from .weld import weld_pass, weld_schedule


def capacity_guard(edit: StateEdit, alive: np.ndarray, cfg: SimConfig,
                   step_idx: int) -> float:
    """Trim births that exceed the free-slot budget.

    Fixed-capacity pools (SURVEY.md §5 scale-axis handling) can run out of
    slots during a fracture burst; the reference's MATLAB arrays grow without
    bound (fracture.m:51-55 appends children freely).  Keep the most massive
    new floes and bin the remainder into ``edit.dissolve_mass`` so the mass
    ledger stays closed instead of aborting the run.  Returns the kg
    dissolved (0.0 when nothing was trimmed).
    """
    if not edit.new_floes:
        return 0.0
    freed = edit.kills | edit.dissolve_kills
    n_free = sum(
        1 for i in range(cfg.n_boundary, len(alive))
        if (not alive[i]) or i in freed)
    if len(edit.new_floes) <= n_free:
        return 0.0
    from .. import hostgeom as hg

    def _mass(f) -> float:
        if f.mass is not None:
            return float(f.mass)
        return float(cfg.physics.rho_ice * f.h
                     * abs(hg.area(np.asarray(f.poly))))

    order = sorted(range(len(edit.new_floes)),
                   key=lambda k: _mass(edit.new_floes[k]), reverse=True)
    keep = set(order[:n_free])
    dropped = [f for k, f in enumerate(edit.new_floes) if k not in keep]
    edit.new_floes = [f for k, f in enumerate(edit.new_floes) if k in keep]
    lost = 0.0
    for f in dropped:
        c = hg.centroid(np.asarray(f.poly))
        m = _mass(f)
        edit.dissolve_mass.append((float(c[0]), float(c[1]), m))
        lost += m
    print(f"[lifecycle] WARNING step {step_idx}: floe capacity exhausted — "
          f"{len(dropped)} smallest of {len(dropped) + n_free} births "
          f"dissolved ({lost:.3e} kg; raise CapacityConfig.max_floes)")
    return lost


class Lifecycle:
    """Stateful orchestrator bound to one simulation run."""

    def __init__(self, cfg: SimConfig, domain_poly: np.ndarray,
                 seed: int = 0, amax: float | None = None,
                 pack_h0: float = 0.0, pack_target: float = 1.0,
                 nx: int = 10, ny: int = 10):
        self.cfg = cfg
        self.domain_poly = domain_poly
        self.rng = np.random.default_rng(seed)
        self.amax = amax          # max initial floe area (weld pyramid cap)
        self.pack_h0 = pack_h0
        self.pack_target = pack_target
        self.nx = nx
        self.ny = ny
        # mass pushed out of the domain by boundary ridging (ridge.m:79,110):
        # exported, not dissolved — tracked so the total ledger
        # floes + dissolved + exported stays closed
        self.exported_mass = 0.0
        # optional capacity-growth hook (state, need_slots) -> grown state:
        # when set, a birth burst grows the floe pool instead of the
        # capacity guard dissolving the smallest births (the reference's
        # arrays grow unbounded, fracture.m:51-55)
        self.grow_fn = None
        # optional vertex-rung growth hook (state, need_verts) -> state with
        # a wider vertex axis: a birth whose polygon exceeds the state's
        # current (auto-shrunk) vertex rung widens the arrays up to the
        # max_verts fidelity bound instead of being truncated below it
        self.grow_verts_fn = None
        # f64 shadow ledger: when True, every lifecycle invocation checks
        # (floes + dissolved + exported) in float64 before vs after its
        # edits and accumulates the drift — the instrument that pins which
        # pass leaks mass (round-3 uniaxial +0.13% residual investigation).
        self.shadow_ledger = False
        self.ledger_drift = 0.0
        self.ledger_drift_max = 0.0
        # the widest birth of the current boundary (vertices): the floor
        # of the driver's windowed rung shrink, which consumes it
        self.last_birth_nv = 0

    @property
    def pass_times(self) -> Table:
        """Host seconds by pass (a :class:`trace.Table`): extract_view,
        merges, ridge, raft, fracture, corners, weld, simplify, pack,
        apply_edits; with the counts ``<pass>.slots`` and
        ``apply_edits.slots``.  Deleting the attribute starts an empty
        table."""
        table = self.__dict__.get("pass_times")
        if table is None:
            table = self.__dict__["pass_times"] = Table()
        return table

    @pass_times.setter
    def pass_times(self, table: Table) -> None:
        self.__dict__["pass_times"] = table

    # ------------------------------------------------------------------

    def dues(self, step_idx: int, hints: "dict | None" = None) -> dict:
        """Which process passes are due at this chunk boundary.

        ``hints``: cheap device-derived facts about the current state that
        let a pass be skipped WITHOUT pulling the state to the host (the
        skip is exact — a gated-out pass could not have changed anything):

          any_oversize      a live floe exceeds simplify_max_verts
                            (FloeSimplify only fires on >30-vertex floes,
                            Subzero.m:185)
          any_contact       any contact force or boundary touch in the last
                            step (corner breaks require a vertex in contact,
                            corners.m:69-91)
          any_pair_overlap  any nonzero overlap area in the last step
                            (ridge/raft gates require overlap,
                            floe_interactions_all.m:291-327)
        """
        cfg = self.cfg
        proc = cfg.processes
        due = lambda k: k > 0 and step_idx % k == 0  # noqa: E731
        h = hints or {}
        any_ov = bool(h.get("any_pair_overlap", True))
        return {
            "ridge": proc.ridging and due(proc.n_ocean_force) and any_ov,
            "raft": proc.rafting and due(proc.n_ocean_force) and any_ov,
            "frac": proc.fractures and due(proc.n_fracture),
            "corner": (proc.corners and due(proc.n_corners)
                       and bool(h.get("any_contact", True))),
            "simp": (due(proc.n_simplify)
                     and bool(h.get("any_oversize", True))),
            "pack": proc.packing and due(proc.n_pack) and self.pack_h0 > 0,
            "weld": (proc.welding and self.amax is not None
                     and weld_schedule(step_idx, cfg, self.amax)) or None,
        }

    def any_due(self, step_idx: int, hints: "dict | None" = None) -> bool:
        return any(self.dues(step_idx, hints).values())

    def step(self, state: FloeState, aux, step_idx: int,
             dissolved: np.ndarray,
             merge_pairs: "list[tuple[int, int]] | None" = None,
             hints: "dict | None" = None,
             view=None,
             ) -> tuple[FloeState, np.ndarray, bool]:
        """Fire all due processes; returns (new_state, dissolved_grid,
        changed).  ``merge_pairs``: (absorbee, partner) overlap>0.55 pairs
        OR'd across the whole device chunk (each resolved against its own
        step's neighbor table); when None they are derived from ``aux``
        (last step only)."""
        dues = self.dues(step_idx, hints)
        # (the every-step small-floe cull runs device-side in physics_step)
        if merge_pairs is None and aux is not None:
            merge_i = np.asarray(aux.merge_i)
            if merge_i.any():
                nbr = np.asarray(aux.nbr_idx)
                merge_pairs = [
                    (int(i), int(nbr[i, k]))
                    for i, k in zip(*np.nonzero(merge_i))
                ]
        if not (merge_pairs or any(dues.values())):
            return state, dissolved, False

        with recording(self.pass_times):
            return self._fire(state, aux, step_idx, dissolved, merge_pairs,
                              view, dues)

    def _fire(self, state, aux, step_idx, dissolved, merge_pairs, view,
              dues):
        """:meth:`step`'s passes, inside the recording of ``pass_times``:
        each pass's host seconds under its name, and the slots its edit
        touches as the count ``<pass>.slots``; ``apply_edits.slots``
        counts the slots written back."""
        cfg = self.cfg
        if view is None:
            with span("extract_view"):
                view = extract_view(state, cfg)
        if self.shadow_ledger:
            m_in = float(np.sum(view.fields["mass"][view.alive],
                                dtype=np.float64))
            dis_in = float(np.sum(dissolved, dtype=np.float64))
            exp_in = self.exported_mass
        edit = StateEdit()
        boundary_polys = [view.poly(i) for i in range(cfg.n_boundary)
                          if view.polys[i] is not None]

        def merge(name, sub):
            count(name + ".slots", sub.n_slots)
            edit.merge(sub)

        # ---- contact-flagged merges (floe_interactions_all.m:470-501) ----
        if merge_pairs:
            with span("merges"):
                self._merges_from_pairs(view, merge_pairs, edit)
            count("merges.slots", edit.n_slots)

        for kind in ("ridge", "raft"):
            if dues[kind]:
                with span(kind):
                    sub = self._guarded(
                        view, edit, lambda v: ridge_raft_pass(
                            v, cfg, self.rng, kind, self.domain_poly))
                merge(kind, sub)

        if dues["frac"]:
            with span("fracture"):
                deform = self._deform_info(view, aux)
                sub = self._guarded(
                    view, edit,
                    lambda v: fracture_pass(v, cfg, self.rng, deform))
            merge("fracture", sub)

        if dues["corner"] and aux is not None:
            with span("corners"):
                sub = self._guarded(
                    view, edit, lambda v: self._corners(v, aux))
            merge("corners", sub)

        weld_due = dues["weld"]
        if weld_due:
            with span("weld"):
                # running Amax update (Subzero.m:321-323)
                cur_max = float(np.max(np.where(view.alive, view.area,
                                                0.0)))
                if cur_max > self.amax:
                    self.amax = cur_max
                    weld_due = weld_schedule(step_idx, cfg, self.amax)
                wnx, wny, wmax = weld_due
                sub = self._guarded(view, edit, lambda v: weld_pass(
                    v, cfg, self.rng, wnx, wny, wmax))
            merge("weld", sub)

        if dues["simp"]:
            with span("simplify"):
                sub = self._guarded(
                    view, edit,
                    lambda v: simplify_pass(v, cfg, boundary_polys))
            merge("simplify", sub)

        if dues["pack"]:
            # coverage from the device floe->cell clip (row 0 = north):
            # skips the per-(cell, floe) native concentration loop
            from ..diagnostics import coverage_fraction

            with span("pack"):
                conc = coverage_fraction(state, cfg, self.nx, self.ny)
                sub = self._guarded(view, edit, lambda v: pack_pass(
                    v, cfg, self.rng, self.pack_h0, self.pack_target,
                    self.nx, self.ny, conc=conc))
            merge("pack", sub)

        # ---- capacity growth, then guard ----------------------------------
        # vertex-rung growth first: a birth polygon wider than the current
        # (auto-shrunk) vertex rung widens the arrays up to the max_verts
        # fidelity bound, so truncation semantics stay exactly those of a
        # static max_verts build.  last_birth_nv is ALWAYS recorded: the
        # driver's windowed rung shrink folds it in so a birth at this very
        # boundary (absent from the chunk summaries, which predate it) can
        # never be sliced below its vertex count.
        if edit.new_floes or edit.reshapes:
            vfid = cfg.capacity.max_verts
            need_v = 0
            for f in edit.new_floes:
                need_v = max(need_v, min(len(np.asarray(f.poly)), vfid))
            for poly, _ in edit.reshapes.values():
                need_v = max(need_v, min(len(np.asarray(poly)), vfid))
            self.last_birth_nv = max(self.last_birth_nv, need_v)
            if need_v > state.v_cap and self.grow_verts_fn is not None:
                state = self.grow_verts_fn(state, need_v)
                cfg = self.cfg  # the hook replaces the shared config
        alive_now = view.alive
        if edit.new_floes and self.grow_fn is not None:
            freed = edit.kills | edit.dissolve_kills
            n_free = sum(
                1 for i in range(cfg.n_boundary, len(alive_now))
                if (not alive_now[i]) or i in freed)
            if len(edit.new_floes) > n_free:
                need = len(alive_now) + len(edit.new_floes) - n_free
                state = self.grow_fn(state, need)
                alive_now = np.concatenate([
                    alive_now,
                    np.zeros(state.n - len(alive_now), bool)])
        capacity_guard(edit, alive_now, cfg, step_idx)

        # ---- dissolved-mass bookkeeping ----------------------------------
        for i in edit.dissolve_kills:
            dissolved = self._bin_mass(dissolved, view.x[i], view.y[i],
                                       view.mass[i])
        for mx, my, m in edit.dissolve_mass:
            dissolved = self._bin_mass(dissolved, mx, my, m)
        self.exported_mass += edit.export_mass

        changed = bool(edit.kills or edit.dissolve_kills or edit.new_floes
                       or edit.updates or edit.reshapes)
        with span("apply_edits"):
            state = apply_edits(state, edit, cfg,
                                seed=int(self.rng.integers(2**31)),
                                view=view)
        count("apply_edits.slots", edit.n_slots)
        if self.shadow_ledger:
            with span("shadow_fetch"):
                am = torch.stack([state.alive.to(state.mass.dtype),
                                  state.mass]).cpu().numpy()
            alive2, mass2 = am[0] != 0, am[1]
            m_out = float(np.sum(mass2[alive2], dtype=np.float64))
            dis_out = float(np.sum(dissolved, dtype=np.float64))
            drift = ((m_out + dis_out + self.exported_mass)
                     - (m_in + dis_in + exp_in))
            self.ledger_drift += drift
            if abs(drift) > abs(self.ledger_drift_max):
                self.ledger_drift_max = drift
            if abs(drift) > 1e-6 * max(m_in, 1.0):
                print(f"[ledger] step {step_idx}: lifecycle drift "
                      f"{drift:+.3e} kg ({drift / max(m_in, 1.0):+.2e} "
                      f"rel) — passes: merge={bool(merge_pairs)} "
                      f"ridge={dues['ridge']} raft={dues['raft']} "
                      f"frac={dues['frac']} corner={dues['corner']} "
                      f"simp={dues['simp']} pack={dues['pack']} "
                      f"weld={bool(dues['weld'])}")
        return state, dissolved, changed

    # ------------------------------------------------------------------

    def _guarded(self, view, edit: StateEdit, fn) -> StateEdit:
        """Run a pass with slots already touched by earlier edits hidden."""
        touched = edit.kills | edit.dissolve_kills | set(edit.reshapes)
        if not touched:
            return fn(view)
        with view.masked(dead_slots=touched):
            return fn(view)

    def _merges_from_pairs(self, view, pairs, edit: StateEdit) -> None:
        """overlap>0.55 fusion kills: the flagged floe is absorbed into its
        partner when large enough, else dissolved."""
        cfg = self.cfg
        done: set[int] = set()
        for i, j in pairs:
            if i in done or j in done:
                continue
            if not (view.alive[i] and view.alive[j]):
                continue
            if i < cfg.n_boundary:
                continue
            if view.area[i] > cfg.processes.fuse_min_area:
                sub = fuse_floes(view, j, [i], cfg)
                edit.merge(sub)
                done |= {i, j}
            else:
                edit.dissolve_kills.add(i)
                done.add(i)

    def _deform_info(self, view, aux):
        """Deepest-overlap contact per floe for fracture's plastic clip."""
        if aux is None:
            return None
        ov = np.asarray(aux.pair_overlap)
        nbr = np.asarray(aux.nbr_idx)
        fx = np.asarray(aux.pair_fx)
        fy = np.asarray(aux.pair_fy)
        k = np.argmax(ov, axis=1)
        rows = np.arange(view.n)
        hit = np.nonzero(ov[rows, k] > 0)[0]
        return {int(i): (int(nbr[i, k[i]]),
                         float(fx[i, k[i]]), float(fy[i, k[i]]))
                for i in hit}

    def _corners(self, view, aux) -> StateEdit:
        """Driver-level corner selection (Subzero.m:339-352): ~30% random
        floes, skipping heavily-overlapped ones, then the grinding pass."""
        cfg = self.cfg
        keep = self.rng.random(view.n) > cfg.processes.corner_keep_prob
        ov_frac = view.overlap_area / np.maximum(view.area, 1e-12)
        eligible = keep & (ov_frac < cfg.processes.corner_max_overlap)

        valid = np.asarray(aux.pair_valid)
        px = np.asarray(aux.pair_px)
        py = np.asarray(aux.pair_py)
        nbr = np.asarray(aux.nbr_idx)
        bnd = np.asarray(aux.boundary_contact)

        contact_points = {}
        contact_nbrs = {}
        # iterate only the eligible floes that actually have a contact —
        # the all-N Python loop dominated fracture-storm campaigns
        for i in np.nonzero(eligible & valid.any(axis=1))[0]:
            ks = np.nonzero(valid[i])[0]
            contact_points[i] = np.stack([px[i, ks], py[i, ks]], axis=1)
            contact_nbrs[i] = [int(j) for j in nbr[i, ks]]
        touching = bnd & eligible
        with view.masked(keep_mask=eligible):
            return corners_pass(view, cfg, self.rng, contact_points,
                                contact_nbrs, touching, self.domain_poly)

    def _bin_mass(self, dissolved: np.ndarray, x: float, y: float,
                  mass: float) -> np.ndarray:
        ny, nx = dissolved.shape
        lx, ly = self.cfg.domain.lx, self.cfg.domain.ly
        ix = int(np.clip((x + lx) / (2 * lx / nx), 0, nx - 1))
        iy = int(np.clip((ly - y) / (2 * ly / ny), 0, ny - 1))
        dissolved = dissolved.copy()
        dissolved[iy, ix] += mass
        return dissolved
