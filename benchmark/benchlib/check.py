"""What decides ``correct``: the program's outputs from the timed path,
held against the plain reference (``benchmark/reference``).

During the timed segments a :class:`Recorder` keeps references (never
copies: the program writes into no tensor it was given) to what the timed
path produced: the state before and after the steps the check samples, and
the state, dissolved grid and exported mass on both sides of every
lifecycle boundary.  Each new segment starts a new record, so what is
judged is the last timed segment's.  After the window the reference
judges it:

* ``init.gap`` - the start: each floe's area, centroid and mass as the
  program built them from the benchmark's polygons, against the polygons.
* ``step.force_gap``, ``step.dv_gap`` - the physics step (broad phase,
  floe and wall contact, trajectory): the reference steps a sample of floes
  from the program's own state before each sampled step, and the
  program's contact force and torque and its velocity and spin increments
  are compared with the reference's, as relative L1 gaps over the sampled
  floes that carry a solid contact (see :func:`solid`);
  ``step.force_miss``, ``step.dv_miss``: the share of those floes whose
  force or increment is off by more than ``MISS`` of their contact forces
  (for float64 configurations, where a rare degenerate crossing sets the
  L1 gap and not the precision); ``step.pos_miss``: the share of moving
  coordinates whose position increment is off by more than two roundings;
  ``step.extra_solid`` (printed): the share of the sampled floes with no
  solid contact in the reference whose program force departs from it by
  more than the step's smallest solid contact force.
* ``life.slot_miss``, ``life.mass_gap`` - the lifecycle: at each boundary
  the reference (``reference/lifecycle.py``, the passes as frozen copies)
  runs the passes that are due on its own host view of the program's state
  before the boundary, with the lifecycle's generator as the boundary found
  it and the last step's contact tables, and applies the edits in numpy.
  ``life.slot_miss`` is the share of the slots that either side changed
  (killed, born, reshaped, updated) whose result misses the reference's:
  alive on one side only, or area, mass or centroid off by more than
  ``LIFE_MISS`` (the centroid beyond two roundings of its coordinate);
  ``life.mass_gap`` the largest relative gap between the program's total
  mass (floes, dissolved grid, exported) after a boundary and the
  reference's.
* ``ledger.gap`` - the driver's mass ledger: floe mass from the polygons
  plus dissolved plus exported mass, across each lifecycle boundary and,
  where the configuration has no thermodynamics, across the segment.
* ``state.mass_gap`` - every live floe of the segment's end state: its
  mass against rho h A of its own polygon.

``emulate`` computes the control: the reference in the program's place,
its inputs and outputs rounded to the precision below the
configuration's (``'bf16'`` for float32, ``'f32'`` for float64).
"""

from __future__ import annotations

import numpy as np

from reference.lifecycle import VIEW_FIELDS, boundary
from reference.mass import floe_masses, ledger_total, polygon_props
from reference.oracle import Grid, follow_step

STEP_FIELDS = (
    "verts_body", "nv", "alive", "x", "y", "alpha", "u", "v", "ksi", "h",
    "mass", "inertia", "area", "rmax", "dx_p", "dy_p", "dalpha_p", "du_p",
    "dv_p", "dksi_p", "mc_xy", "mc_in", "fx_oa", "fy_oa", "tq_oa",
    "overlap_area",
)
LEDGER_FIELDS = ("verts_body", "nv", "h", "alive", "mass")
LIFE_FIELDS = VIEW_FIELDS
POST_FIELDS = LEDGER_FIELDS + ("area", "x", "y")


def bf16(a):
    """Round float values to the nearest bfloat16 (8 significant bits),
    ties to even, returned as float64."""
    a32 = np.asarray(a, np.float32)
    bits = a32.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def f32(a):
    """Round float values to float32, returned as float64."""
    return np.asarray(a, np.float32).astype(np.float64)


# the control's precision: the nearest below the configuration's
LOWER = {"bf16": bf16, "f32": f32}


def refs(state, names) -> dict:
    return {k: getattr(state, k) for k in names}


def host(d: dict) -> dict:
    """Numpy copies of a dict of tensors (one copy per field)."""
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
            for k, v in d.items()}


class Recorder:
    """Keeps what the timed path produced, for the steps in ``steps``."""

    def __init__(self, steps):
        self.steps = set(int(s) for s in steps)
        self.active = False
        self.new_segment()

    def new_segment(self):
        self.captured: dict = {}
        self.boundaries: list = []

    def on_step(self, step_idx, state, out, aux, domain, modulus, heat_flux,
                cfg):
        if self.active and int(step_idx) in self.steps:
            self.captured[int(step_idx)] = dict(
                step=int(step_idx),
                pre=refs(state, STEP_FIELDS), post=refs(out, STEP_FIELDS),
                force=aux.collision_force, torque=aux.collision_torque,
                domain=domain, modulus=float(modulus),
                heat_flux=float(heat_flux), cfg=cfg)

    def on_boundary(self, step_idx, pre, post, found: dict):
        """``found``: what the lifecycle had before the boundary (its
        generator, running largest area, configuration, ...) and the
        driver's arguments; see ``reference/lifecycle.py``."""
        if self.active:
            self.boundaries.append(dict(
                found, step=int(step_idx), pre=refs(pre, LIFE_FIELDS),
                post=refs(post, POST_FIELDS),
                v_cap=int(pre.verts_body.shape[1])))


SOLID = 10.0
# a floe's force or velocity increment "misses" when it is off the
# reference's by more than this share of its contact forces' sum: far above
# float64 rounding (~1e-9 of it), far below float32's (~1e-3)
MISS = 1e-5


def solid(floe, cfg) -> bool:
    """Whether the reference gives ``floe`` a contact region of at least
    ``SOLID`` times its small-region cull (floe_interactions.m:79-83).

    Float32 contact carries errors of order one on sliver regions: where
    two floes share an edge, the sliver between them is as wide as the
    coordinates' rounding, so the float32 program finds sliver contacts
    near the cull where float64 finds none, or other ones.  The step is
    compared on the floes that carry a solid contact."""
    if not len(floe.interactions):
        return False
    a = np.asarray(floe.interactions, np.float64)
    cull = cfg.contact.small_region_coeff * len(floe.c0)
    return bool(np.max(a[:, 6]) >= SOLID * cull)


def sample_floes(pre: dict, k: int, rng, n_boundary: int) -> np.ndarray:
    """``k`` live floes drawn from the seed: half among those overlapping
    a neighbour before the step, the rest among all live floes."""
    live = np.flatnonzero(pre["alive"])
    live = live[live >= n_boundary]
    touching = live[np.asarray(pre["overlap_area"])[live] > 0]
    half = min(k // 2, len(touching))
    a = rng.choice(touching, half, replace=False) if half else np.zeros(0, int)
    rest = np.setdiff1d(live, a)
    b = rng.choice(rest, min(k - half, len(rest)), replace=False)
    return np.sort(np.concatenate([a, b]).astype(int))


def cfg_tree(cfg):
    """The program's configuration as plain nested namespaces."""
    import dataclasses
    from types import SimpleNamespace

    def ns(v):
        if isinstance(v, dict):
            return SimpleNamespace(**{k: ns(x) for k, x in v.items()})
        return v

    return ns(dataclasses.asdict(cfg))


def step_gaps(cap: dict, grid: Grid, walls, k: int, rng,
              emulate=None) -> dict:
    """The step numbers of one captured step (see the module docstring);
    ``walls`` gives the domain's half-widths (lx, ly) at a step."""
    pre = host(cap["pre"])
    post = host(cap["post"])
    dtype = post["x"].dtype             # the program's
    cfg = cfg_tree(cap["cfg"])
    step = cap["step"]
    lx, ly = walls(step)
    domain = np.array([[-lx, -ly], [lx, -ly], [lx, ly], [-lx, ly]], float)
    sample = sample_floes(pre, k, rng, cfg.n_boundary)
    ref = follow_step(pre, sample, grid, cfg, cap["modulus"], step,
                      cap["heat_flux"], domain)
    force_p = np.asarray(cap["force"].detach().cpu().numpy(), np.float64)
    torque_p = np.asarray(cap["torque"].detach().cpu().numpy(), np.float64)
    if emulate:
        # the reference in the program's place, in the lower precision
        low = LOWER[emulate]
        lo_pre = {k2: (low(v) if np.asarray(v).dtype.kind == "f" else v)
                  for k2, v in pre.items()}
        out = follow_step(lo_pre, sample, grid, cfg, cap["modulus"], step,
                          cap["heat_flux"], domain)
        for s in sample:
            force_p[s] = low(out[s].collision_force)
            torque_p[s] = low(out[s].collision_torque)
            for f in ("u", "v", "ksi", "x", "y"):
                post[f] = np.array(post[f], np.float64)
                post[f][s] = low(getattr(out[s], f))
            post["alive"] = np.array(post["alive"])
            post["alive"][s] = out[s].alive
    f64 = lambda a: float(np.asarray(a, np.float64))  # noqa: E731
    live = [s for s in sample if post["alive"][s] and ref[s].alive]
    keep = [s for s in live if solid(ref[s], cfg)]
    dt = float(cfg.numerics.dt)
    fd, fa, vd, va = [], [], [], []
    for s in keep:
        r = ref[s]
        a = np.asarray(r.interactions, np.float64)
        rm = max(r.rmax, 1.0)
        f_abs = float(np.sum(np.hypot(a[:, 1], a[:, 2])))
        t_abs = float(np.sum(np.abs(a[:, 5])))
        fd.append(np.linalg.norm(np.r_[force_p[s] - r.collision_force,
                                       (torque_p[s] - r.collision_torque)
                                       / rm]))
        fa.append(f_abs + t_abs / rm)
        dv_r = np.array([r.u - f64(pre["u"][s]), r.v - f64(pre["v"][s]),
                         (r.ksi - f64(pre["ksi"][s])) * rm])
        dv_p = np.array([f64(post[k][s]) - f64(pre[k][s])
                         for k in ("u", "v", "ksi")]) * np.array([1, 1, rm])
        vd.append(np.linalg.norm(dv_p - dv_r))
        va.append(1.5 * dt * (
            (f_abs + r.area * np.hypot(r.fx_oa, r.fy_oa)) / r.mass
            + (t_abs + r.area * abs(r.tq_oa)) / r.inertia * rm))
    # position increments: the AB2 update reads only the state before the
    # step, so the program's increment equals the reference's to a few
    # roundings of the position in its dtype; count the ones it misses
    miss = moving = 0
    for s in live:
        r = ref[s]
        for k, half in (("x", lx), ("y", ly)):
            xp, x0 = f64(post[k][s]), f64(pre[k][s])
            d_p, d_r = xp - x0, getattr(r, k) - x0
            if cfg.processes.periodic:
                d_p -= 2 * half * np.round(d_p / (2 * half))
                d_r -= 2 * half * np.round(d_r / (2 * half))
            ulp = float(np.spacing(np.asarray(abs(xp) + abs(x0), dtype)))
            if abs(d_r) > 4 * ulp:
                moving += 1
                miss += abs(d_p - d_r) > 2 * ulp + 1e-6 * abs(d_r)
    fd, fa, vd, va = map(np.asarray, (fd, fa, vd, va))
    # floes the comparison above leaves out (no solid contact in the
    # reference) whose program force departs from the reference's by more
    # than the smallest solid contact's force in the step: where a spurious
    # program overlap would show
    rest = [s for s in live if s not in keep]
    extra = 0
    if len(fa) and rest:
        for s in rest:
            r = ref[s]
            rm = max(r.rmax, 1.0)
            d = np.linalg.norm(np.r_[force_p[s] - r.collision_force,
                                     (torque_p[s] - r.collision_torque) / rm])
            extra += d > float(np.min(fa))
    n = max(len(keep), 1)
    return {"step.force_gap": _ratio(fd, fa), "step.dv_gap": _ratio(vd, va),
            "step.force_miss": float(np.sum(fd > MISS * fa)) / n,
            "step.dv_miss": float(np.sum(vd > MISS * va)) / n,
            "step.pos_miss": miss / moving if moving else 0.0,
            "step.extra_solid": extra / len(rest) if rest else 0.0,
            "n": len(keep), "moving": moving}


def _ratio(num, den) -> float:
    n = float(np.sum(num))
    if n == 0.0:
        return 0.0
    d = float(np.sum(den))
    return n / d if d > 0 else float("inf")


def _ledger_fields(d: dict, emulate=None) -> dict:
    h = host(d)
    if emulate:
        h = {k: (LOWER[emulate](v) if np.asarray(v).dtype.kind == "f" else v)
             for k, v in h.items()}
    return h


def ledger_gaps(rec: Recorder, start: dict, end: dict, rho: float,
                conserved: bool, emulate=None) -> float:
    """Largest relative ledger gap over the segment's lifecycle boundaries
    and, where ``conserved``, over the whole segment (``start``/``end``:
    fields plus ``dissolved`` and ``exported``)."""
    gaps = []

    def total(f, dis, exp):
        return ledger_total(f["verts_body"], f["nv"], f["h"], f["alive"],
                            rho, dis, exp)

    for b in rec.boundaries:
        t_in = total(_ledger_fields(
            {k: b["pre"][k] for k in LEDGER_FIELDS}, emulate),
            np.sum(b["dis_in"], dtype=np.float64), b["exp_in"])
        t_out = total(_ledger_fields(
            {k: b["post"][k] for k in LEDGER_FIELDS}, emulate),
            np.sum(b["dis_out"], dtype=np.float64), b["exp_out"])
        gaps.append(abs(t_out - t_in) / t_in)
    if conserved:
        t0 = total(_ledger_fields(start["fields"], emulate),
                   start["dissolved"], start["exported"])
        t1 = total(_ledger_fields(end["fields"], emulate), end["dissolved"],
                   end["exported"])
        gaps.append(abs(t1 - t0) / t0)
    return max(gaps) if gaps else 0.0


# a slot of the lifecycle's result "misses" when its area or mass is off
# the reference's by more than this share, or its centroid by this share of
# the floe's size beyond two roundings of the coordinate in the state's
# dtype (a 400 m^2 fracture piece at 9.2e5 m sits 0.03 m, 1.5e-3 of its
# size, from its float64 centroid): far above float32 rounding (~1e-7; the
# program's pad_polygon merges vertices a few metres apart, up to ~4e-5 of
# the area, PERF.md), far below bfloat16's (~4e-3)
LIFE_MISS = 1e-3


def _slot(alive, area, x, y, mass):
    return (bool(alive), float(area), float(x), float(y), float(mass))


def _slot_misses(a, r, dtype) -> bool:
    if a[0] != r[0]:
        return True
    if not a[0]:
        return False
    size = np.sqrt(abs(r[1]))
    rounding = 2 * float(np.spacing(np.asarray(max(abs(r[2]), abs(r[3])),
                                               dtype)))
    return bool(abs(a[1] - r[1]) > LIFE_MISS * abs(r[1])
                or abs(a[4] - r[4]) > LIFE_MISS * abs(r[4])
                or np.hypot(a[2] - r[2], a[3] - r[3])
                > LIFE_MISS * size + rounding)


def _side(post, pre_of, n):
    """(slot tuple by slot, total mass) of a reference ``Post``, with the
    slots it did not touch as they were before the boundary."""
    alive = np.zeros(n, bool)
    alive[:len(post.alive)] = post.alive

    def at(s):
        if s in post.touched:
            t = post.touched[s]
            return _slot(alive[s], *t) if t is not None and alive[s] \
                else _slot(False, 0, 0, 0, 0)
        return pre_of(s) if alive[s] else _slot(False, 0, 0, 0, 0)

    return at


def life_gaps(rec: Recorder, rho: float, emulate=None) -> dict:
    """The lifecycle numbers over the segment's boundaries (see the module
    docstring): ``life.slot_miss``, the share of the slots that the
    program or the reference changed whose result misses the reference's;
    ``life.mass_gap``, the largest relative gap between the program's
    total (floes, dissolved grid, exported) after a boundary and the
    reference's."""
    n_miss = n_cmp = 0
    gap = 0.0
    fired, missed = [], []
    for b in rec.boundaries:
        cfg = cfg_tree(b["cfg"])
        pre = host(b["pre"])
        ref = boundary(dict(b, fields=pre), cfg, rho)
        fired.append((b["step"], sorted(k for k, v in ref.fired.items()
                                        if v)))
        al0 = np.asarray(pre["alive"], bool)
        n0 = len(al0)

        def pre_of(s, f=pre):
            if s >= n0 or not al0[s]:
                return _slot(False, 0, 0, 0, 0)
            return _slot(True, f["area"][s], f["x"][s], f["y"][s],
                         f["mass"][s])

        if emulate:
            low = LOWER[emulate]
            got = boundary(dict(b, fields=pre), cfg, rho, lower=low)
            got.touched = {s: (None if t is None else tuple(low(np.array(t))))
                           for s, t in got.touched.items()}
            n = max(len(got.alive), len(ref.alive))
            lo_pre = {k: low(v) if np.asarray(v).dtype.kind == "f" else v
                      for k, v in pre.items()}
            p_at = _side(got, lambda s: pre_of(s, lo_pre), n)
            p_changed = set(got.touched)
            t_p = (sum(p_at(s)[4] for s in range(n) if p_at(s)[0])
                   + float(np.sum(low(got.dissolved))) + low(got.exported))
        else:
            post = host(b["post"])
            ap = np.asarray(post["alive"], bool)
            n = max(len(ap), len(ref.alive))

            def p_at(s):
                if s >= len(ap) or not ap[s]:
                    return _slot(False, 0, 0, 0, 0)
                return _slot(True, post["area"][s], post["x"][s],
                             post["y"][s], post["mass"][s])

            m = min(len(ap), n0)
            diff = ap[:m] != al0[:m]
            for k in ("area", "x", "y", "mass", "h"):
                diff |= ap[:m] & (post[k][:m] != pre[k][:m])
            p_changed = set(np.flatnonzero(diff).tolist()) | set(
                (np.flatnonzero(ap[m:]) + m).tolist())
            t_p = (float(np.sum(np.asarray(post["mass"], np.float64)[ap]))
                   + float(np.sum(b["dis_out"], dtype=np.float64))
                   + float(b["exp_out"]))
        r_at = _side(ref, pre_of, n)
        for s in sorted(p_changed | set(ref.touched)):
            n_cmp += 1
            if _slot_misses(p_at(s), r_at(s), np.asarray(pre["x"]).dtype):
                n_miss += 1
                missed.append((b["step"], s, p_at(s), r_at(s)))
        t_r = (sum(r_at(s)[4] for s in range(n) if r_at(s)[0])
               + float(np.sum(ref.dissolved)) + ref.exported)
        gap = max(gap, abs(t_p - t_r) / t_r)
    return {"life.slot_miss": n_miss / n_cmp if n_cmp else 0.0,
            "life.mass_gap": gap, "fired": fired, "compared": n_cmp,
            "missed": missed}


def state_mass_gap(fields: dict, rho: float, emulate=None) -> float:
    f = _ledger_fields(fields, emulate)
    al = np.asarray(f["alive"], bool)
    m_ref = floe_masses(f["verts_body"][al], f["nv"][al], f["h"][al], rho)
    m = np.asarray(f["mass"], np.float64)[al]
    return float(np.max(np.abs(m - m_ref) / m_ref, initial=0.0))


def init_gap(init: dict, polys, heights, rho: float, emulate=None) -> float:
    """The program's state as built, against the benchmark's polygons."""
    area, cen = polygon_props(polys)
    n = len(polys)
    h = np.asarray(heights, np.float64)
    mass = rho * h * area
    got = {k: np.asarray(init[k][:n], np.float64)
           for k in ("area", "x", "y", "mass")}
    if emulate:
        low = LOWER[emulate]
        got = {"area": low(area), "x": low(cen[:, 0]), "y": low(cen[:, 1]),
               "mass": low(mass)}
    r = np.sqrt(area)
    g = np.maximum.reduce([
        np.abs(got["area"] - area) / area,
        np.abs(got["mass"] - mass) / mass,
        np.hypot(got["x"] - cen[:, 0], got["y"] - cen[:, 1]) / r,
    ])
    return float(g.max())
