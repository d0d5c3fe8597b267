"""Serial float64 reference of one physics step: contact and trajectory.

A frozen copy of the port's serial oracle (``subzero_tpu_torch/oracle.py``
at commit 61c7962, itself a copy of ``subzero_tpu/oracle.py``): numpy over
the native polygon engine (``polyboolean.py`` beside this file), faithful to
SubZero's ``floe_interactions.m``, ``floe_interactions_all.m`` and
``calc_trajectory.m`` (file:line cites throughout).  It imports nothing of
the program.  What differs from the copied file: ``cfg`` is any object with
the configuration's attributes (the benchmark hands a namespace), the
forcing is a :class:`Grid` of numpy arrays, ``floes_from_state`` is replaced
by :func:`floes_from_fields` over plain numpy fields, and
:func:`follow_step` evaluates the step for a sample of floes only (every
pair that touches a sampled floe, from its lower index, and across a
periodic seam once per contact).

Faithfulness notes (deliberately reproduced quirks of the reference):

* Per disjoint overlap region: one contact force each, with the small-region
  cull ``Ar < min(N1,N2)*100/1.75`` (floe_interactions.m:79-83).
* Contact normal: chord between the two region vertices nearest the boundary
  crossing points when exactly two (m==2, :107-112); otherwise the normalized
  sum of region edge normals lying on floe 1's boundary (:118-137); sign
  disambiguated by displacing floe 1 one unit along the normal and re-clipping
  (:139-165).
* Tangential contact-point velocity uses the reference's *radial* form
  ``v = [U V] + ksi*(p - r)`` (:170-171) — NOT the rigid-body cross product.
* Each unordered pair is evaluated once from the lower index; the reaction
  force is mirrored with the same contact point (floe_interactions_all.m:
  125-147, 187-214); torque = cross(p - r, F) (:218-260).
* Trajectory: exact clamp order, AB2 coefficients, acceleration cap cases and
  spin cap of calc_trajectory.m:36-46,174-219.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .polyboolean import poly_boolean


@dataclasses.dataclass
class Grid:
    """Regular forcing grid (numpy): origin ``x0 = y0``, spacing ``dx``,
    ocean currents ``uo, vo`` and winds ``ua, va``, each ``[Ny, Nx]``."""

    x0: float
    y0: float
    dx: float
    uo: np.ndarray
    vo: np.ndarray
    ua: np.ndarray
    va: np.ndarray

    def extent(self):
        ny, nx = self.uo.shape
        return (self.x0, self.x0 + (nx - 1) * self.dx,
                self.y0, self.y0 + (ny - 1) * self.dx)


# --------------------------------------------------------------------------
# geometry helpers (numpy, float64)
# --------------------------------------------------------------------------


def _shoelace(c: np.ndarray) -> float:
    x, y = c[:, 0], c[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _poly_area(c: np.ndarray) -> float:
    return abs(_shoelace(c))


def _poly_centroid(c: np.ndarray) -> np.ndarray:
    x, y = c[:, 0], c[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    w = x * yn - xn * y
    a = 0.5 * np.sum(w)
    if a == 0:
        return c.mean(axis=0)
    return np.array([np.sum(w * (x + xn)), np.sum(w * (y + yn))]) / (6.0 * a)


def inter_x(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """All intersection points of two closed polylines, [m, 2].

    Numpy equivalent of ``collisions/InterX.m`` (segment-pair sign test).
    c1, c2: [n, 2] with the closing vertex included.
    """
    p0 = c1[:-1][:, None, :]
    p1 = c1[1:][:, None, :]
    q0 = c2[None, :-1, :]
    q1 = c2[None, 1:, :]
    d1 = p1 - p0
    d2 = q1 - q0
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    dq = q0 - p0
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (dq[..., 0] * d2[..., 1] - dq[..., 1] * d2[..., 0]) / denom
        s = (dq[..., 0] * d1[..., 1] - dq[..., 1] * d1[..., 0]) / denom
    t_safe = np.where(np.isfinite(t), t, 0.0)
    hit = (np.abs(denom) > 0) & (t >= 0) & (t <= 1) & (s >= 0) & (s <= 1)
    pts = p0 + t_safe[..., None] * d1
    return pts[hit]


def point_polyline_dist(px: np.ndarray, py: np.ndarray,
                        c: np.ndarray) -> np.ndarray:
    """Min unsigned distance of points to a closed polyline (p_poly_dist.m
    magnitude; the sign is not needed — the reference only tests |d|<1e-8)."""
    a = c[:-1]
    b = c[1:]
    d = b - a                                        # [E, 2]
    pp = np.stack([px, py], axis=-1)[:, None, :]     # [P, 1, 2]
    ap = pp - a[None]
    denom = np.maximum(np.sum(d * d, axis=-1), 1e-300)
    t = np.clip(np.sum(ap * d[None], axis=-1) / denom, 0.0, 1.0)
    proj = a[None] + t[..., None] * d[None]
    dist = np.linalg.norm(pp - proj, axis=-1)
    return dist.min(axis=1)


def in_polygon(px, py, c: np.ndarray) -> np.ndarray:
    """Crossing-number point-in-polygon (inpolygon.m role)."""
    px = np.atleast_1d(np.asarray(px, dtype=np.float64))
    py = np.atleast_1d(np.asarray(py, dtype=np.float64))
    x0, y0 = c[:, 0], c[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    pxe = px[:, None]
    pye = py[:, None]
    cond = (y0[None] > pye) != (y1[None] > pye)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(y1 == y0, 0.0, (pye - y0[None]) /
                     np.where(y1 == y0, 1.0, (y1 - y0)[None]))
    xint = x0[None] + t * (x1 - x0)[None]
    return (np.sum(cond & (pxe < xint), axis=1) % 2) == 1


def _close(c: np.ndarray) -> np.ndarray:
    """Append the first vertex when open by >1 m (floe_interactions.m:62-67)."""
    if np.linalg.norm(c[0] - c[-1]) > 1.0:
        return np.concatenate([c, c[:1]], axis=0)
    return c


# --------------------------------------------------------------------------
# oracle floe record
# --------------------------------------------------------------------------


@dataclasses.dataclass
class OFloe:
    """One floe, reference ``Floe`` struct equivalent (float64)."""

    c0: np.ndarray           # [V, 2] body frame, unrotated, open contour
    x: float
    y: float
    alpha: float
    u: float
    v: float
    ksi: float
    h: float
    mass: float
    inertia: float
    area: float
    rmax: float
    dx_p: float = 0.0
    dy_p: float = 0.0
    dalpha_p: float = 0.0
    du_p: float = 0.0
    dv_p: float = 0.0
    dksi_p: float = 0.0
    mc_xy: np.ndarray | None = None    # [P, 2] body frame
    mc_in: np.ndarray | None = None    # [P] bool
    fx_oa: float = 0.0
    fy_oa: float = 0.0
    tq_oa: float = 0.0
    stress_hist: np.ndarray | None = None   # [W, 2, 2]
    stress_count: int = 0                    # 0-based ring index
    stress: np.ndarray | None = None
    alive: bool = True
    # per-step scratch
    interactions: list = dataclasses.field(default_factory=list)
    collision_force: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2))
    collision_torque: float = 0.0
    overlap_area: float = 0.0

    def c_alpha(self) -> np.ndarray:
        ca, sa = math.cos(self.alpha), math.sin(self.alpha)
        rot = np.array([[ca, -sa], [sa, ca]])
        return self.c0 @ rot.T

    def c_world(self) -> np.ndarray:
        return self.c_alpha() + np.array([self.x, self.y])


# --------------------------------------------------------------------------
# pairwise contact (floe_interactions.m)
# --------------------------------------------------------------------------


def floe_interactions(
    floe1: OFloe,
    c2: np.ndarray,            # [V2, 2] world contour of floe 2 / the domain
    other,                     # OFloe for floe-floe; None for the boundary
    domain: np.ndarray,        # c2_boundary, [Vd, 2]
    periodic: bool,
    modulus: float,
    dt: float,
    cfg,
):
    """Returns (forces [m,2], pcontact [m,2], overlaps [m], overlap_flag).

    overlap_flag: 0 normally, +inf (floe1 merges into 2), -inf (2 into 1).
    Mirrors floe_interactions.m exactly (see module docstring).
    """
    boundary = other is None
    h1, h2 = floe1.h, (floe1.h if boundary else other.h)
    r1 = math.sqrt(floe1.area)
    # Force factor (floe_interactions.m:12-19)
    if boundary:
        force_factor = modulus * h1 / r1
    else:
        r2 = math.sqrt(other.area)
        if r1 > 1e5 or r2 > 1e5:
            force_factor = modulus * min(h1, h2) / min(r1, r2)
        else:
            force_factor = modulus * h1 * h2 / (h1 * r2 + h2 * r1)
    nu = cfg.physics.nu_poisson
    mu = cfg.physics.mu_friction
    shear_g = modulus / (2.0 * (1.0 + nu))

    c1 = floe1.c_world()
    overlap_flag = 0.0

    if boundary:
        # polyb = holes(floe2.poly): c2 is the domain rectangle; 'dif' keeps
        # the part of floe1 OUTSIDE the domain (floe_interactions.m:31-41).
        regions = poly_boolean(c1, c2, "dif")
        if regions:
            if _poly_area(regions[0]) / floe1.area > \
                    cfg.contact.boundary_overlap_frac:
                overlap_flag = math.inf
    else:
        regions = poly_boolean(c1, c2, "int")

    ar = np.array([_poly_area(r) for r in regions])

    # Merge flags (floe_interactions.m:53-60), gated on floe1 being fully
    # inside the domain bbox OR floe2 small OR periodic (:54).
    if not boundary:
        bx, by = domain[:, 0], domain[:, 1]
        in_bbox = (c1[:, 0].max() < bx.max() and c1[:, 0].min() > bx.min()
                   and c1[:, 1].max() < by.max() and c1[:, 1].min() > by.min())
        if in_bbox or other.area < 0.95 * _poly_area(domain) or periodic:
            if ar.sum() / floe1.area > cfg.contact.merge_overlap_frac:
                overlap_flag = math.inf
            elif ar.sum() / other.area > cfg.contact.merge_overlap_frac:
                overlap_flag = -math.inf

    c1c = _close(c1)
    c2c = _close(c2)
    pts = inter_x(c1c, c2c)

    zero = (np.zeros((0, 2)), np.zeros((0, 2)), np.zeros((0,)), overlap_flag)
    if len(pts) < 2 or math.isinf(overlap_flag) or not regions:
        return zero

    # Small-region cull (floe_interactions.m:78-83)
    n1, n2 = len(c1c) - 1, len(c2c) - 1
    amin = min(n1, n2) * cfg.contact.small_region_coeff
    keep = ar >= amin
    regions = [r for r, k in zip(regions, keep) if k]
    ar = ar[keep]

    forces = []
    pcontacts = []
    overlaps = []
    for k, reg in enumerate(regions):
        reg = np.asarray(reg)
        cx, cy = _poly_centroid(reg)
        # dsearchn: nearest region vertex per crossing point, keep dist<1
        d2 = np.linalg.norm(reg[:, None, :] - pts[None, :, :], axis=-1)
        nearest = np.argmin(d2, axis=0)
        dist = d2[nearest, np.arange(len(pts))]
        p = reg[nearest[dist < 1.0]]
        m = len(p)

        dl = 0.0
        force_dir = np.zeros(2)
        pcontact = np.array([cx, cy])
        if ar[k] == 0:
            pcontact = np.zeros(2)
        elif m == 2:
            # chord between the two contact points (:107-112)
            xgh = p[1, 0] - p[0, 0]
            ygh = p[1, 1] - p[0, 1]
            b = math.hypot(xgh, ygh)
            if b > 0:
                force_dir = np.array([-ygh / b, xgh / b])
                dl = b
        elif m == 0:
            force_dir = np.zeros(2)
        else:
            # sum of region-edge normals lying on c1 (:118-137)
            xv = np.concatenate([reg[:, 0], reg[:1, 0]])
            yv = np.concatenate([reg[:, 1], reg[:1, 1]])
            xgh = np.diff(xv)
            ygh = np.diff(yv)
            xm = 0.5 * (xv[1:] + xv[:-1])
            ym = 0.5 * (yv[1:] + yv[:-1])
            b = np.hypot(xgh, ygh)
            bb = np.where(b > 0, b, 1.0)
            nrm = np.stack([-ygh / bb, xgh / bb], axis=-1)
            xt = xm + nrm[:, 0] / 100.0
            yt = ym + nrm[:, 1] / 100.0
            inside = in_polygon(xt, yt, reg)
            nrm[~inside] = -nrm[~inside]
            fn = -force_factor * b[:, None] * nrm
            dmin = point_polyline_dist(xm, ym, c1c)
            on = dmin < 1e-8
            if 0 < on.sum() < len(dmin):
                f_dir = fn[on].sum(axis=0)
                norm = np.linalg.norm(f_dir)
                if norm > 0:
                    force_dir = f_dir / norm
                dl = float(b[on].mean())

        # direction disambiguation via displace-and-reclip (:139-165).
        # The reference matches each displaced region to the original via an
        # exact polygon intersection (Clipper int64 is robust on the
        # 1-m-wide sliver-vs-sliver cases this produces); our float64 engine
        # can return empty there, so the region-matching test uses bbox
        # overlap instead — same pairing, degeneracy-proof.
        if dl < 0.1:
            force_dir = np.zeros(2)
        else:
            c1_new = c1 + force_dir
            op = "dif" if boundary else "int"
            new_regions = poly_boolean(c1_new, c2, op)
            rmin = reg.min(axis=0) - 1.5
            rmax_ = reg.max(axis=0) + 1.5
            for nr in new_regions:
                nr = np.asarray(nr)
                if np.all(nr.max(axis=0) >= rmin) and \
                        np.all(nr.min(axis=0) <= rmax_):
                    if _poly_area(nr) / ar[k] - 1.0 > 0:
                        force_dir = -force_dir

        force = force_dir * ar[k] * force_factor    # (:167)

        # tangential force, radial contact-point velocity form (:169-183)
        pc = pcontact
        v1 = np.array([floe1.u, floe1.v]) + floe1.ksi * (
            pc - np.array([floe1.x, floe1.y]))
        if boundary:
            v2 = np.zeros(2)
        else:
            v2 = np.array([other.u, other.v]) + other.ksi * (
                pc - np.array([other.x, other.y]))
        v_t = v1 - v2
        sp = np.linalg.norm(v_t)
        if sp == 0:
            dir_t = np.zeros(2)
        else:
            dir_t = v_t / sp
        force_t = -float(np.dot(dir_t, v_t)) * dl * shear_g * sp * dir_t * dt
        if np.linalg.norm(force_t) > mu * np.linalg.norm(force):
            force_t = -mu * np.linalg.norm(force) * dir_t

        forces.append(force + force_t)
        pcontacts.append(pcontact)
        overlaps.append(ar[k])

    if not forces:
        return zero
    return (np.array(forces), np.array(pcontacts), np.array(overlaps),
            overlap_flag)


# --------------------------------------------------------------------------
# orchestrator (floe_interactions_all.m)
# --------------------------------------------------------------------------


def _domain_rect(cfg) -> np.ndarray:
    lx, ly = cfg.domain.lx, cfg.domain.ly
    return np.array([[-lx, -ly], [lx, -ly], [lx, ly], [-lx, ly]],
                    dtype=np.float64)


def interactions_all(
    floes: list[OFloe],
    cfg,
    modulus: float,
    dt: float,
    domain: np.ndarray | None = None,
):
    """Contact pass over all floes: fills interactions/collision_force/
    collision_torque/overlap_area in place (floe_interactions_all.m:68-285
    minus the trajectory calls).  Returns (kill, transfer) index maps.
    """
    domain = _domain_rect(cfg) if domain is None else domain
    periodic = cfg.processes.periodic
    lx = float(np.max(domain[:, 0]))
    ly = float(np.max(domain[:, 1]))
    nb = cfg.n_boundary
    n0 = len(floes)

    for f in floes:
        f.interactions = []
        f.collision_force = np.zeros(2)
        f.collision_torque = 0.0
        f.overlap_area = 0.0

    # ghost floes (:18-66): X pass, then Y pass over the extended list
    work = list(floes)
    parent = []
    if periodic:
        ghosts = []
        for i, f in enumerate(work):
            if f.alive and np.max(np.abs(f.c_world()[:, 0])) > lx:
                g = dataclasses.replace(
                    f, x=f.x - 2 * lx * math.copysign(1.0, f.x),
                    interactions=[], collision_force=np.zeros(2))
                ghosts.append(g)
                parent.append(i)
        work = work + ghosts
        ghosts = []
        for i, f in enumerate(work):
            if f.alive and np.max(np.abs(f.c_world()[:, 1])) > ly:
                g = dataclasses.replace(
                    f, y=f.y - 2 * ly * math.copysign(1.0, f.y),
                    interactions=[], collision_force=np.zeros(2))
                ghosts.append(g)
                parent.append(i if i < n0 else parent[i - n0])
        work = work + ghosts

    n = len(work)
    kill = np.zeros(n0, dtype=int)
    transfer = np.zeros(n0, dtype=int)

    # pair narrow phase, i<j once (:101-147, symmetrize :187-214)
    for i in range(nb, n):
        fi = work[i]
        if not fi.alive:
            continue
        for j in range(i + 1, n) if cfg.processes.collision else ():
            fj = work[j]
            if not fj.alive:
                continue
            if math.hypot(fi.x - fj.x, fi.y - fj.y) >= fi.rmax + fj.rmax:
                continue
            force, pc, ov, flag = floe_interactions(
                fi, fj.c_world(), fj, domain, periodic, modulus, dt, cfg)
            if np.abs(force).sum() != 0:
                for r in range(len(force)):
                    fi.interactions.append(
                        [j, force[r, 0], force[r, 1], pc[r, 0], pc[r, 1],
                         0.0, ov[r]])
                    fj.interactions.append(
                        [i, -force[r, 0], -force[r, 1], pc[r, 0], pc[r, 1],
                         0.0, ov[r]])
                fi.overlap_area += ov.sum()
                fj.overlap_area += ov.sum()
            elif math.isinf(flag) and i >= nb:
                # kill/transfer bookkeeping (:138-145)
                ip = i if i < n0 else parent[i - n0]
                jp = j if j < n0 else parent[j - n0]
                if i < n0 and flag > 0:
                    kill[ip] = ip + 1
                    transfer[ip] = jp + 1
                elif jp < n0:
                    kill[ip if i < n0 else jp] = jp + 1

        # boundary contact (:150-172)
        if not periodic:
            force, pc, ov, flag = floe_interactions(
                fi, domain, None, domain, periodic, modulus, dt, cfg)
            if not in_polygon(fi.x, fi.y, domain)[0]:
                fi.alive = False
            if np.abs(force).sum() != 0:
                for r in range(len(force)):
                    fx, fy = force[r]
                    # == comparison like the reference (:160-165); inert for
                    # region centroids, see ContactConfig.wall_zero_tol
                    if abs(abs(pc[r, 1]) - ly) <= cfg.contact.wall_zero_tol:
                        fx = 0.0
                    if abs(abs(pc[r, 0]) - lx) <= cfg.contact.wall_zero_tol:
                        fy = 0.0
                    fi.interactions.append(
                        [math.inf, fx, fy, pc[r, 0], pc[r, 1], 0.0, ov[r]])
                fi.overlap_area += ov.sum()
            elif math.isinf(flag) and i < n0:
                fi.alive = False   # absorbed by the boundary

    # torques + force/torque reduction (:218-263); ghosts fold into parents
    for i in range(n):
        f = work[i]
        if not f.interactions:
            continue
        a = np.array(f.interactions)
        rx, ry = f.x, f.y
        a[:, 5] = (a[:, 3] - rx) * a[:, 2] - (a[:, 4] - ry) * a[:, 1]
        f.interactions = a
        f.collision_force = a[:, 1:3].sum(axis=0)
        f.collision_torque = a[:, 5].sum()
    for gi, p in enumerate(parent):
        floes[p].collision_force = (
            floes[p].collision_force + work[n0 + gi].collision_force)
        floes[p].collision_torque += work[n0 + gi].collision_torque

    return kill, transfer


# --------------------------------------------------------------------------
# trajectory (calc_trajectory.m)
# --------------------------------------------------------------------------


def calc_trajectory(
    floe: OFloe,
    forcing,                  # Grid
    dt: float,
    heat_flux: float,
    do_int: bool,
    cfg,
) -> None:
    """In-place trajectory update, faithful to calc_trajectory.m."""
    phys = cfg.physics
    ext_force = floe.collision_force.astype(np.float64).copy()
    ext_torque = float(floe.collision_torque)

    # stress ring buffer (:9-29)
    if len(floe.interactions):
        a = np.asarray(floe.interactions, dtype=np.float64)
        r = np.array([floe.x, floe.y])
        sxx = np.sum((a[:, 3] - r[0]) * a[:, 1])
        syy = np.sum((a[:, 4] - r[1]) * a[:, 2])
        sxy = np.sum((a[:, 3] - r[0]) * a[:, 2])
        syx = np.sum((a[:, 4] - r[1]) * a[:, 1])
        stress = (np.array([[2 * sxx, sxy + syx], [sxy + syx, 2 * syy]])
                  / (2 * floe.area * floe.h))
    else:
        stress = np.zeros((2, 2))
    w = floe.stress_hist.shape[0]
    idx = floe.stress_count % w
    floe.stress_hist[idx] = stress
    floe.stress_count += 1
    floe.stress = floe.stress_hist.mean(axis=0)

    # clamps (:36-46)
    if floe.h > cfg.clamps.max_thickness:
        floe.h = cfg.clamps.max_thickness
    elif floe.mass < cfg.clamps.min_mass:
        floe.mass = cfg.clamps.dead_mass
        floe.alive = False
    while np.max(np.abs(ext_force)) > floe.mass / (
            cfg.clamps.force_dt_factor * dt):
        ext_force = ext_force / 10.0
        ext_torque = ext_torque / 10.0

    # thermodynamic growth (:76-80)
    h = floe.h
    dh = heat_flux * dt / h
    grow = (h - dh) / h
    floe.mass *= grow
    floe.inertia *= grow
    floe.h = h - dh

    # out-of-grid kill (:116-117) — contour extremes vs the forcing grid
    xmin, xmax, ymin, ymax = (float(v) for v in forcing.extent())
    ca = floe.c_alpha()
    if (ca[:, 0].max() + floe.x > xmax or ca[:, 0].min() + floe.x < xmin
            or ca[:, 1].max() + floe.y > ymax
            or ca[:, 1].min() + floe.y < ymin):
        floe.alive = False
        return
    if not floe.alive:
        return

    # ocean/atm forcing refresh (:94,121-166)
    if cfg.physics.ocean_coupling and (do_int or floe.h < 0.1):
        rot = np.array([[math.cos(floe.alpha), -math.sin(floe.alpha)],
                        [math.sin(floe.alpha), math.cos(floe.alpha)]])
        xr = floe.mc_xy @ rot.T                       # [P, 2] world-rotated
        gx = xr[:, 0] + floe.x
        gy = xr[:, 1] + floe.y

        uo = _interp(forcing.uo, gx, gy, forcing)
        vo = _interp(forcing.vo, gx, gy, forcing)
        ua = _interp(forcing.ua, gx, gy, forcing)
        va = _interp(forcing.va, gx, gy, forcing)

        A = floe.mc_in
        u10 = ua[A].mean()
        v10 = va[A].mean()
        ws = math.hypot(u10, v10)
        fx_atm = phys.rho_air * phys.cd_atm * ws * u10
        fy_atm = phys.rho_air * phys.cd_atm * ws * v10

        m_a = floe.mass / floe.area
        fx_tilt = -m_a * phys.f_coriolis * vo
        fy_tilt = +m_a * phys.f_coriolis * uo

        uice = floe.u - floe.ksi * xr[:, 1]
        vice = floe.v + floe.ksi * xr[:, 0]
        du = uo - uice
        dv = vo - vice
        sp = np.hypot(du, dv)
        ca_t, sa_t = math.cos(phys.turn_angle), math.sin(phys.turn_angle)
        tau_x = phys.rho_ocean * phys.cd_ocean * sp * (ca_t * du - sa_t * dv)
        tau_y = phys.rho_ocean * phys.cd_ocean * sp * (sa_t * du + ca_t * dv)

        fx = tau_x + fx_atm + fx_tilt
        fy = tau_y + fy_atm + fy_tilt
        torque = -fx * xr[:, 1] + fy * xr[:, 0]
        fx = fx + m_a * phys.f_coriolis * floe.v
        fy = fy - m_a * phys.f_coriolis * floe.u
        floe.fx_oa = fx[A].mean()
        floe.fy_oa = fy[A].mean()
        floe.tq_oa = torque[A].mean()
    elif not cfg.physics.ocean_coupling:
        floe.fx_oa = floe.fy_oa = floe.tq_oa = 0.0

    # AB2 position update (:174-177)
    floe.x += 1.5 * dt * floe.u - 0.5 * dt * floe.dx_p
    floe.dx_p = floe.u
    floe.y += 1.5 * dt * floe.v - 0.5 * dt * floe.dy_p
    floe.dy_p = floe.v
    floe.alpha += 1.5 * dt * floe.ksi - 0.5 * dt * floe.dalpha_p
    floe.dalpha_p = floe.ksi

    # acceleration cap cases (:181-204)
    du_dt = (floe.fx_oa * floe.area + ext_force[0]) / floe.mass
    dv_dt = (floe.fy_oa * floe.area + ext_force[1]) / floe.mass
    cap = cfg.clamps.accel_h_factor * floe.h
    frac = None
    if abs(dt * du_dt) > cap and abs(dt * dv_dt) > cap:
        f1 = math.copysign(cap / dt, du_dt) / du_dt
        f2 = math.copysign(cap / dt, dv_dt) / dv_dt
        frac = min(f1, f2)
    elif abs(dt * du_dt) > cap:
        frac = math.copysign(cap / dt, du_dt) / du_dt
    elif abs(dt * dv_dt) > cap:
        frac = math.copysign(cap / dt, dv_dt) / dv_dt
    if frac is not None:
        du_dt *= frac
        dv_dt *= frac
    floe.u += 1.5 * dt * du_dt - 0.5 * dt * floe.du_p
    floe.v += 1.5 * dt * dv_dt - 0.5 * dt * floe.dv_p
    floe.du_p = du_dt
    floe.dv_p = dv_dt

    # spin (:210-219)
    dksi_dt = (floe.tq_oa * floe.area + ext_torque) / floe.inertia
    if frac is not None:
        dksi_dt *= frac
    ksi = floe.ksi + 1.5 * dt * dksi_dt - 0.5 * dt * floe.dksi_p
    if abs(ksi) > cfg.clamps.max_spin:
        ksi = math.copysign(cfg.clamps.max_spin, ksi)
    floe.ksi = ksi
    floe.dksi_p = dksi_dt


def _interp(field, gx, gy, forcing):
    """Bilinear interpolation on the forcing grid, clamped to its edges."""
    f = np.asarray(field, dtype=np.float64)
    ny, nx = f.shape
    x0 = float(forcing.x0)
    y0 = float(forcing.y0)
    dx = float(forcing.dx)
    cx = np.clip((gx - x0) / dx, 0.0, nx - 1.000001)
    cy = np.clip((gy - y0) / dx, 0.0, ny - 1.000001)
    ix = np.floor(cx).astype(int)
    iy = np.floor(cy).astype(int)
    tx = cx - ix
    ty = cy - iy
    return (f[iy, ix] * (1 - ty) * (1 - tx)
            + f[iy, ix + 1] * (1 - ty) * tx
            + f[iy + 1, ix] * ty * (1 - tx)
            + f[iy + 1, ix + 1] * ty * tx)




# --------------------------------------------------------------------------
# the step for a sample of floes
# --------------------------------------------------------------------------


def floes_from_fields(f: dict) -> list[OFloe]:
    """Oracle records, one per slot, from plain numpy fields of a state
    (``verts_body [N, V, 2]``, ``nv``, ``alive``, the scalars, ``mc_xy``,
    ``mc_in``).  The stress ring is not carried: the comparison reads no
    stress, so each record gets a one-entry ring."""
    g = {k: np.asarray(v, np.float64) for k, v in f.items()
         if k not in ("nv", "alive", "mc_in")}
    out = []
    for i in range(len(f["alive"])):
        nv = int(f["nv"][i])
        out.append(OFloe(
            c0=g["verts_body"][i, :nv].copy(),
            x=g["x"][i], y=g["y"][i], alpha=g["alpha"][i],
            u=g["u"][i], v=g["v"][i], ksi=g["ksi"][i],
            h=g["h"][i], mass=g["mass"][i],
            inertia=g["inertia"][i], area=g["area"][i], rmax=g["rmax"][i],
            dx_p=g["dx_p"][i], dy_p=g["dy_p"][i], dalpha_p=g["dalpha_p"][i],
            du_p=g["du_p"][i], dv_p=g["dv_p"][i], dksi_p=g["dksi_p"][i],
            mc_xy=g["mc_xy"][i], mc_in=np.asarray(f["mc_in"][i], bool),
            fx_oa=g["fx_oa"][i], fy_oa=g["fy_oa"][i], tq_oa=g["tq_oa"][i],
            stress_hist=np.zeros((1, 2, 2)), stress=np.zeros((2, 2)),
            alive=bool(f["alive"][i]),
        ))
    return out


def follow_step(fields: dict, sample, forcing: Grid, cfg, modulus: float,
                step_idx: int, heat_flux: float, domain: np.ndarray):
    """One physics step from the state ``fields`` for the floes ``sample``
    (slot indices): every pair that touches a sampled floe, evaluated once
    from its lower index as :func:`interactions_all` does, the reaction
    mirrored, the boundary contact, then the periodic wrap and
    :func:`calc_trajectory` for the sampled floes, as the copied
    ``oracle_step`` calls them.

    On a periodic domain a pair is evaluated at the partner's nearest
    periodic image (the floe_interactions_all.m ghost floes, once per
    physical contact): the copied ``interactions_all`` also lets ghosts
    meet ghosts and real floes meet the ghosts of floes that already meet
    their own ghosts, which counts a contact across the seam twice.

    Returns ``{slot: OFloe}`` after the step, with ``interactions``,
    ``collision_force`` and ``collision_torque`` of the step's contacts."""
    floes = floes_from_fields(fields)
    sample = [int(s) for s in sample]
    dt = cfg.numerics.dt
    periodic = cfg.processes.periodic
    lx = float(np.max(domain[:, 0]))
    ly = float(np.max(domain[:, 1]))
    nb = cfg.n_boundary
    xs = np.array([f.x for f in floes])
    ys = np.array([f.y for f in floes])
    rs = np.array([f.rmax for f in floes])
    al = np.array([f.alive for f in floes])

    for s in sample:
        fs = floes[s]
        fs.interactions = []
        fs.overlap_area = 0.0
        if not fs.alive:
            continue
        if cfg.processes.collision and s >= nb:
            dx = xs - fs.x
            dy = ys - fs.y
            if periodic:
                sx = -2 * lx * np.round(dx / (2 * lx))
                sy = -2 * ly * np.round(dy / (2 * ly))
            else:
                sx = np.zeros_like(dx)
                sy = np.zeros_like(dy)
            near = (np.hypot(dx + sx, dy + sy) < fs.rmax + rs) & al
            near[s] = False
            for j in np.flatnonzero(near):
                # the partner's image next to s, as a ghost floe
                fj = dataclasses.replace(floes[j], x=floes[j].x + sx[j],
                                         y=floes[j].y + sy[j],
                                         interactions=[])
                if j < s and j >= nb:
                    # the pair belongs to j: evaluate it from j's side,
                    # with s moved next to j's real position
                    g = dataclasses.replace(fs, x=fs.x - sx[j],
                                            y=fs.y - sy[j], interactions=[])
                    force, pc, ov, _ = floe_interactions(
                        floes[j], g.c_world(), g, domain, periodic, modulus,
                        dt, cfg)
                    sign, back = -1.0, np.array([sx[j], sy[j]])
                else:
                    force, pc, ov, _ = floe_interactions(
                        fs, fj.c_world(), fj, domain, periodic, modulus, dt,
                        cfg)
                    sign, back = 1.0, np.zeros(2)
                if np.abs(force).sum() != 0:
                    for r in range(len(force)):
                        p = pc[r] + back
                        fs.interactions.append(
                            [j, sign * force[r, 0], sign * force[r, 1], p[0],
                             p[1], 0.0, ov[r]])
                    fs.overlap_area += ov.sum()
        if not periodic and s >= nb:
            force, pc, ov, flag = floe_interactions(
                fs, domain, None, domain, periodic, modulus, dt, cfg)
            if not in_polygon(fs.x, fs.y, domain)[0]:
                fs.alive = False
            if np.abs(force).sum() != 0:
                for r in range(len(force)):
                    fx, fy = force[r]
                    if abs(abs(pc[r, 1]) - ly) <= cfg.contact.wall_zero_tol:
                        fx = 0.0
                    if abs(abs(pc[r, 0]) - lx) <= cfg.contact.wall_zero_tol:
                        fy = 0.0
                    fs.interactions.append(
                        [math.inf, fx, fy, pc[r, 0], pc[r, 1], 0.0, ov[r]])
                fs.overlap_area += ov.sum()
            elif math.isinf(flag):
                fs.alive = False
        # torques + force/torque reduction (floe_interactions_all.m:218-263)
        if len(fs.interactions):
            a = np.array(fs.interactions)
            a[:, 5] = (a[:, 3] - fs.x) * a[:, 2] - (a[:, 4] - fs.y) * a[:, 1]
            fs.interactions = a
            fs.collision_force = a[:, 1:3].sum(axis=0)
            fs.collision_torque = a[:, 5].sum()
        else:
            fs.collision_force = np.zeros(2)
            fs.collision_torque = 0.0

    do_int = (step_idx % cfg.processes.n_ocean_force) == 0
    out = {}
    for s in sample:
        f = dataclasses.replace(floes[s])
        out[s] = f
        if s < nb:
            continue
        if periodic:
            if abs(f.x) > lx:
                f.x -= 2 * lx * math.copysign(1.0, f.x)
            if abs(f.y) > ly:
                f.y -= 2 * ly * math.copysign(1.0, f.y)
        if f.alive:
            calc_trajectory(f, forcing, dt, heat_flux, do_int, cfg)
    return out
