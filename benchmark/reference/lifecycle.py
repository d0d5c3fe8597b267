"""The reference's lifecycle boundary: the passes the program fires at a
chunk boundary, run on the reference's own host view of the program's
state before the boundary, and their edits applied in numpy.

The order of the passes, their cadences and the slot rules follow
``subzero_tpu_torch/processes/lifecycle.py:Lifecycle.step`` and
``host.py:apply_edits`` at commit 61c7962; the passes themselves are the
frozen copies in ``reference/passes``.  The packing pass (``n_pack``) is
not copied: a boundary where it is due raises.

    boundary(b, cfg, rho) -> Post

where ``b`` holds what the boundary found: the state's fields, the last
step's contact tables (``aux``), the step, the dissolved grid and exported
mass, the lifecycle's generator, running largest area and packing
thickness, the merge pairs and gating hints, whether the pool and the
vertex rung grow for births, the vertex rung and the domain polygon.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from .passes import hostgeom as hg
from .passes.corners import corners_pass
from .passes.fracture import fracture_pass
from .passes.fuse import fuse_floes
from .passes.host import HostView, StateEdit, _cap_vertices
from .passes.ridge_raft import ridge_raft_pass
from .passes.simplify import simplify_pass
from .passes.weld import weld_pass, weld_schedule

SCALARS = (
    "x", "y", "alpha", "u", "v", "ksi", "h", "mass", "inertia", "area",
    "rmax", "dx_p", "dy_p", "dalpha_p", "du_p", "dv_p", "dksi_p",
    "overlap_area",
)
# the state fields the host view is built from
VIEW_FIELDS = ("alive", "nv", "verts_body", "stress", "strain") + SCALARS


def host_view(f: dict, lower=None) -> HostView:
    """The host view of a state's fields (numpy, the state's dtype): the
    world-frame polygons are the body-frame ones rotated by alpha and moved
    to (x, y), in the state's dtype, one rounding per operation.
    ``lower`` rounds every float input first (the control)."""
    f = dict(f)
    if lower is not None:
        f = {k: (lower(v).astype(np.asarray(v).dtype)
                 if np.asarray(v).dtype.kind == "f" else v)
             for k, v in f.items()}
    dt = np.asarray(f["x"]).dtype.type
    alive = np.asarray(f["alive"], bool)
    nv = np.asarray(f["nv"]).astype(np.int32)
    alpha = np.asarray(f["alpha"], np.float64)
    c = np.cos(alpha).astype(dt)[:, None]
    s = np.sin(alpha).astype(dt)[:, None]
    b = np.asarray(f["verts_body"])
    px, py = b[..., 0], b[..., 1]
    wx = (c * px - s * py) + np.asarray(f["x"])[:, None]
    wy = (s * px + c * py) + np.asarray(f["y"])[:, None]
    n = len(alive)
    polys = [np.stack([wx[i, :nv[i]], wy[i, :nv[i]]], 1).astype(np.float64)
             if alive[i] and nv[i] >= 3 else None for i in range(n)]
    return HostView(n=n, alive=alive.copy(), nv=nv, polys=polys,
                    stress=np.asarray(f["stress"]),
                    strain=np.asarray(f["strain"]),
                    fields={k: np.asarray(f[k]) for k in SCALARS})


@dataclass
class Post:
    """The reference's state after a boundary: ``alive`` over the slots,
    and (area, x, y, mass) of every slot an edit touched."""

    alive: np.ndarray
    touched: dict
    dissolved: np.ndarray
    exported: float
    fired: dict


def dues(step_idx, cfg, amax, pack_h0, hints) -> dict:
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
        "simp": due(proc.n_simplify) and bool(h.get("any_oversize", True)),
        "pack": proc.packing and due(proc.n_pack) and pack_h0 > 0,
        "weld": (proc.welding and amax is not None
                 and weld_schedule(step_idx, cfg, amax)) or None,
    }


def _guarded(view, edit: StateEdit, fn) -> StateEdit:
    touched = edit.kills | edit.dissolve_kills | set(edit.reshapes)
    if not touched:
        return fn(view)
    with view.masked(dead_slots=touched):
        return fn(view)


def _merges(view, pairs, cfg, edit: StateEdit) -> None:
    done: set[int] = set()
    for i, j in pairs:
        if i in done or j in done:
            continue
        if not (view.alive[i] and view.alive[j]):
            continue
        if i < cfg.n_boundary:
            continue
        if view.area[i] > cfg.processes.fuse_min_area:
            edit.merge(fuse_floes(view, j, [i], cfg))
            done |= {i, j}
        else:
            edit.dissolve_kills.add(i)
            done.add(i)


def _deform_info(view, aux):
    ov = np.asarray(aux.pair_overlap)
    nbr = np.asarray(aux.nbr_idx)
    fx = np.asarray(aux.pair_fx)
    fy = np.asarray(aux.pair_fy)
    k = np.argmax(ov, axis=1)
    rows = np.arange(view.n)
    hit = np.nonzero(ov[rows, k] > 0)[0]
    return {int(i): (int(nbr[i, k[i]]), float(fx[i, k[i]]),
                     float(fy[i, k[i]])) for i in hit}


def _corners(view, aux, cfg, rng, domain_poly) -> StateEdit:
    keep = rng.random(view.n) > cfg.processes.corner_keep_prob
    ov_frac = view.overlap_area / np.maximum(view.area, 1e-12)
    eligible = keep & (ov_frac < cfg.processes.corner_max_overlap)
    valid = np.asarray(aux.pair_valid)
    px = np.asarray(aux.pair_px)
    py = np.asarray(aux.pair_py)
    nbr = np.asarray(aux.nbr_idx)
    bnd = np.asarray(aux.boundary_contact)
    points, nbrs = {}, {}
    for i in np.nonzero(eligible & valid.any(axis=1))[0]:
        ks = np.nonzero(valid[i])[0]
        points[i] = np.stack([px[i, ks], py[i, ks]], axis=1)
        nbrs[i] = [int(j) for j in nbr[i, ks]]
    with view.masked(keep_mask=eligible):
        return corners_pass(view, cfg, rng, points, nbrs, bnd & eligible,
                            domain_poly)


def _guard(edit: StateEdit, alive, cfg, rho) -> None:
    """Births beyond the free slots: the most massive are kept, the rest
    dissolved (the program's ``capacity_guard``, where the pool does not
    grow)."""
    freed = edit.kills | edit.dissolve_kills
    n_free = sum(1 for i in range(cfg.n_boundary, len(alive))
                 if (not alive[i]) or i in freed)
    if len(edit.new_floes) <= n_free:
        return

    def mass(f):
        return float(f.mass) if f.mass is not None else float(
            rho * f.h * abs(hg.area(np.asarray(f.poly))))

    order = sorted(range(len(edit.new_floes)),
                   key=lambda k: mass(edit.new_floes[k]), reverse=True)
    keep = set(order[:n_free])
    for k, f in enumerate(edit.new_floes):
        if k not in keep:
            c = hg.centroid(np.asarray(f.poly))
            edit.dissolve_mass.append((float(c[0]), float(c[1]), mass(f)))
    edit.new_floes = [f for k, f in enumerate(edit.new_floes) if k in keep]


def _bin(dissolved, x, y, mass, cfg):
    ny, nx = dissolved.shape
    lx, ly = cfg.domain.lx, cfg.domain.ly
    ix = int(np.clip((x + lx) / (2 * lx / nx), 0, nx - 1))
    iy = int(np.clip((ly - y) / (2 * ly / ny), 0, ny - 1))
    dissolved[iy, ix] += mass


def boundary(b: dict, cfg, rho: float, lower=None) -> Post:
    """The boundary ``b`` describes (see the module docstring), with the
    state's fields as host numpy (:data:`VIEW_FIELDS`); the generator is
    copied, not advanced.  ``lower`` rounds the view's inputs (the
    control)."""
    view = host_view(b["fields"], lower)
    rng = copy.deepcopy(b["rng"])
    aux, domain_poly, step_idx = b["aux"], b["domain_poly"], b["step"]
    amax, merge_pairs, grow = b["amax"], b["merge_pairs"], b["grow"]
    dissolved = np.array(b["dis_in"], np.float64)
    exported = float(b["exp_in"])
    d = dues(step_idx, cfg, amax, b["pack_h0"], b["hints"])
    if d["pack"]:
        raise NotImplementedError("the reference has no packing pass")
    want_merge = bool(merge_pairs)
    fired = {k: bool(v) for k, v in d.items()}
    fired["merge"] = want_merge
    if not any(fired.values()):
        return Post(view.alive.copy(), {}, dissolved, exported, fired)
    edit = StateEdit()
    boundary_polys = [view.poly(i) for i in range(cfg.n_boundary)
                      if view.polys[i] is not None]
    if want_merge:
        _merges(view, merge_pairs, cfg, edit)
    for kind in ("ridge", "raft"):
        if d[kind]:
            edit.merge(_guarded(view, edit, lambda v, kind=kind:
                                ridge_raft_pass(v, cfg, rng, kind,
                                                domain_poly)))
    if d["frac"]:
        deform = _deform_info(view, aux)
        edit.merge(_guarded(view, edit,
                            lambda v: fracture_pass(v, cfg, rng, deform)))
    if d["corner"]:
        edit.merge(_guarded(view, edit, lambda v: _corners(
            v, aux, cfg, rng, domain_poly)))
    weld = d["weld"]
    if weld:
        cur = float(np.max(np.where(view.alive, view.area, 0.0)))
        if cur > amax:
            weld = weld_schedule(step_idx, cfg, cur)
        wnx, wny, wmax = weld
        edit.merge(_guarded(view, edit, lambda v: weld_pass(
            v, cfg, rng, wnx, wny, wmax)))
    if d["simp"]:
        edit.merge(_guarded(view, edit, lambda v: simplify_pass(
            v, cfg, boundary_polys)))

    # -- slots: kills, then births into the first free slots -------------
    alive = view.alive.copy()
    if not grow:
        _guard(edit, alive, cfg, rho)
    for i in edit.dissolve_kills:
        _bin(dissolved, view.x[i], view.y[i], view.mass[i], cfg)
    for mx, my, m in edit.dissolve_mass:
        _bin(dissolved, mx, my, m, cfg)
    exported += edit.export_mass
    gone = edit.kills | edit.dissolve_kills
    for i in gone:
        alive[i] = False
    free = [i for i in range(len(alive))
            if not alive[i] and i >= cfg.n_boundary]
    free += list(range(len(alive), len(alive) + len(edit.new_floes)))
    alive = np.concatenate([alive, np.zeros(len(edit.new_floes), bool)])
    vc = cfg.capacity.max_verts if b["grow_verts"] else min(
        cfg.capacity.max_verts, b["v_cap"])
    touched = {i: None for i in gone}
    for slot, kv in edit.updates.items():
        touched[slot] = (float(view.area[slot]), float(view.x[slot]),
                         float(view.y[slot]),
                         float(kv.get("mass", view.mass[slot])))
    births = [(s, p, m, None) for s, (p, m) in edit.reshapes.items()]
    births += [(s, f.poly, f.mass, f.h) for s, f in zip(free, edit.new_floes)]
    for slot, poly, mass, h in births:
        p = _cap_vertices(poly, vc)
        a = abs(hg.area(p))
        c = hg.centroid(p)
        m = float(mass) if mass is not None else rho * h * a
        touched[slot] = (a, float(c[0]), float(c[1]), m)
        alive[slot] = True
    return Post(alive, touched, dissolved, exported, fired)
