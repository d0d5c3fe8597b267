"""Per-floe trajectory update — port of
``subzero_tpu/dynamics/trajectory.py`` (``calc_trajectory.m``).

Sequence: stress ring buffer; clamps (h <= 10 m, tiny-mass death, contact
force divided by 10 until |F| <= m/(5 dt)); thermodynamic growth; ocean/wind
forcing averaged over the Monte-Carlo points, cached and refreshed only on
``do_int`` steps or for thin floes; Adams-Bashforth-2 update with the
acceleration and spin caps; boundary-integral strain; out-of-grid kill.
Per-floe branches are ``torch.where``.  The JAX version's two
``lax.cond``s are host branches here: the ring reset on ``step % W`` and the
forcing refresh on ``do_int`` or the presence of a thin live floe.
"""

from __future__ import annotations

import math

import torch

from ..config import SimConfig
from ..forcing import Forcing, sample_forcing
from ..state import FloeState, rotate
from ..trace import sync


def stress_from_sums(state: FloeState, sxx, syy, sxy) -> torch.Tensor:
    """Virial contact stress per floe, [N, 3] (xx, yy, xy), from precomputed
    Σ (p - r) ⊗ F sums.  Mirrors calc_trajectory.m:9-13."""
    inv = 1.0 / (state.area * state.h)
    return torch.stack([sxx, syy, sxy], dim=-1) * inv[:, None]


def floe_stress(state: FloeState, cf_x, cf_y, px, py, f_valid) -> torch.Tensor:
    """Virial contact stress per floe, [N, 3] (xx, yy, xy), from per-contact
    forces and points.

    cf_x/cf_y/px/py: [N, K] per-contact forces and contact points;
    f_valid: [N, K] contact mask.  Mirrors calc_trajectory.m:9-13, which
    forms (sym of) Σ (p - r) ⊗ F over the interaction list.
    """
    rx = px - state.x[:, None]
    ry = py - state.y[:, None]
    w = f_valid.to(cf_x.dtype)
    sxx = torch.sum(w * rx * cf_x, dim=1)
    syy = torch.sum(w * ry * cf_y, dim=1)
    sxy = torch.sum(w * 0.5 * (rx * cf_y + ry * cf_x), dim=1)
    denom = 2.0 * state.area * state.h
    # The symmetrized sum doubles the diagonal and averages the off-diagonal.
    return torch.stack([sxx, syy, sxy], dim=-1) * (2.0 / denom)[:, None]


def push_stress(state: FloeState, stress_new: torch.Tensor, step: int):
    """Write this step's stress into the ring buffer and update the mean.

    Global ring index ``step % W``; the mean covers the full window,
    zero entries of a not-yet-filled ring included (``mean(StressH, 3)``).
    It is kept incrementally and re-reduced exactly once per ring wrap.
    ``step`` is a host int, so the reset branch is a host branch.
    """
    w = state.stress_hist.shape[1]
    idx = int(step) % w
    old = state.stress_hist[:, idx, :]
    hist = state.stress_hist.clone()
    hist[:, idx, :] = stress_new
    if idx == 0:
        stress = torch.mean(hist, dim=1)               # periodic exact reset
    else:
        stress = state.stress + (stress_new - old) / w
    return state.replace(stress_hist=hist, stress=stress)


def ocean_forcing(state: FloeState, forcing: Forcing, cfg: SimConfig):
    """Area-averaged ocean/atm force per unit area + torque (FxOA, FyOA,
    torqueOA), including the Coriolis terms (calc_trajectory.m:121-165).

    Returns (fx_oa, fy_oa, tq_oa), each [N].
    """
    phys = cfg.physics

    # Rotate the Monte-Carlo sample points into the world frame.
    xr = rotate(state.alpha, state.mc_xy)                   # [N, P, 2]
    xr_x, xr_y = xr[..., 0], xr[..., 1]
    gx = xr_x + state.x[:, None]
    gy = xr_y + state.y[:, None]

    uo, vo, ua, va = sample_forcing(forcing, gx, gy)

    mask = state.mc_in.to(gx.dtype)
    n_in = torch.clamp(torch.sum(mask, dim=1), min=1.0)

    # Uniform atmospheric stress from the mean 10-m wind over the floe
    # (calc_trajectory.m:139-141).
    u10 = torch.sum(ua * mask, dim=1) / n_in
    v10 = torch.sum(va * mask, dim=1) / n_in
    wind_speed = torch.sqrt(u10**2 + v10**2)
    fx_atm = phys.rho_air * phys.cd_atm * wind_speed * u10
    fy_atm = phys.rho_air * phys.cd_atm * wind_speed * v10

    # Local ice velocity at each sample (rigid body): U - ksi*y_r, V + ksi*x_r
    uice = state.u[:, None] - state.ksi[:, None] * xr_y
    vice = state.v[:, None] + state.ksi[:, None] * xr_x

    du = uo - uice
    dv = vo - vice
    sp = torch.sqrt(du**2 + dv**2)
    ca = math.cos(phys.turn_angle)
    sa = math.sin(phys.turn_angle)
    tau_x = phys.rho_ocean * phys.cd_ocean * sp * (ca * du - sa * dv)
    tau_y = phys.rho_ocean * phys.cd_ocean * sp * (sa * du + ca * dv)

    # SSH-tilt pressure gradient (calc_trajectory.m:143-144).
    m_over_a = (state.mass / state.area)[:, None]
    fx_tilt = -m_over_a * phys.f_coriolis * vo
    fy_tilt = +m_over_a * phys.f_coriolis * uo

    fx = tau_x + fx_atm[:, None] + fx_tilt
    fy = tau_y + fy_atm[:, None] + fy_tilt

    # Torque BEFORE adding Coriolis (which has none) — calc_trajectory.m:156.
    torque = -fx * xr_y + fy * xr_x

    # Remaining Coriolis of the floe-mean velocity (calc_trajectory.m:159-160)
    # — deliberately folded into the cached force like the reference.
    fx = fx + m_over_a * phys.f_coriolis * state.v[:, None]
    fy = fy - m_over_a * phys.f_coriolis * state.u[:, None]

    fx_oa = torch.sum(fx * mask, dim=1) / n_in
    fy_oa = torch.sum(fy * mask, dim=1) / n_in
    tq_oa = torch.sum(torque * mask, dim=1) / n_in
    return fx_oa, fy_oa, tq_oa


def trajectory_update(
    state: FloeState,
    forcing: Forcing,
    cf_x: torch.Tensor,          # [N] total contact force
    cf_y: torch.Tensor,
    cf_t: torch.Tensor,          # [N] total contact torque
    heat_flux: float,
    do_int: bool,                # host bool: refresh ocean forcing?
    cfg: SimConfig,
) -> FloeState:
    """AB2 trajectory update for all floes (masked)."""
    cl = cfg.clamps
    dt = cfg.numerics.dt
    n_b = cfg.n_boundary
    dev = state.x.device

    alive = state.alive

    # --- clamps (calc_trajectory.m:36-46) ---------------------------------
    h = torch.clamp(state.h, max=cl.max_thickness)
    tiny = state.mass < cl.min_mass
    mass = torch.where(tiny, torch.full_like(state.mass, cl.dead_mass),
                       state.mass)
    alive = alive & ~tiny

    # force-magnitude clamp: divide by 10 until |F| <= m/(5 dt).  The loop
    # divides both components and the torque by the same power of 10.
    fmax = torch.maximum(torch.abs(cf_x), torch.abs(cf_y))
    limit = mass / (cl.force_dt_factor * dt)
    # number of /10 steps: ceil(log10(fmax/limit)) when exceeding
    ratio = torch.where(fmax > limit, fmax / limit, torch.ones_like(fmax))
    k10 = torch.ceil(torch.log10(ratio))
    scale = torch.pow(10.0, -k10)
    cf_x = cf_x * scale
    cf_y = cf_y * scale
    cf_t = cf_t * scale

    # --- thermodynamic growth (calc_trajectory.m:76-80) -------------------
    dh = heat_flux * dt / torch.clamp(h, min=1e-6)
    grow = (h - dh) / torch.clamp(h, min=1e-6)
    mass = grow * mass
    inertia = grow * state.inertia
    h = h - dh

    st = state.replace(h=h, mass=mass, inertia=inertia)

    # --- out-of-ocean-grid kill (calc_trajectory.m:116-117) ---------------
    xmin, xmax, ymin, ymax = forcing.extent()
    idx = torch.arange(st.n, device=dev)
    alive = alive & (
        (st.x + st.rmax < xmax) & (st.x - st.rmax > xmin)
        & (st.y + st.rmax < ymax) & (st.y - st.rmax > ymin)
    ) | (idx < n_b)

    # --- ocean forcing cache (calc_trajectory.m:94,121-166) ---------------
    # The MC-point sampling dominates the step, so it runs only when some
    # floe refreshes: every n_ocean_force steps (do_int, known on the host)
    # or when a live floe is thinner than 0.1 m.  The thin-floe test depends
    # on device data, so on the other steps it costs one host sync.
    if cfg.physics.ocean_coupling:
        thin = st.h < 0.1
        need = do_int
        if not need:
            with sync("thin"):
                need = bool(torch.any(thin & alive))
        if need:
            fresh = ocean_forcing(st, forcing, cfg)
            refresh = thin | do_int
            fx_oa = torch.where(refresh, fresh[0], st.fx_oa)
            fy_oa = torch.where(refresh, fresh[1], st.fy_oa)
            tq_oa = torch.where(refresh, fresh[2], st.tq_oa)
        else:
            fx_oa, fy_oa, tq_oa = st.fx_oa, st.fy_oa, st.tq_oa
    else:
        # uniaxial case: all motion boundary-driven (README.md 1h)
        fx_oa = torch.zeros_like(st.fx_oa)
        fy_oa = torch.zeros_like(st.fy_oa)
        tq_oa = torch.zeros_like(st.tq_oa)

    # --- AB2 position update with OLD velocity (calc_trajectory.m:174-177) -
    x_new = st.x + 1.5 * dt * st.u - 0.5 * dt * st.dx_p
    y_new = st.y + 1.5 * dt * st.v - 0.5 * dt * st.dy_p
    alpha_new = st.alpha + 1.5 * dt * st.ksi - 0.5 * dt * st.dalpha_p
    dx_p = st.u
    dy_p = st.v
    dalpha_p = st.ksi

    # --- acceleration with cap (calc_trajectory.m:181-204) ----------------
    du_dt = (fx_oa * st.area + cf_x) / mass
    dv_dt = (fy_oa * st.area + cf_y) / mass
    cap = cl.accel_h_factor * h / dt
    exceed_u = torch.abs(dt * du_dt) > cl.accel_h_factor * h
    exceed_v = torch.abs(dt * dv_dt) > cl.accel_h_factor * h
    one = torch.ones_like(du_dt)
    frac_u = torch.where(exceed_u,
                         cap / torch.clamp(torch.abs(du_dt), min=1e-30), one)
    frac_v = torch.where(exceed_v,
                         cap / torch.clamp(torch.abs(dv_dt), min=1e-30), one)
    frac = torch.where(
        exceed_u & exceed_v, torch.minimum(frac_u, frac_v),
        torch.where(exceed_u, frac_u, torch.where(exceed_v, frac_v, one)),
    )
    du_dt = frac * du_dt
    dv_dt = frac * dv_dt

    u_new = st.u + 1.5 * dt * du_dt - 0.5 * dt * st.du_p
    v_new = st.v + 1.5 * dt * dv_dt - 0.5 * dt * st.dv_p

    # --- spin update with caps (calc_trajectory.m:210-219) ----------------
    dksi_dt = (tq_oa * st.area + cf_t) / st.inertia
    dksi_dt = frac * dksi_dt        # reference applies frac to spin too (:212)
    ksi_new = st.ksi + 1.5 * dt * dksi_dt - 0.5 * dt * st.dksi_p
    ksi_new = torch.clamp(ksi_new, -cl.max_spin, cl.max_spin)

    # --- strain-rate tensor (calc_trajectory.m:224-234) -------------------
    # Boundary integral of the rigid-body velocity field over c_alpha.
    verts_rot = rotate(alpha_new, st.verts_body)            # [N, V, 2]
    vx = verts_rot[..., 0]
    vy = verts_rot[..., 1]
    u_b = u_new[:, None] - ksi_new[:, None] * vy
    v_b = v_new[:, None] + ksi_new[:, None] * vx
    d_u = torch.roll(u_b, -1, dims=1) - u_b
    d_v = torch.roll(v_b, -1, dims=1) - v_b
    d_x = torch.roll(vx, -1, dims=1) - vx
    d_y = torch.roll(vy, -1, dims=1) - vy
    inv2a = 0.5 / st.area
    du_dx = torch.sum(d_u * d_y, dim=1) * inv2a
    du_dy = torch.sum(d_u * d_x, dim=1) * inv2a
    dv_dx = torch.sum(d_v * d_y, dim=1) * inv2a
    dv_dy = torch.sum(d_v * d_x, dim=1) * inv2a
    strain = torch.stack([du_dx, dv_dy, 0.5 * (du_dy + dv_dx)], dim=-1)

    # --- masked commit: boundary floes (slots < n_boundary) and dead floes
    # keep their state frozen -----------------------------------------------
    movable = alive & (idx >= n_b)

    def sel(new, old):
        return torch.where(movable, new, old)

    return st.replace(
        x=sel(x_new, st.x), y=sel(y_new, st.y),
        alpha=sel(alpha_new, st.alpha),
        u=sel(u_new, st.u), v=sel(v_new, st.v),
        ksi=sel(ksi_new, st.ksi),
        dx_p=sel(dx_p, st.dx_p), dy_p=sel(dy_p, st.dy_p),
        dalpha_p=sel(dalpha_p, st.dalpha_p),
        du_p=sel(du_dt, st.du_p), dv_p=sel(dv_dt, st.dv_p),
        dksi_p=sel(dksi_dt, st.dksi_p),
        fx_oa=sel(fx_oa, st.fx_oa),
        fy_oa=sel(fy_oa, st.fy_oa),
        tq_oa=sel(tq_oa, st.tq_oa),
        strain=torch.where(movable[:, None], strain, st.strain),
        h=torch.where(alive, h, st.h),
        mass=torch.where(alive, mass, st.mass),
        inertia=torch.where(alive, inertia, st.inertia),
        alive=alive,
    )
