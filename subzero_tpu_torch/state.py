"""Fixed-capacity SoA floe state on torch tensors.

Port of ``subzero_tpu/state.py``: the whole population lives in one frozen
dataclass of ``[N, ...]`` tensors with an ``alive`` mask; slots
``[0, n_boundary)`` are immovable boundary/topography floes.  Same 29 fields,
shapes and dtypes as the JAX ``FloeState`` (``nv`` int32, ``alive`` and
``mc_in`` bool, every other field the float dtype).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimConfig
from .device import resolve_device
from .geometry.polygon import pad_polygon
from .kernels.mc_mask import mc_mask_cuda

__all__ = [
    "FloeState",
    "empty_state",
    "make_floe_arrays",
    "mc_inside",
    "state_from_polygons",
    "torch_dtype",
]


def torch_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"float64"`` (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "float64": torch.float64}[str(name)]


@dataclasses.dataclass(frozen=True)
class FloeState:
    """SoA floe population, shapes ``[N]`` / ``[N, V, 2]`` / etc.

    Mirrors the reference floe schema (initialize_floe_values.m:12-52):

      verts_body  [N,V,2]  c0: body-frame boundary about centroid (unrotated)
      nv          [N]      valid vertex count (padding = vertex 0)
      x, y        [N]      Xi, Yi centroid position
      alpha       [N]      alpha_i rotation angle
      u, v        [N]      Ui, Vi velocity
      ksi         [N]      ksi_ice angular velocity
      h           [N]      thickness
      mass        [N]      mass
      inertia     [N]      inertia_moment (polar, about centroid)
      area        [N]      polygon area
      rmax        [N]      bounding radius
      dx_p..dksi_p [N]     Adams-Bashforth-2 predecessor tendencies
      mc_xy       [N,P,2]  Monte-Carlo sample points (body frame)
      mc_in       [N,P]    inpolygon mask of the samples
      fx_oa,fy_oa,tq_oa [N] cached ocean/atm force+torque per unit area
      stress_hist [N,W,3]  stress ring buffer (xx, yy, xy)
      stress      [N,3]    mean of stress_hist (the floe 'Stress')
      strain      [N,3]    boundary-integral strain tensor
      overlap_area[N]      total contact overlap area this step
      alive       [N]      liveness mask (bool)
    """

    verts_body: torch.Tensor
    nv: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    alpha: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    ksi: torch.Tensor
    h: torch.Tensor
    mass: torch.Tensor
    inertia: torch.Tensor
    area: torch.Tensor
    rmax: torch.Tensor
    dx_p: torch.Tensor
    dy_p: torch.Tensor
    dalpha_p: torch.Tensor
    du_p: torch.Tensor
    dv_p: torch.Tensor
    dksi_p: torch.Tensor
    mc_xy: torch.Tensor
    mc_in: torch.Tensor
    fx_oa: torch.Tensor
    fy_oa: torch.Tensor
    tq_oa: torch.Tensor
    stress_hist: torch.Tensor
    stress: torch.Tensor
    strain: torch.Tensor
    overlap_area: torch.Tensor
    alive: torch.Tensor

    @property
    def n(self) -> int:
        return self.verts_body.shape[0]

    @property
    def v_cap(self) -> int:
        return self.verts_body.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kw) -> "FloeState":
        return dataclasses.replace(self, **kw)

    # -- derived geometry ---------------------------------------------------

    def rot_matrix(self) -> torch.Tensor:
        """[N, 2, 2] rotation by alpha (calc_trajectory.m:221)."""
        c, s = torch.cos(self.alpha), torch.sin(self.alpha)
        return torch.stack(
            [torch.stack([c, -s], -1), torch.stack([s, c], -1)], dim=-2)

    def verts_rot(self) -> torch.Tensor:
        """c_alpha: body-frame boundary rotated by alpha, [N, V, 2]."""
        return rotate(self.alpha, self.verts_body)

    def verts_world(self) -> torch.Tensor:
        """World-frame boundary c_alpha + (Xi, Yi), [N, V, 2]."""
        pos = torch.stack([self.x, self.y], dim=-1)
        return self.verts_rot() + pos[:, None, :]


def rotate(alpha: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate per-floe point sets ``pts [N, M, 2]`` by ``alpha [N]``."""
    c = torch.cos(alpha)[:, None]
    s = torch.sin(alpha)[:, None]
    px, py = pts[..., 0], pts[..., 1]
    return torch.stack([c * px - s * py, s * px + c * py], dim=-1)


def empty_state(cfg: SimConfig, dtype=None, device=None) -> FloeState:
    """All-dead state at the configured capacities."""
    dev = resolve_device(device)
    n = cfg.capacity.max_floes
    v = cfg.capacity.verts_now
    p = cfg.capacity.n_mc_points
    w = cfg.capacity.stress_window
    dt = torch_dtype(dtype or cfg.numerics.dtype)

    def zf(*s):
        return torch.zeros(s, dtype=dt, device=dev)

    def of(*s):
        return torch.ones(s, dtype=dt, device=dev)

    return FloeState(
        verts_body=zf(n, v, 2),
        nv=torch.zeros((n,), dtype=torch.int32, device=dev),
        x=zf(n), y=zf(n), alpha=zf(n), u=zf(n), v=zf(n), ksi=zf(n),
        h=of(n), mass=of(n), inertia=of(n), area=of(n), rmax=zf(n),
        dx_p=zf(n), dy_p=zf(n), dalpha_p=zf(n),
        du_p=zf(n), dv_p=zf(n), dksi_p=zf(n),
        mc_xy=zf(n, p, 2),
        mc_in=torch.zeros((n, p), dtype=torch.bool, device=dev),
        fx_oa=zf(n), fy_oa=zf(n), tq_oa=zf(n),
        stress_hist=zf(n, w, 3), stress=zf(n, 3), strain=zf(n, 3),
        overlap_area=zf(n),
        alive=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def make_floe_arrays(
    polys: list[np.ndarray],
    heights: np.ndarray,
    cfg: SimConfig,
    seed: int = 0,
    v_cap: int | None = None,
    device=None,
):
    """Host-side floe construction from world-frame polygons.

    Numpy equivalent of ``initialize_floe_values.m``: centroid, body-frame
    contour, area, inertia, rmax, Monte-Carlo sample mask.  A copy of the
    JAX package's function, so the same seed gives the same Monte-Carlo
    points in both packages, and the same mask.

    Returns a dict of numpy arrays for the first ``len(polys)`` slots.  For
    a CUDA ``device`` the mask is computed there, by the kernel of
    ``kernels/mc_mask.py`` from the points uploaded once in float64, and
    ``mc_xy`` (float64) and ``mc_in`` are tensors on that device; for any
    other device, or none, the host computes it (``mc_inside``).
    """
    n = len(polys)
    v = v_cap or cfg.capacity.verts_now
    p = cfg.capacity.n_mc_points
    rng = np.random.default_rng(seed)
    heights = np.broadcast_to(np.asarray(heights, np.float64), (n,)).copy()

    verts = np.zeros((n, v, 2))
    nv = np.zeros((n,), np.int32)

    for i, poly in enumerate(polys):
        verts[i], nv[i] = pad_polygon(poly, v)

    # All geometric properties in one vectorized numpy pass (the padded-edge
    # convention makes every boundary integral a plain masked sum).
    x0, y0 = verts[..., 0], verts[..., 1]
    x1 = np.roll(x0, -1, axis=1)
    y1 = np.roll(y0, -1, axis=1)
    w = x0 * y1 - x1 * y0
    area = 0.5 * np.sum(w, axis=1)
    cx = np.sum(w * (x0 + x1), axis=1) / (6.0 * area)
    cy = np.sum(w * (y0 + y1), axis=1) / (6.0 * area)
    verts = verts - np.stack([cx, cy], 1)[:, None, :]  # body frame (c0)

    # recompute moments about the centroid (initialize_floe_values.m:19)
    x0, y0 = verts[..., 0], verts[..., 1]
    x1 = np.roll(x0, -1, axis=1)
    y1 = np.roll(y0, -1, axis=1)
    w = x0 * y1 - x1 * y0
    ixx = np.sum(w * ((y0 + y1) ** 2 - y0 * y1), axis=1) / 12.0
    iyy = np.sum(w * ((x0 + x1) ** 2 - x0 * x1), axis=1) / 12.0
    inertia = np.abs(ixx + iyy) * heights * cfg.physics.rho_ice
    rmax = np.sqrt(np.max(x0**2 + y0**2, axis=1))
    mass = area * heights * cfg.physics.rho_ice

    # Monte-Carlo masks: uniform in the rmax bounding square (body frame),
    # crossing-number PIP.
    mc_xy = rmax[:, None, None] * (2.0 * rng.random((n, p, 2)) - 1.0)
    if device is not None and torch.device(device).type == "cuda":
        mc_xy = torch.from_numpy(mc_xy).to(device)
        mc_in = mc_mask_cuda(torch.from_numpy(verts).to(device),
                             torch.from_numpy(nv).to(device), mc_xy)
    else:
        mc_in = mc_inside(verts, mc_xy)

    return dict(
        verts_body=verts, nv=nv, x=cx, y=cy,
        h=heights, mass=mass, inertia=inertia, area=area, rmax=rmax,
        mc_xy=mc_xy, mc_in=mc_in,
        alive=np.ones((n,), bool),
    )


def mc_inside(verts: np.ndarray, mc_xy: np.ndarray) -> np.ndarray:
    """Which points ``mc_xy`` ``[n, p, 2]`` lie inside the body-frame
    polygons ``verts`` ``[n, v, 2]`` (padded with vertex 0): the JAX
    package's crossing-number test, fully vectorized [n, p] x [n, v] in
    float64 on the host.  The plain version of ``kernels/mc_mask.py``."""
    x0, y0 = verts[..., 0], verts[..., 1]
    x1 = np.roll(x0, -1, axis=1)
    y1 = np.roll(y0, -1, axis=1)
    px = mc_xy[..., 0][:, :, None]
    py = mc_xy[..., 1][:, :, None]
    ex0, ey0 = x0[:, None, :], y0[:, None, :]
    ex1, ey1 = x1[:, None, :], y1[:, None, :]
    cond = (ey0 > py) != (ey1 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(ey1 == ey0, 0.0, (py - ey0) / np.where(
            ey1 == ey0, 1.0, ey1 - ey0))
    xint = ex0 + t * (ex1 - ex0)
    return (np.sum(cond & (px < xint), axis=2) % 2) == 1


def state_from_polygons(
    polys: list[np.ndarray],
    heights,
    cfg: SimConfig,
    seed: int = 0,
    velocities: np.ndarray | None = None,
    device=None,
    dtype=None,
) -> FloeState:
    """Build a FloeState with floes in slots [0, len(polys)) and the rest
    dead padding, on ``device`` (default CUDA) in ``dtype`` (default
    ``cfg.numerics.dtype``)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.numerics.dtype)
    n_cap = cfg.capacity.max_floes
    if len(polys) > n_cap:
        raise ValueError(f"{len(polys)} floes > capacity {n_cap}")
    arrs = make_floe_arrays(polys, heights, cfg, seed, device=dev)
    proto = empty_state(cfg, dtype=dt, device="cpu")
    # Assemble host-side, one transfer per field at the end; a field the
    # device computed (the Monte-Carlo points and mask) is assembled there.
    fields = {f.name: getattr(proto, f.name)
              for f in dataclasses.fields(FloeState)}
    for k, val in arrs.items():
        if torch.is_tensor(val):
            buf = torch.zeros_like(fields[k], device=val.device)
            buf[: len(polys)] = val.to(buf.dtype)
        else:
            buf = fields[k].clone()
            buf[: len(polys)] = torch.from_numpy(np.asarray(val)).to(
                buf.dtype)
        fields[k] = buf
    if velocities is not None:
        vel = np.zeros((n_cap, 2))
        vel[: len(polys)] = velocities
        fields["u"] = torch.from_numpy(vel[:, 0].copy()).to(dt)
        fields["v"] = torch.from_numpy(vel[:, 1].copy()).to(dt)
    return FloeState(**{k: t.to(dev) for k, t in fields.items()})
