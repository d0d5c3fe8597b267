"""Floe-field plotting — port of ``subzero_tpu/plotting.py``, the equivalents
of the reference ``plotting/`` module (``plot_basic.m``,
``plot_basic_stress.m``, ``plot_Floes.m``,
``plot_Floes_poly_doublePeriodicBC.m``): floe patches over an ocean quiver,
optional stress/overlap shading, ghost-floe rendering for periodic domains.

Figures are drawn on the host from one host copy of each tensor they read,
with matplotlib's Agg backend (files, the reference's ``figs/`` convention
at Subzero.m:265-272).  matplotlib is imported inside the functions, so the
rest of the port runs on machines without it.
"""

from __future__ import annotations

import numpy as np

from .config import SimConfig
from .state import FloeState


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import PolyCollection

    return plt, PolyCollection


def _floe_polys(state: FloeState, cfg: SimConfig, periodic: bool):
    """World-frame vertex lists for live floes (+ periodic ghosts)."""
    alive = _host(state.alive)
    nv = _host(state.nv)
    verts = _host(state.verts_world())
    lx, ly = cfg.domain.lx, cfg.domain.ly
    polys, idxs = [], []
    shifts = [(0.0, 0.0)]
    if periodic:
        shifts += [(-2 * lx, 0), (2 * lx, 0), (0, -2 * ly), (0, 2 * ly)]
    for i in range(state.n):
        if not alive[i] or nv[i] < 3:
            continue
        base = verts[i, : nv[i]]
        for sx, sy in shifts:
            p = base + [sx, sy]
            if p[:, 0].max() < -lx or p[:, 0].min() > lx:
                continue
            if p[:, 1].max() < -ly or p[:, 1].min() > ly:
                continue
            polys.append(p)
            idxs.append(i)
    return polys, np.array(idxs, dtype=int)


def plot_basic(state: FloeState, cfg: SimConfig, forcing=None,
               path: str | None = None, title: str = "",
               color_by: str | None = None):
    """Floe patches over the ocean current quiver (plot_basic.m).

    color_by: None (uniform ice color), "stress" (max principal stress,
    plot_basic_stress.m), "overlap", "h", or "speed".
    """
    plt, PolyCollection = _pyplot()
    periodic = cfg.processes.periodic
    polys, idxs = _floe_polys(state, cfg, periodic)
    lx, ly = cfg.domain.lx, cfg.domain.ly

    fig, ax = plt.subplots(figsize=(7, 7 * ly / lx))
    ax.set_xlim(-lx, lx)
    ax.set_ylim(-ly, ly)
    ax.set_aspect("equal")

    if forcing is not None:
        xo = float(forcing.x0) + np.arange(forcing.nx) * float(forcing.dx)
        yo = float(forcing.y0) + np.arange(forcing.ny) * float(forcing.dx)
        sk = max(len(xo) // 20, 1)
        xg, yg = np.meshgrid(xo[::sk], yo[::sk])
        ax.quiver(xg, yg, _host(forcing.uo)[::sk, ::sk],
                  _host(forcing.vo)[::sk, ::sk],
                  color="0.7", zorder=0, width=2e-3)

    if polys:
        if color_by is None:
            fc = ["#dfefff"] * len(polys)
            pc = PolyCollection(polys, facecolors=fc, edgecolors="k",
                                linewidths=0.5)
        else:
            if color_by == "stress":
                s = _host(state.stress)
                tr2 = 0.5 * (s[:, 0] + s[:, 1])
                disc = np.sqrt(0.25 * (s[:, 0] - s[:, 1]) ** 2 + s[:, 2] ** 2)
                vals = (tr2 + disc)[idxs]
            elif color_by == "overlap":
                vals = _host(state.overlap_area)[idxs]
            elif color_by == "h":
                vals = _host(state.h)[idxs]
            elif color_by == "speed":
                vals = np.hypot(_host(state.u), _host(state.v))[idxs]
            else:
                raise ValueError(f"unknown color_by={color_by!r}")
            pc = PolyCollection(polys, array=vals, cmap="viridis",
                                edgecolors="k", linewidths=0.4)
            fig.colorbar(pc, ax=ax, label=color_by, shrink=0.8)
        ax.add_collection(pc)

    # mark boundary/topography floes
    n_b = cfg.n_boundary
    if n_b:
        topo = [p for p, i in zip(polys, idxs) if i < n_b]
        if topo:
            ax.add_collection(PolyCollection(
                topo, facecolors="0.4", edgecolors="k"))

    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_eulerian(eu, cfg: SimConfig, path: str | None = None):
    """Panel plot of the coarse Eulerian fields (calc_eulerian_data output)."""
    plt, _ = _pyplot()
    fields = [("c", eu.c), ("h", eu.h), ("u", eu.u), ("v", eu.v),
              ("mass", eu.mtot), ("max principal stress", eu.stress_max_eig)]
    fig, axes = plt.subplots(2, 3, figsize=(13, 8))
    lx, ly = cfg.domain.lx, cfg.domain.ly
    for ax, (name, f) in zip(axes.ravel(), fields):
        im = ax.imshow(_host(f), extent=[-lx, lx, -ly, ly],
                       origin="upper", cmap="viridis")
        ax.set_title(name)
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
