"""The port's figures against the JAX package's, on the CPU with Agg.

* ``_floe_polys`` gives identical vertex lists and floe indices, periodic
  (with the ghost copies) and walled; rotated floes' vertices agree to
  1e-9 m (the two packages' ``verts_world`` round differently).
* ``plot_basic`` for every ``color_by`` (with the forcing quiver) and
  ``plot_eulerian``, drawn from the same state in both packages: the RGBA
  buffers are equal pixel for pixel.
* A short out-of-box ``Simulation(plot_output=True, output_dir=...)`` writes
  the same figure file names as the JAX driver's.
"""

from __future__ import annotations

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import subzero_tpu.plotting as jplot  # noqa: E402
from subzero_tpu.config import (  # noqa: E402
    CapacityConfig, NumericsConfig, ProcessConfig, SimConfig,
)
from subzero_tpu.diagnostics import eulerian_data  # noqa: E402
from subzero_tpu.forcing import gyre_ocean  # noqa: E402
from subzero_tpu.init import initial_state  # noqa: E402
from subzero_tpu.sim import Simulation  # noqa: E402

import subzero_tpu_torch.plotting as tplot  # noqa: E402
import subzero_tpu_torch.sim as tsim  # noqa: E402
from subzero_tpu_torch.convert import (  # noqa: E402
    forcing_from_numpy, state_from_numpy,
)
from subzero_tpu_torch.diagnostics import EulerianData  # noqa: E402
from test_torch_init import jax_numpy, port_cfg  # noqa: E402

torch.set_num_threads(1)


def scene(periodic: bool, rotated: bool = True):
    """The out-of-box recipe's state (10 Voronoi floes, float64) with
    random velocities, stresses and overlaps, so that every ``color_by``
    shades something, and random angles unless ``rotated`` is False, in
    both packages; periodic or walled."""
    cfg = SimConfig(capacity=CapacityConfig(max_floes=16),
                    numerics=NumericsConfig(dtype="float64"),
                    processes=ProcessConfig(periodic=periodic))
    st, modulus = initial_state(cfg, 1.0, 10, 0.25, seed=2)
    rng = np.random.default_rng(4)
    n = st.n
    st = st.replace(
        x=st.x + (rng.uniform(-4e4, 4e4, n) if periodic else 0.0),
        u=jnp.asarray(rng.uniform(-0.2, 0.2, n)),
        v=jnp.asarray(rng.uniform(-0.2, 0.2, n)),
        alpha=jnp.asarray(rng.uniform(-0.3, 0.3, n) * rotated),
        stress=jnp.asarray(rng.normal(0.0, 1e3, (n, 3))),
        overlap_area=jnp.asarray(rng.uniform(0.0, 1e6, n)))
    fc = gyre_ocean()
    return (cfg, st, fc), (port_cfg(cfg),
                           state_from_numpy(jax_numpy(st), device="cpu"),
                           forcing_from_numpy(jax_numpy(fc), device="cpu",
                                              dtype="float32"))


def pixels(fig) -> np.ndarray:
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("periodic", [True, False])
def test_floe_polys_identical(periodic, rotated):
    # Rotated floes' world vertices differ in the last bit between the
    # packages (``verts_world``: JAX rotates with an einsum, the port with
    # explicit products), so they are held to 1e-9 m there.
    (jcfg, jst, _), (pcfg, pst, _) = scene(periodic, rotated)
    jp, ji = jplot._floe_polys(jst, jcfg, periodic)
    pp, pi = tplot._floe_polys(pst, pcfg, periodic)
    np.testing.assert_array_equal(ji, pi)
    assert len(jp) == len(pp) > (10 if periodic else 0)
    for a, b in zip(jp, pp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 if rotated else 0)


@pytest.mark.parametrize("color_by", [None, "stress", "overlap", "h",
                                      "speed"])
def test_plot_basic_pixels_identical(color_by):
    (jcfg, jst, jfc), (pcfg, pst, pfc) = scene(periodic=True)
    a = pixels(jplot.plot_basic(jst, jcfg, jfc, title="t",
                                color_by=color_by))
    b = pixels(tplot.plot_basic(pst, pcfg, pfc, title="t",
                                color_by=color_by))
    assert a.shape == b.shape
    assert np.array_equal(a, b)
    assert len(np.unique(a.reshape(-1, 4), axis=0)) > 10   # drew something


def test_plot_eulerian_pixels_identical():
    (jcfg, jst, _), (pcfg, _, _) = scene(periodic=False)
    jeu = eulerian_data(jst, jcfg, 8, 6)
    peu = EulerianData(*(torch.from_numpy(np.array(f)) for f in jeu))
    a = pixels(jplot.plot_eulerian(jeu, jcfg))
    b = pixels(tplot.plot_eulerian(peu, pcfg))
    assert np.array_equal(a, b)


def test_plot_basic_rejects_unknown_color():
    _, (pcfg, pst, _) = scene(periodic=False)
    with pytest.raises(ValueError, match="color_by"):
        tplot.plot_basic(pst, pcfg, color_by="colour")
    plt.close("all")


def test_simulation_plot_output_writes_the_same_figures(tmp_path):
    cfg = SimConfig(capacity=CapacityConfig(max_floes=16),
                    numerics=NumericsConfig(dtype="float64"),
                    processes=ProcessConfig(corners=False, n_dt_out=3))
    st, modulus = initial_state(cfg, 1.0, 10, 0.25, seed=0)
    fc = gyre_ocean()
    runs = {}
    for name, make in (
            ("jax", lambda d: Simulation(cfg=cfg, state=st, forcing=fc,
                                         modulus=modulus, output_dir=d,
                                         plot_output=True)),
            ("port", lambda d: tsim.Simulation(
                cfg=port_cfg(cfg),
                state=state_from_numpy(jax_numpy(st), device="cpu"),
                forcing=forcing_from_numpy(jax_numpy(fc), device="cpu",
                                           dtype="float32"),
                modulus=modulus, output_dir=d, plot_output=True))):
        d = tmp_path / name
        d.mkdir()
        make(d).run(6)
        runs[name] = sorted(p.name for p in d.glob("fig*.png"))
    assert runs["port"] == runs["jax"] == ["fig0000003.png", "fig0000006.png"]
