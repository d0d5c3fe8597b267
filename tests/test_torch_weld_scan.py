"""The port's weld pass against the JAX package's, on the same host views.

``weld_pass`` (``subzero_tpu_torch/processes/weld.py``) finds its weld
candidates and the neighbours a union absorbs with numpy row tests over
each bin.  The JAX package's ``subzero_tpu.processes.weld.weld_pass`` is
the oracle: a Python loop over every pair of entries in a bin, fed the same
``HostView``.  The scans only filter, so on every field both must return
the same edit bit for bit (kills, dissolve kills, reshapes, births) and
leave the generator in the same state: the clips and the draws happen in
the same order.

The fields, each in float32 and float64 host views and with several
seeds: a periodic field whose seam floes have ghost entries, in 2x2 bins
and in one bin (where a floe's own ghost shares its bin), a walled field
whose first two slots are boundary floes, a field with slots hidden
through ``HostView.masked`` (as ``Lifecycle._guarded`` hides them), a field
with floes at and above ``max_weld_area``, and a dense field where unions
absorb the small floes they cover.  ``weld.pairs`` and ``weld.clips`` are
held to the oracle's own loop iterations and ``poly_boolean`` calls,
counted by a line tracer, and read back from ``Lifecycle.pass_times``
after a weld boundary.
"""

from __future__ import annotations

import collections
import inspect
import sys

import numpy as np
import pytest
import torch

from subzero_tpu.processes.weld import weld_pass as jax_weld_pass
from subzero_tpu_torch import trace
from subzero_tpu_torch.processes import lifecycle as tlc
from subzero_tpu_torch.config import (
    CapacityConfig, DomainConfig, NumericsConfig, ProcessConfig, SimConfig,
)
from subzero_tpu_torch.processes.host import extract_view
from subzero_tpu_torch.processes.weld import weld_pass
from subzero_tpu_torch.state import state_from_polygons

torch.set_num_threads(1)

LX = 1e5


# -- the oracle: the JAX package's pair loops, traced line by line -----------

def _oracle_lines() -> dict[str, set[int]]:
    """Line numbers of the oracle's statements that the counts tally: the
    first statement of each pair loop's body, each ``poly_boolean`` call,
    and the absorption of a neighbour."""
    src, first = inspect.getsourcelines(jax_weld_pass)

    def lines(text):
        return {first + n for n, line in enumerate(src) if text in line}

    return {"pairs": lines("j, s_j = entries[kb]")
            | lines("k2, s_k = entries[kc]"),
            "clips": lines("poly_boolean("),
            "absorbed": lines("absorb.append(k2)")}


def run_scalar(*args):
    """The oracle's edit, and how often its tallied lines ran."""
    code = jax_weld_pass.__code__
    hits: collections.Counter = collections.Counter()

    def local(frame, event, arg):
        if event == "line":
            hits[frame.f_lineno] += 1
        return local

    def calls(frame, event, arg):
        return local if frame.f_code is code else None

    outer = sys.gettrace()
    sys.settrace(calls)
    try:
        edit = jax_weld_pass(*args)
    finally:
        sys.settrace(outer)
    tally = {k: sum(hits[n] for n in ns)
             for k, ns in _oracle_lines().items()}
    return edit, tally


# -- fields -------------------------------------------------------------------

def cfg_of(dtype, periodic=False, n_boundary=0, max_floes=256):
    return SimConfig(
        numerics=NumericsConfig(dtype=dtype, dt=10.0),
        capacity=CapacityConfig(max_floes=max_floes, max_verts=16,
                                max_neighbors=4, n_mc_points=20,
                                stress_window=4),
        domain=DomainConfig(lx=LX, ly=LX),
        processes=ProcessConfig(periodic=periodic, welding=True),
        n_boundary=n_boundary, min_floe_size=1e5)


def convex(rng, cx, cy, r, nv=None):
    """A convex polygon inscribed in the circle of radius ``r`` about
    (cx, cy), counter-clockwise, with ``nv`` (else 5-9) vertices at random
    angles."""
    nv = nv or int(rng.integers(5, 10))
    a = np.sort(rng.uniform(0.0, 2 * np.pi, nv))
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)


def lattice(rng, n, spacing, r, jitter, span=0.8 * LX):
    """About ``n`` floes of radius ~``r`` on a jittered square lattice of
    pitch ``spacing`` centred in the domain: neighbours overlap where
    ``2 r`` exceeds the pitch."""
    side = int(np.ceil(np.sqrt(n)))
    c = (np.arange(side) - (side - 1) / 2) * spacing
    out = []
    for x in c:
        for y in c:
            if len(out) == n or max(abs(x), abs(y)) > span:
                continue
            out.append(convex(rng, x + rng.uniform(-jitter, jitter),
                              y + rng.uniform(-jitter, jitter),
                              r * rng.uniform(0.8, 1.2)))
    return out


def periodic_field(rng):
    """Floes along all four seams and in the corners (ghost entries in x,
    in y and both), overlapping their neighbours across the seam, among
    an interior lattice."""
    polys = lattice(rng, 49, 2.6e4, 1.5e4, 3e3)
    for t in np.linspace(-0.8 * LX, 0.8 * LX, 6):
        for s in (-1, 1):
            polys.append(convex(rng, s * (LX - rng.uniform(-4e3, 4e3)),
                                t + rng.uniform(-2e3, 2e3), 9e3))
            polys.append(convex(rng, t + rng.uniform(-2e3, 2e3),
                                s * (LX - rng.uniform(-4e3, 4e3)), 9e3))
    for sx in (-1, 1):
        for sy in (-1, 1):
            polys.append(convex(rng, sx * (LX - 3e3), sy * (LX - 3e3), 8e3))
    return dict(polys=polys, periodic=True, bins=(2, 2), max_area=1e9)


def walled_field(rng):
    """Two boundary floes in slots 0 and 1 (skipped by the pass, yet
    overlapping the lattice) before an overlapping lattice."""
    walls = [np.array([[-LX, -LX], [LX, -LX], [LX, -0.7 * LX],
                       [-LX, -0.7 * LX]]),
             np.array([[-LX, 0.7 * LX], [LX, 0.7 * LX], [LX, LX],
                       [-LX, LX]])]
    polys = walls + lattice(rng, 64, 2.4e4, 1.4e4, 3e3, span=0.9 * LX)
    return dict(polys=polys, n_boundary=2, bins=(3, 3), max_area=1e9)


def masked_field(rng):
    """An overlapping lattice with every fifth floe hidden through
    ``HostView.masked`` (the pass sees them dead)."""
    polys = lattice(rng, 81, 2.2e4, 1.3e4, 3e3)
    hidden = set(range(0, len(polys), 5)) | {len(polys) - 1}
    return dict(polys=polys, hidden=hidden, bins=(3, 3), max_area=1e9)


def capped_field(rng):
    """An overlapping lattice whose ``max_weld_area`` is one floe's own
    area: that floe sits at the cap, the larger ones above it."""
    polys = lattice(rng, 64, 2.4e4, 1.4e4, 3e3)
    return dict(polys=polys, bins=(2, 2), max_area="median")


def dense_field(rng):
    """Large floes overlapping heavily, each strewn with small floes that
    a union covers by more than 40% (chain absorption, weld.m:134-152),
    and small floes stacked in pairs half a metre apart (centres closer
    than 1 m are never weld candidates of each other)."""
    polys = lattice(rng, 36, 2.8e4, 1.8e4, 2e3)
    small = []
    for p in polys[:24]:
        c = p.mean(axis=0)
        for _ in range(3):
            a = rng.uniform(0, 2 * np.pi)
            rr = rng.uniform(0.5e4, 1.6e4)
            small.append(convex(rng, c[0] + rr * np.cos(a),
                                c[1] + rr * np.sin(a), 3e3))
    stacked = [p + [0.5, 0.0] for p in small[::6]]
    return dict(polys=polys + small + stacked, bins=(2, 2), max_area=1e9)


def periodic_one_bin_field(rng):
    """The periodic field in one bin (the 1x1 pyramid level): each seam
    floe's ghost entries share the bin with the floe itself.  One long floe
    across the seam, 2.2e5 m, reaches its own ghost 2e5 m away (its rmax
    passes lx), in slot 0, whose row comes first: a floe is never its own
    weld candidate."""
    f = periodic_field(rng)
    long_floe = np.array([[-0.9 * LX, 3e4], [1.3 * LX, 3e4],
                          [1.3 * LX, 4e4], [-0.9 * LX, 4e4]])
    return dict(f, polys=[long_floe] + f["polys"], bins=(1, 1),
                max_area=1e10)


FIELDS = {"periodic_seams": periodic_field,
          "periodic_one_bin": periodic_one_bin_field, "walled": walled_field,
          "masked": masked_field, "capped": capped_field,
          "dense_absorbing": dense_field}


def build(name, dtype, seed):
    """(view, cfg, bins, max_weld_area, hidden slots) of a field."""
    rng = np.random.default_rng(1000 + seed)
    f = FIELDS[name](rng)
    polys = f["polys"]
    cfg = cfg_of(dtype, periodic=f.get("periodic", False),
                 n_boundary=f.get("n_boundary", 0),
                 max_floes=-(-(len(polys) + 8) // 8) * 8)
    st = state_from_polygons(polys, 0.5, cfg, seed=seed, device="cpu")
    view = extract_view(st, cfg)
    max_area = f["max_area"]
    if max_area == "median":
        a = np.sort(view.area[view.alive])
        max_area = float(a[len(a) // 2])
    return view, cfg, f["bins"], max_area, f.get("hidden", set())


def bits(x):
    """A value as bytes, recursively: equal bits, not equal values."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (float, np.floating)):
        return np.float64(x).tobytes()
    if isinstance(x, dict):
        return {k: bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [bits(v) for v in x]
    return x


def edit_bits(edit) -> dict:
    return dict(
        kills=sorted(edit.kills), dissolve_kills=sorted(edit.dissolve_kills),
        dissolve_mass=bits(edit.dissolve_mass),
        export=bits(edit.export_mass),
        updates={k: bits(v) for k, v in edit.updates.items()},
        reshapes={k: bits(list(v)) for k, v in edit.reshapes.items()},
        births=[bits([f.poly, f.h, f.mass, f.u, f.v, f.ksi, f.dx_p, f.dy_p,
                      f.du_p, f.dv_p, f.dksi_p, f.strain,
                      list(f.stress_blend)]) for f in edit.new_floes])


def both(name, dtype, seed):
    """The oracle's and the pass's edits, generator states and counts."""
    view, cfg, (nx, ny), max_area, hidden = build(name, dtype, seed)
    out = {}
    with view.masked(dead_slots=hidden):
        rng = np.random.default_rng(seed)
        edit, tally = run_scalar(view, cfg, rng, nx, ny, max_area)
        out["scalar"] = (edit, rng.bit_generator.state, tally)
        rng = np.random.default_rng(seed)
        table = trace.Table()
        with trace.recording(table):
            edit = weld_pass(view, cfg, rng, nx, ny, max_area)
        out["rows"] = (edit, rng.bit_generator.state, dict(table.counts))
    return view, max_area, out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_row_scans_give_the_pair_loops_edit_bit_for_bit(name, dtype, seed):
    view, max_area, out = both(name, dtype, seed)
    (e_old, g_old, tally), (e_new, g_new, _) = out["scalar"], out["rows"]
    assert view.area.dtype == np.dtype(dtype)
    # the field exercises what it is for
    assert e_old.new_floes, "no weld: the case compares empty edits"
    if name == "dense_absorbing":
        assert tally["absorbed"] > 0
    if name == "capped":
        assert np.sum(view.alive & (view.area >= max_area)) > 1
        assert np.any(view.area == max_area)
    assert edit_bits(e_new) == edit_bits(e_old)
    assert g_new == g_old


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_weld_counts_are_the_pair_loops_iterations_and_clips(dtype):
    _, _, out = both("dense_absorbing", dtype, 1)
    tally, counts = out["scalar"][2], out["rows"][2]
    assert tally["pairs"] > 0 and tally["clips"] > 0
    assert counts == {"weld.pairs": tally["pairs"],
                      "weld.clips": tally["clips"]}


def test_weld_counts_land_in_the_lifecycle_pass_table():
    """At step 25 the 3x3 weld is the only pass due: ``Lifecycle.step``
    leaves the pass's counts in ``pass_times``, as a direct call reads
    them on the same view and generator."""
    polys = dense_field(np.random.default_rng(1001))["polys"]
    cfg = cfg_of("float64", max_floes=-(-(len(polys) + 8) // 8) * 8)
    st = state_from_polygons(polys, 0.5, cfg, seed=1, device="cpu")
    amax = 3e9                  # above every floe: the pass's cap stays 1e9
    table = trace.Table()
    with trace.recording(table):
        weld_pass(extract_view(st, cfg), cfg, np.random.default_rng(3), 3, 3,
                  amax / 3)
    lc = tlc.Lifecycle(cfg, np.array([[-LX, -LX], [LX, -LX], [LX, LX],
                                      [-LX, LX]]), seed=3, amax=amax)
    lc.step(st, None, 25, np.zeros((10, 10)))
    counts = lc.pass_times.counts
    assert table.counts["weld.pairs"] > 0 and table.counts["weld.clips"] > 0
    assert {k: counts.get(k) for k in table.counts} == table.counts
    assert counts["weld.slots"] > 0
