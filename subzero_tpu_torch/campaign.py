"""The validation campaign: the reference cases run end to end and recorded.

The port's counterpart of ``validation/run_cases.py`` and
``validation/run_nares_export_leg.py``.  Per case, under
``validation/out_torch/<case>/``:

  * snap*/            full-state snapshots + Eulerian fields (the
                      checkpoint format both packages read)
  * mass_series.npy   (step, floe mass, dissolved mass, exported mass)
  * m0.npy            the conserved total at step 0, the ledger's baseline
  * distributions.npz the FSD and ITD histograms at the end of the run
  * fig*.png          floe-field figures, where matplotlib is installed

and a summary block appended to ``validation/out_torch/RESULTS.md``.

Cases (the same builders, seeds, widths and per-case extras as the JAX
campaign):

  out_of_box   : ~10 floes, 4-gyre ocean, collisions
  uniaxial     : 200 floes, N/S walls closing to 85 km, Mohr-Coulomb fracture
  nares        : 150 floes, 10 m/s southward wind through the strait
  nares_export : the Nares configuration with floes through the whole basin
  winter       : 100 floes, all processes, PERIODIC + KEEP_MIN, freezing

Usage:

    python -m subzero_tpu_torch.campaign [case ...] [--steps=N] [--resume]
                                         [--device=cuda|cpu] [--out=DIR]
                                         [--dtype=float64]

``--resume`` continues each case from its latest snapshot (the runs are
checkpointed every ``n_dt_out`` steps, so a campaign runs in legs).
``--out`` writes under another directory than ``validation/out_torch``.  The
device is CUDA unless ``--device`` names another; without CUDA the run
fails rather than falling back to the CPU.  The cases run in the builders'
default dtype, float32, unless ``--dtype`` names another.

The export leg, ``nares_leg``, resumes the recipe-faithful ``[1; 0]`` Nares
case from its latest snapshot (or starts it) and runs it in legs of
``n_dt_out = 1500`` steps until the first export and a 15,000-step tail
after it; it stops at a leg boundary if ``validation/out_torch/nares/STOP``
exists, and at step ``--steps`` (default 400,000).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from .device import resolve_device
from .sim import Simulation, out_of_box_sim
from .validation import (
    floe_size_distribution, ice_thickness_distribution, nares_sim,
    uniaxial_sim, winter_sim,
)

OUT = Path(__file__).resolve().parent.parent / "validation" / "out_torch"

# the export leg (run_nares_export_leg.py)
HARD_CAP = 400_000
TAIL = 15_000          # steps to keep running after the first export
LEG = 1_500            # = n_dt_out snapshot cadence


@dataclasses.dataclass
class Campaign:
    """Where and how the cases run: the output root, whether to resume,
    the device and dtype handed to the builders, the output cadence (None
    keeps each case's own) and the contact clip (None keeps the builders'
    ``contact_impl``)."""

    out: Path = OUT
    resume: bool = False
    device: "str | None" = None
    dtype: "str | None" = None
    n_dt_out: "int | None" = None
    contact_impl: "str | None" = None

    def case_dir(self, name: str) -> Path:
        d = Path(self.out) / name
        d.mkdir(parents=True, exist_ok=True)
        return d

    def build(self, name: str, builder, n_dt_out=None, **kw) -> Simulation:
        """The case's Simulation from ``builder`` on this campaign's device
        and dtype, writing its outputs under ``case_dir(name)``."""
        sim = builder(device=self.device, dtype=self.dtype, **kw)
        cadence = self.n_dt_out or n_dt_out
        if cadence:
            sim.cfg = sim.cfg.replace(processes=dataclasses.replace(
                sim.cfg.processes, n_dt_out=cadence))
        if self.contact_impl:
            sim.cfg = sim.cfg.replace(numerics=dataclasses.replace(
                sim.cfg.numerics, contact_impl=self.contact_impl))
        sim.output_dir = self.case_dir(name)
        sim.plot_output = _can_plot()
        return sim


def _can_plot() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def device_label(sim) -> str:
    """The device a summary row names: the card's name and power limit
    (``nvidia-smi``), or the CPU."""
    dev = sim.state.device
    if dev.type != "cuda":
        return dev.type
    import torch

    name = torch.cuda.get_device_name(dev)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        power = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        power = "power limit not read"
    return f"{name}, {power}"


def _total(sim) -> float:
    """Conserved total: floes + dissolved + exported.  The baseline m0 must
    be taken with THIS function — a resumed case already carries dissolved
    mass from its earlier legs, so baselining on floe mass alone reports a
    spurious ledger gain."""
    return (sim.total_mass() + float(np.sum(sim.dissolved))
            + sim.lifecycle.exported_mass)


def _ledger(sim, m0: float) -> dict:
    return {
        "floe mass [kg]": f"{sim.total_mass():.6e}",
        "dissolved [kg]": f"{float(np.sum(sim.dissolved)):.6e}",
        "exported [kg]": f"{sim.lifecycle.exported_mass:.6e}",
        "ledger (floes+dissolved+exported)/m0":
            f"{_total(sim) / m0:.8f}",
    }


def _baseline(sim, name: str, camp: Campaign) -> float:
    """The ledger's baseline: the total at step 0, saved as ``m0.npy`` and
    read back by a resumed leg, so the ledger of a campaign run in legs
    spans the whole run."""
    m0_path = camp.case_dir(name) / "m0.npy"
    if sim.step_idx == 0 or not m0_path.exists():
        m0 = _total(sim)
        np.save(m0_path, m0)
        return m0
    return float(np.load(m0_path))


def _summarize(name: str, sim, t_wall: float, camp: Campaign,
               extra: "dict | None" = None) -> list:
    alive = sim.state.alive.cpu().numpy()
    fsd, fsd_edges = floe_size_distribution(sim.state)
    itd, itd_edges = ice_thickness_distribution(sim.state)
    np.savez(camp.case_dir(name) / "distributions.npz", fsd=fsd,
             fsd_edges=fsd_edges, itd=itd, itd_edges=itd_edges)
    rate = ((sim.step_idx - getattr(sim, "_resume_step", 0))
            / max(t_wall, 1e-9))
    lines = [
        f"\n## {name} ({time.strftime('%Y-%m-%d')})\n",
        f"- steps: {sim.step_idx}, wall: {t_wall:.0f} s "
        f"({rate:.2f} steps/s, {device_label(sim)})",
        f"- live floes: {int(alive.sum())}",
        f"- region-overflow steps: "
        f"{sim.region_overflow_steps} "
        f"(peak pool demand {sim.region_pool_need_max} "
        "pair slots)",
    ]
    if camp.contact_impl:
        lines.append(f"- contact_impl: {camp.contact_impl}")
    if extra:
        lines += [f"- {k}: {v}" for k, v in extra.items()]
    with open(Path(camp.out) / "RESULTS.md", "a") as f:
        f.write("\n".join(lines) + "\n")
    print(f"[{name}] " + sim.phase_report().replace("\n", f"\n[{name}] "),
          flush=True)
    print("\n".join(lines), flush=True)
    return lines


def _maybe_resume(sim, name: str, camp: Campaign):
    """Reload the latest snapshot under ``case_dir(name)`` if resuming."""
    if not camp.resume:
        return sim
    snaps = sorted(camp.case_dir(name).glob("snap*/meta.json"))
    if not snaps:
        return sim
    snap = snaps[-1].parent
    loaded = Simulation.load(snap, sim.cfg, sim.forcing, device=camp.device)
    # keep the case-specific driver attachments (incl. output wiring — a
    # resumed leg must keep writing snapshots/figures/mass series)
    loaded.wall_fn = sim.wall_fn
    loaded.output_dir = sim.output_dir
    loaded.plot_output = sim.plot_output
    loaded._resume_step = loaded.step_idx
    print(f"[{name}] resumed from {snap.name} (step {loaded.step_idx})",
          flush=True)
    return loaded


def _finish(sim, name: str, steps: int, t0: float, m0: float, camp,
            extra: "dict | None" = None):
    remaining = steps - sim.step_idx
    if remaining > 0:
        sim.run(remaining, log_every=500)
    extra = dict(extra or {})
    extra.update(_ledger(sim, m0))
    return _summarize(name, sim, time.time() - t0, camp, extra)


def _first_export(name: str, camp: Campaign):
    """The step of the first output row with exported mass, or None."""
    series_p = camp.case_dir(name) / "mass_series.npy"
    if not series_p.exists():
        return None
    series = np.load(series_p)
    hits = np.nonzero(series[:, 3] > 0)[0] if series.shape[1] >= 4 else []
    return int(series[hits[0], 0]) if len(hits) else None


def run_out_of_box(steps: int, camp: Campaign):
    sim = camp.build("out_of_box", out_of_box_sim, seed=0, n_floes=10)
    sim = _maybe_resume(sim, "out_of_box", camp)
    m0 = _baseline(sim, "out_of_box", camp)
    return _finish(sim, "out_of_box", steps, time.time(), m0, camp)


def run_uniaxial(steps: int, camp: Campaign):
    sim = camp.build("uniaxial", uniaxial_sim, n_floes=200, seed=0)
    # The reference closes the walls 15 m / 30 steps -> 30000 steps to reach
    # 85 km.  The closure rate is scaled so the walls reach 85 km by the end
    # of the run (documented acceleration, as the JAX campaign).
    rate = max(15.0, (1e5 - 8.5e4) / max(steps // 30, 1))
    wall_fn = lambda s: (1e5, max(1e5 - rate * (s // 30), 8.5e4))  # noqa
    sim.wall_fn = wall_fn
    sim = _maybe_resume(sim, "uniaxial", camp)
    sim.wall_fn = wall_fn
    # f64 shadow ledger: pin any lifecycle-pass mass leak per invocation
    sim.lifecycle.shadow_ledger = True
    n0 = int(sim.state.alive.sum())
    m0 = _baseline(sim, "uniaxial", camp)
    t0 = time.time()
    sim.run(steps - sim.step_idx, log_every=500)
    n1 = int(sim.state.alive.sum())
    ly = sim.wall_fn(sim.step_idx)[1]
    extra = {
        "wall position Ly": f"{ly/1e3:.1f} km (target 85 km)",
        "floes (fracture grows count)": f"{n0} -> {n1}",
        "floe capacity (auto-grown)": sim.state.n,
        "max principal stress [Pa]":
            f"{float(sim.state.stress.max()):.3e}",
        "shadow-ledger drift [kg]":
            f"{sim.lifecycle.ledger_drift:+.3e} "
            f"(max single {sim.lifecycle.ledger_drift_max:+.3e})",
    }
    extra.update(_ledger(sim, m0))
    return _summarize("uniaxial", sim, time.time() - t0, camp, extra)


def _nares_case(camp: Campaign, long_run: bool) -> Simulation:
    """The recipe-faithful [1; 0] Nares case; a long run thins the output
    cadence to 1500 steps and draws no figure at each output, so output
    IO doesn't dominate the wall clock."""
    sim = camp.build("nares", nares_sim, n_dt_out=LEG if long_run else None,
                     n_floes=150, seed=0)
    if long_run:
        sim.plot_output = False
    return sim


def _final_figure(sim, name: str, camp: Campaign) -> None:
    """One figure of the end state (long runs draw none at each output)."""
    try:
        from .plotting import plot_basic     # selects Agg

        fig = plot_basic(sim.state, sim.cfg, sim.forcing)
        fig.savefig(camp.case_dir(name) / f"fig{sim.step_idx:07d}.png",
                    dpi=110)
        import matplotlib.pyplot as plt

        plt.close(fig)
    except Exception as e:  # noqa: BLE001 — a figure never fails a run
        print(f"[{name}] final plot failed: {e}", flush=True)


def run_nares(steps: int, camp: Campaign):
    # export run (~19 days of model time for the lead floes to reach the
    # ref -250 km kill line) above 10,000 steps
    sim = _nares_case(camp, steps > 10000)
    sim = _maybe_resume(sim, "nares", camp)
    y0 = sim.state.y.cpu().numpy().copy()
    alive0 = sim.state.alive.cpu().numpy().copy()
    nb = sim.cfg.n_boundary
    m0 = _baseline(sim, "nares", camp)
    t0 = time.time()
    sim.run(steps - sim.step_idx, log_every=500)
    # the floe pool may have grown: its first slots are the leg's start
    y1 = sim.state.y.cpu().numpy()[:len(y0)]
    alive1 = sim.state.alive.cpu().numpy()[:len(alive0)]
    moved = (y1 - y0)[alive0 & alive1]
    # deaths among the floes alive at the start of the leg (out-of-domain
    # exports + sub-minimum kills); a net count would be masked by fracture
    # births
    exported = int((alive0[nb:] & ~alive1[nb:]).sum())
    first = _first_export("nares", camp)
    extra = {
        "mean southward drift": f"{float(np.mean(moved)):.1f} m",
        "initial-floe deaths (export + dissolve kills)": exported,
        "first export at step": (first if first is not None else
                                 "none yet (see exported ledger)"),
    }
    extra.update(_ledger(sim, m0))
    lines = _summarize("nares", sim, time.time() - t0, camp, extra)
    if not sim.plot_output:  # long run: one final figure
        _final_figure(sim, "nares", camp)
    return lines


def run_winter(steps: int, camp: Campaign):
    sim = camp.build("winter", winter_sim, n_floes=100, seed=0)
    sim = _maybe_resume(sim, "winter", camp)
    m0 = _baseline(sim, "winter", camp)
    alive = sim.state.alive.cpu().numpy()
    h0 = float(np.mean(sim.state.h.cpu().numpy()[alive]))
    n0 = int(alive.sum())
    t0 = time.time()
    sim.run(steps - sim.step_idx, log_every=250)
    alive = sim.state.alive.cpu().numpy()
    h1 = float(np.mean(sim.state.h.cpu().numpy()[alive]))
    extra = {
        "mean thickness": f"{h0:.3f} -> {h1:.3f} m (freezing: must grow)",
        "floes": f"{n0} -> {int(alive.sum())} "
                 "(packing at step 5500 adds new ice)",
        "mass (floes+dissolved)/m0":
            f"{(sim.total_mass() + float(np.sum(sim.dissolved))) / m0:.4f} "
            "(>1: thermodynamic growth adds mass)",
    }
    extra.update(_ledger(sim, m0))
    return _summarize("winter", sim, time.time() - t0, camp, extra)


def run_nares_export(steps: int, camp: Campaign):
    """Export-path demonstration: the Nares configuration with
    concentration [1; 1] (floes through the whole domain incl. the strait
    and south basin) so floes reach the reference's -250 km kill line
    within the run.  The recipe-faithful [1; 0] case needs ~0.2M steps of
    pack drift before the first export; this variant exercises the same
    export physics (below-ymin kill -> exported-mass ledger) live."""
    sim = camp.build("nares_export", nares_sim, n_dt_out=LEG, n_floes=150,
                     seed=0, full_basin=True)
    sim.plot_output = False
    sim = _maybe_resume(sim, "nares_export", camp)
    nb = sim.cfg.n_boundary
    alive0 = sim.state.alive.cpu().numpy().copy()
    m0 = _baseline(sim, "nares_export", camp)
    t0 = time.time()
    sim.run(steps - sim.step_idx, log_every=500)
    alive1 = sim.state.alive.cpu().numpy()[:len(alive0)]   # pool may grow
    deaths = int((alive0[nb:] & ~alive1[nb:]).sum())
    extra = {
        "initial-floe deaths": deaths,
        "exported mass fired": sim.lifecycle.exported_mass > 0,
    }
    first = _first_export("nares_export", camp)
    if first is not None:
        extra["first export at step"] = first
    extra.update(_ledger(sim, m0))
    return _summarize("nares_export", sim, time.time() - t0, camp, extra)


def _lead_y(sim) -> float:
    """The southernmost live floe centroid, m (topography excluded)."""
    nb = sim.cfg.n_boundary
    return float(sim.state.y[nb:][sim.state.alive[nb:]].min())


def run_nares_leg(steps: int, camp: Campaign):
    """The recipe-faithful [1; 0] Nares case driven until export fires
    (``run_nares_export_leg.py``): resumed from its latest snapshot under
    ``case_dir("nares")`` (started at step 0 if there is none), run in legs
    of LEG steps until the lead floes cross the southern kill line (ref
    -250 km = ours -375 km) and a TAIL-step tail after the first export;
    stops at the next leg boundary if a STOP file is there, and at step
    ``steps``.  Snapshots and the mass series keep writing at the LEG
    cadence, so the run resumes at any leg."""
    out = camp.case_dir("nares")
    sim = _nares_case(camp, True)
    snaps = sorted(out.glob("snap*/meta.json"))
    if snaps:
        snap = snaps[-1].parent
        loaded = Simulation.load(snap, sim.cfg, sim.forcing,
                                 device=camp.device)
        loaded.output_dir = out
        loaded.plot_output = False
        loaded._resume_step = loaded.step_idx
        sim = loaded
        print(f"[nares-leg] resumed from {snap.name} (step {sim.step_idx}),"
              f" exported so far {sim.lifecycle.exported_mass:.3e} kg",
              flush=True)
    m0 = _baseline(sim, "nares", camp)
    exp0_step = None
    t0, s0 = time.time(), sim.step_idx
    while sim.step_idx < steps:
        if (out / "STOP").exists():
            print(f"[nares-leg] STOP file at step {sim.step_idx}", flush=True)
            break
        sim.run(min(LEG, steps - sim.step_idx))
        rate = (sim.step_idx - s0) / max(time.time() - t0, 1e-9)
        print(f"[nares-leg] step {sim.step_idx}: "
              f"{int(sim.state.alive.sum())} floes, lead y "
              f"{_lead_y(sim) / 1e3:.1f} km, exported "
              f"{sim.lifecycle.exported_mass:.3e} kg, {rate:.1f} steps/s",
              flush=True)
        if sim.lifecycle.exported_mass > 0:
            if exp0_step is None:
                exp0_step = sim.step_idx
                print(f"[nares-leg] FIRST EXPORT by step {exp0_step}",
                      flush=True)
            if sim.step_idx - exp0_step >= TAIL:
                break
    extra = {"first export by step": exp0_step or "none yet",
             "lead floe y": f"{_lead_y(sim) / 1e3:.1f} km "
                            "(kill line -375 km)"}
    extra.update(_ledger(sim, m0))
    return _summarize("nares_leg", sim, time.time() - t0, camp, extra)


CASES = {
    "out_of_box": run_out_of_box,
    "uniaxial": run_uniaxial,
    "nares": run_nares,
    "nares_export": run_nares_export,
    "winter": run_winter,
}

# winter runs past n_pack=5500 so the packing pass fires at reference
# cadence (winter/Subzero.m:105-109)
DEFAULT_STEPS = {
    "out_of_box": 7500, "uniaxial": 6000, "nares": 3000,
    "nares_export": 30000, "winter": 6000,
}

ENTRIES = {**CASES, "nares_leg": run_nares_leg}


def main(argv: "list[str]", contact_impl: "str | None" = None) -> int:
    """The command line's entry; ``contact_impl`` (no option of the command
    line, as JAX's run_cases.py has none) runs every case under that
    ``NumericsConfig.contact_impl``."""
    names = [a for a in argv if not a.startswith("--")] or list(CASES)
    camp = Campaign(resume="--resume" in argv, contact_impl=contact_impl)
    steps_override = None
    for a in argv:
        if a.startswith("--steps="):
            steps_override = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            camp.device = a.split("=", 1)[1]
        elif a.startswith("--out="):
            camp.out = Path(a.split("=", 1)[1])
        elif a.startswith("--dtype="):
            camp.dtype = a.split("=", 1)[1]
        elif a.startswith("--") and a != "--resume":
            raise SystemExit(f"unknown option {a}")
    unknown = [n for n in names if n not in ENTRIES]
    if unknown:
        raise SystemExit(f"unknown cases {unknown}; cases: {list(ENTRIES)}")
    resolve_device(camp.device)
    Path(camp.out).mkdir(parents=True, exist_ok=True)
    failures = []
    for name in names:
        steps = steps_override or DEFAULT_STEPS.get(name, HARD_CAP)
        try:
            ENTRIES[name](steps, camp)
        except Exception:  # noqa: BLE001 — one case never stops the rest
            traceback.print_exc()
            failures.append(name)
            print(f"[campaign] case {name} FAILED — continuing", flush=True)
    if failures:
        print(f"failed cases: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
