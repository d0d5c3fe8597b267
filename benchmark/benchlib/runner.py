"""One run of one cell: set-up, the timed window of replayed segments, the
traced segment, the check against the reference, and the result line.

The window is made of segments.  A segment restores the cell's segment
start state (a :func:`replay.share_copy` of it) and calls
``Simulation.run(segment_steps)`` and a synchronise; only that call is
timed.  Segments start while ``--seconds`` has not run out, and the last
one runs to its end, so every segment does the same work for one seed
whatever the program's speed.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import statistics
import sys
import time

import numpy as np

from . import check as chk
from .catalog import Catalog
from .replay import share_copy
from .trace import (
    CLIP_KERNEL, busy_us, clip_bound_ms, clip_work, gaps, gaps_by_phase,
    marks_ms,
)

FORBIDDEN = ("jax", "jaxlib", "flax", "subzero_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Hooks:
    """The harness's wrappers around the program's module globals: the
    physics step (``sim.physics_step``, the name the driver calls), the
    lifecycle boundary (``Lifecycle.step``), and in the traced segment the
    clip wrappers and host spans."""

    def __init__(self, device):
        self.device = device
        self.recorder = None
        self.marks = None          # list of (name, event) while traced
        self.clip_calls = None     # list of clip_work()s while profiled
        self.spans = None          # record_function names while profiled
        self._undo = []

    def _wrap(self, owner, name, make):
        """Replace ``owner.name`` by ``make(original)``; undone by
        :meth:`uninstall`."""
        old = getattr(owner, name)
        setattr(owner, name, make(old))
        self._undo.append((owner, name, old))

    def install(self):
        import torch

        import subzero_tpu_torch.sim as simmod
        from subzero_tpu_torch.processes import lifecycle as lcmod

        hooks = self
        cuda = self.device.type == "cuda"

        def timer(name):
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            else:
                ev = time.perf_counter()
            hooks.marks.append((name, ev))

        def wrap_step(step0):
            def physics_step(state, forcing, step_idx, domain_verts,
                             modulus, heat_flux, cfg, timer_=None):
                t = timer_ if timer_ is not None else (
                    timer if hooks.marks is not None else None)
                out, aux = step0(state, forcing, step_idx, domain_verts,
                                 modulus, heat_flux, cfg, timer=t)
                if hooks.recorder is not None:
                    hooks.recorder.on_step(step_idx, state, out, aux,
                                           domain_verts, modulus, heat_flux,
                                           cfg)
                return out, aux
            return physics_step

        def wrap_lifecycle(lc0):
            def lc_step(lc, state, aux, step_idx, dissolved, **kw):
                rec = hooks.recorder
                keep = rec is not None and rec.active
                if keep:
                    found = dict(
                        aux=aux, merge_pairs=list(kw.get("merge_pairs")
                                                  or []),
                        hints=kw.get("hints"), rng=copy.deepcopy(lc.rng),
                        amax=lc.amax, pack_h0=lc.pack_h0, cfg=lc.cfg,
                        domain_poly=lc.domain_poly,
                        grow=lc.grow_fn is not None,
                        grow_verts=lc.grow_verts_fn is not None,
                        dis_in=np.array(dissolved, np.float64),
                        exp_in=float(lc.exported_mass))
                with hooks.span("lifecycle"):
                    out = lc0(lc, state, aux, step_idx, dissolved, **kw)
                if keep:
                    found.update(dis_out=np.array(out[1], np.float64),
                                 exp_out=float(lc.exported_mass))
                    rec.on_boundary(step_idx, state, out[0], found)
                return out
            return lc_step

        self._wrap(simmod, "physics_step", wrap_step)
        self._wrap(lcmod.Lifecycle, "step", wrap_lifecycle)

        def spanned(owner, name, label):
            def make(f0):
                def f(*a, **kw):
                    with hooks.span(label):
                        return f0(*a, **kw)
                return f
            self._wrap(owner, name, make)

        spanned(simmod.Simulation, "_run_chunk", "chunk")
        for fn, label in (("ridge_raft_pass", "ridge_raft"),
                          ("fracture_pass", "fracture"),
                          ("weld_pass", "weld"), ("simplify_pass", "simplify"),
                          ("pack_pass", "pack"), ("apply_edits", "apply_edits"),
                          ("extract_view", "extract_view")):
            if hasattr(lcmod, fn):
                spanned(lcmod, fn, label)
        for meth, label in (("_corners", "corners"),
                            ("_merges_from_pairs", "merges")):
            spanned(lcmod.Lifecycle, meth, label)

    def clip_counting(self):
        """Context: the clip wrappers count each call's work (the traced
        segment only, so the timed window runs the program as it is)."""
        import contextlib

        from subzero_tpu_torch.kernels import clip as kclip
        from subzero_tpu_torch.kernels import clip_pallas as kpallas

        hooks = self

        @contextlib.contextmanager
        def counting():
            saved = []
            for mod, fname in ((kclip, "clip_stats_cuda"),
                               (kpallas, "clip_pallas_cuda")):
                f0 = getattr(mod, fname)

                def clip(p, q, difference, _f0=f0):
                    out = _f0(p, q, difference)
                    if p.shape[0] > 0:
                        hooks.clip_calls.append(clip_work(p, q))
                    return out

                # the wrappers count launches on their own function object
                clip.launches = getattr(f0, "launches", 0)
                saved.append((mod, fname, f0, clip))
                setattr(mod, fname, clip)
            try:
                yield
            finally:
                for mod, fname, f0, clip in saved:
                    f0.launches = clip.launches
                    setattr(mod, fname, f0)

        return counting()

    def span(self, name):
        import contextlib

        if self.spans is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("bench." + name)

    def uninstall(self):
        for owner, name, old in reversed(self._undo):
            setattr(owner, name, old)
        self._undo.clear()


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ledger_point(sim) -> dict:
    return dict(fields=chk.refs(sim.state, chk.LEDGER_FIELDS),
                dissolved=float(np.sum(sim.dissolved, dtype=np.float64)),
                exported=float(sim.lifecycle.exported_mass))


class Run:
    """One run of one cell (the driver's command line, or a test's call)."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device="cuda", dtype=None, catalog: "Catalog | None" = None,
                 t_start: "float | None" = None, log=print):
        import torch

        self.t_start = time.perf_counter() if t_start is None else t_start
        self.cat = catalog or Catalog()
        self.cell = self.cat.cell(cell)
        self.config = self.cat.config(self.cell["config"])
        self.traffic = self.cell["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.dtype = dtype
        self.log = log
        self.hooks = Hooks(self.device)

    # -- set-up ----------------------------------------------------------

    def setup(self):
        import torch

        tr = self.traffic
        builder = self.cat.builder(self.config)
        self.hooks.install()
        sim, self.inputs = builder.build(self.config["recipe"], tr, self.seed,
                                         self.device, self.dtype)
        st = sim.state
        self.init = chk.host(chk.refs(st, ("area", "x", "y", "mass")))
        self.rho = float(sim.cfg.physics.rho_ice)
        sim.run(0)                      # fits the vertex rung
        warm = int(tr.get("warm_steps", 0))
        if warm:
            sim.run(warm)
        self.n_seg = int(tr["segment_steps"])
        # one throwaway segment from the start state: it builds and loads
        # every kernel the segment uses, and settles the pools
        probe = share_copy(sim)
        probe.run(self.n_seg)
        _sync(self.device)
        sim.cfg = sim.cfg.replace(
            contact=probe.cfg.contact,
            capacity=dataclasses.replace(
                sim.cfg.capacity,
                max_neighbors=probe.cfg.capacity.max_neighbors))
        sim.__post_init__()
        del probe
        self.start = sim
        self.start_step = sim.step_idx
        self.live0 = int(sim.state.alive.sum())
        self.rov0 = getattr(sim, "region_overflow_steps", 0)
        rng = np.random.default_rng([self.seed % 2**63, 17])
        # steps drawn from the seed in the segment's second half, where
        # the pack carries solid contacts (see check.solid)
        half = self.n_seg // 2
        k = min(int(tr.get("check_steps", 2)), self.n_seg - half)
        self.check_steps = sorted(
            int(s) for s in self.start_step + half + rng.choice(
                self.n_seg - half, k, replace=False))
        self.hooks.recorder = chk.Recorder(self.check_steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    # -- window ------------------------------------------------------------

    def segment(self):
        """Restore the start state (harness time), then the timed call."""
        import torch

        sim = share_copy(self.start)
        # this segment's phase and pass seconds alone
        sim.__dict__.pop("_phase_times", None)
        sim.lifecycle.__dict__.pop("pass_times", None)
        self.hooks.recorder.new_segment()
        _sync(self.device)
        t0 = time.perf_counter()
        sim.run(self.n_seg)
        _sync(self.device)
        dt = time.perf_counter() - t0
        bad = 0
        st = sim.state
        al = st.alive
        vals = torch.stack([st.x[al], st.y[al], st.u[al], st.v[al],
                            st.ksi[al], st.h[al], st.mass[al]])
        if not bool(torch.isfinite(vals).all()):
            bad = self.n_seg
        rov = getattr(sim, "region_overflow_steps", 0) - self.rov0
        return sim, dt, bad, rov

    def window(self):
        self.seg_times, self.failed = [], 0
        self.phase, self.passes = {}, {}
        rec = self.hooks.recorder
        if self.trace:
            self.hooks.marks = []
        self.t_window = time.perf_counter()
        self.setup_s = self.t_window - self.t_start
        rec.active = True
        while not self.seg_times or \
                time.perf_counter() - self.t_window < self.seconds:
            self.end = None     # the last segment's state is not kept alive
            sim, dt, bad, rov = self.segment()
            self.seg_times.append(dt)
            self.failed += bad + rov
            for k, v in sim.phase_times.items():
                self.phase[k] = self.phase.get(k, 0.0) + v
            for k, v in getattr(sim.lifecycle, "pass_times", {}).items():
                self.passes[k] = self.passes.get(k, 0.0) + v
            self.end = sim
        rec.active = False
        self.window_s = time.perf_counter() - self.t_window
        self.timed_steps = self.n_seg * len(self.seg_times)
        self.peak = self._peak()
        _sync(self.device)
        self.marks = marks_ms(self.hooks.marks) if self.trace else None
        self.hooks.marks = None

    def _peak(self) -> int:
        import torch

        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    # -- traced segment ------------------------------------------------------

    def traced_segment(self):
        """One more segment under torch.profiler (CPU and CUDA activity),
        after the window: device busy time, top operations, idle gaps by
        host span, and the clip kernels' time against their bound."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.hooks.clip_calls = []
        self.hooks.spans = True
        with self.hooks.clip_counting(), profile(activities=acts) as prof:
            with record_function("bench.segment"):
                sim = share_copy(self.start)
                _sync(self.device)
                sim.run(self.n_seg)
                _sync(self.device)
        self.hooks.spans = None
        calls, self.hooks.clip_calls = self.hooks.clip_calls, None
        events = prof.profiler.kineto_results.events()
        dev, spans, win = [], [], None
        by_name: dict = {}
        clip_ms, clip_n = 0.0, 0
        for e in events:
            if e.name().startswith("bench.") and \
                    e.device_type() == DeviceType.CUDA:
                continue            # the spans' mirror on the device lanes
            if e.device_type() == DeviceType.CUDA:
                a, b = e.start_ns(), e.end_ns()
                dev.append((a, b))
                nm = e.name()
                by_name[nm] = by_name.get(nm, 0.0) + (b - a) * 1e-9
                if CLIP_KERNEL.search(nm):
                    clip_ms += (b - a) * 1e-6
                    clip_n += 1
            elif e.name().startswith("bench."):
                if e.name() == "bench.segment":
                    win = (e.start_ns(), e.end_ns())
                else:
                    spans.append((e.name()[6:], e.start_ns(), e.end_ns()))
        if win is None:
            raise RuntimeError("the profiler recorded no segment span")
        dev = [(max(a, win[0]), min(b, win[1])) for a, b in dev
               if b > win[0] and a < win[1]]
        busy = busy_us(dev) * 1e-9
        idle = gaps(dev, win[0], win[1])
        self.profile = dict(
            busy_s=busy, window_s=(win[1] - win[0]) * 1e-9,
            device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            idle_gaps=[(n, s * 1e-9) for n, s in gaps_by_phase(idle, spans)],
            clip=None)
        if calls:
            pairs = torch.stack([c[1] for c in calls]).cpu().numpy()
            bound = sum(clip_bound_ms(nb, pr, size)[0]
                        for (nb, _, size), pr in zip(calls, pairs))
            if clip_n == len(calls) and clip_ms > 0:
                self.profile["clip"] = dict(bound_ms=bound, kernel_ms=clip_ms,
                                            calls=clip_n)
        self.log(f"[trace] profiled segment: {self.profile['window_s']:.6f} s"
                 f" window, device busy {busy:.6f} s; clip calls "
                 f"{len(calls)}, clip kernels seen {clip_n}")

    # -- check -------------------------------------------------------------

    def numbers(self, emulate=None) -> dict:
        """The numbers compared (see ``check.py``); ``emulate`` ("bf16",
        "f32") gives the control's: the reference in the program's place,
        in that precision."""
        rec = self.hooks.recorder
        grid = self._grid()
        walls = self.inputs.wall_fn or (lambda s: (self.inputs.lx,
                                                   self.inputs.ly))
        k = int(self.traffic.get("check_floes", 24))
        vals = {"init.gap": chk.init_gap(self.init, self.inputs.polys,
                                         self.inputs.heights, self.rho,
                                         emulate=emulate)}
        vals.update(self._steps(rec, grid, walls, k, emulate))
        vals["ledger.gap"] = chk.ledger_gaps(
            rec, _ledger_point(self.start), _ledger_point(self.end),
            self.rho, self.inputs.heat_flux == 0.0, emulate=emulate)
        vals["state.mass_gap"] = chk.state_mass_gap(
            chk.refs(self.end.state, chk.LEDGER_FIELDS), self.rho,
            emulate=emulate)
        life = chk.life_gaps(rec, self.rho, emulate=emulate)
        self.log(f"[check] lifecycle: passes fired by boundary "
                 f"{life['fired']}, {life['compared']} changed slots "
                 f"compared; (step, slot, program, reference) of the first "
                 f"that miss: {life['missed'][:10]}")
        vals["life.slot_miss"] = life["life.slot_miss"]
        vals["life.mass_gap"] = life["life.mass_gap"]
        return vals

    def check(self) -> dict:
        """Each number with the cell's limit for it (None: not compared)."""
        limits = self.cell.get("limits", {})
        return {n: (v, limits.get(n)) for n, v in self.numbers().items()}

    def control(self) -> dict:
        """The control's numbers, in the precision below the
        configuration's: bfloat16 for float32, float32 for float64."""
        dt = self.dtype or self.config["recipe"]["dtype"]
        return self.numbers(emulate="f32" if dt == "float64" else "bf16")

    def _steps(self, rec, grid, walls, k, emulate) -> dict:
        """The step numbers, the largest over the captured steps."""
        out = dict.fromkeys(("step.force_gap", "step.dv_gap",
                             "step.force_miss", "step.dv_miss",
                             "step.pos_miss", "step.extra_solid"), 0.0)
        for s in self.check_steps:
            cap = rec.captured.get(s)
            if cap is None:
                raise RuntimeError(f"step {s} was not captured")
            rng = np.random.default_rng([self.seed % 2**63, 29, s])
            g = chk.step_gaps(cap, grid, walls, k, rng, emulate=emulate)
            self.log(f"[check] step {s}: {g['n']} floes with a solid contact,"
                     f" {g['moving']} moving coordinates")
            for n in out:
                out[n] = max(out[n], g[n])
        return out

    def _grid(self):
        from reference.oracle import Grid

        g = self.inputs.grid
        return Grid(x0=float(g["x0"]), y0=float(g["x0"]), dx=float(g["dx"]),
                    uo=g["uo"], vo=g["vo"], ua=g["ua"], va=g["va"])

    # -- result --------------------------------------------------------------

    def metrics(self) -> dict:
        ctx = dict(run=self, phase=self.phase, passes=self.passes,
                   marks=self.marks, profile=getattr(self, "profile", None),
                   steps=self.timed_steps)
        out = {}
        readers = self.cat.readers()
        for name in self.cat.metrics_for(self.trace):
            r = readers.get(name)
            if r is None:
                raise RuntimeError(f"no reader for metric {name!r}")
            v = r.read(ctx)
            if v is not None:
                out[name] = {"value": float(v), "unit": r.UNIT}
        return out

    def device_info(self) -> dict:
        import torch

        if self.device.type == "cuda":
            info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(self.device),
                    "count": 1, "memory_peak_bytes": self.peak}
        else:
            info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        if self.trace:
            info["busy_s"] = self.profile["busy_s"]
            info["window_s"] = self.profile["window_s"]
        return info


def run(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
        dtype=None, catalog=None, t_start=None, log=print) -> dict:
    """Runs one cell and returns the result object (the last line)."""
    r = Run(cell, seed, seconds, trace, device, dtype, catalog, t_start, log)
    try:
        r.setup()
        r.window()
        if trace:
            r.traced_segment()
        r.hooks.recorder.active = False
        metrics = r.metrics()
        checks = r.check()
    finally:
        r.hooks.uninstall()
    log("[check] every number (those without a limit are not compared): "
        + json.dumps({n: v for n, (v, _) in checks.items()}))
    checks = {n: c for n, c in checks.items() if c[1] is not None}
    ok = bool(checks) and all(math.isfinite(v) and v <= lim
                              for v, lim in checks.values())
    ts = r.seg_times
    q = statistics.quantiles(ts, n=4) if len(ts) > 1 else [ts[0]] * 3
    log(f"[window] {len(ts)} segments of {r.n_seg} steps from step "
        f"{r.start_step}, {r.live0} live floes: segment seconds median "
        f"{statistics.median(ts)!r}, quartiles {q[0]!r} {q[2]!r}; window "
        f"{r.window_s!r} s; setup {r.setup_s!r} s; phases "
        f"{json.dumps(r.phase)}; passes {json.dumps(r.passes)}")
    if trace:
        fsps = r.live0 * r.timed_steps / sum(ts)
        log(f"[trace] with the timer marks on: {fsps!r} floe-steps/s over "
            f"{len(ts)} segments (the untraced run's floe_steps_per_s is "
            "the mark-free figure)")
    result = {"correct": ok, "attempted": r.timed_steps,
              "failed": r.failed, "metrics": metrics,
              "device": r.device_info()}
    if trace:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in r.profile["device_ops"]],
            "idle_gaps": [[n, s] for n, s in r.profile["idle_gaps"]]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    return result
