"""The physics step's host span "trajectory" (``Simulation.phase_times``
path "chunk/trajectory") less its device->host copies (its "sync.*"
children: the thin-floe test's wait for the card), summed over the timed
steps, ms per timed step.  Nothing where the program records no such
span.

Only in a cell the host paces is this the layer's own host cost.  Where
the card paces the step (uniaxial-10k: the card busy ~84% of the
segment), a kernel launch blocks while the launch queue is full, and that
wait lands in whichever span is launching: there the value is launch-
queue back-pressure, not the layer's host work (PERF.md §5)."""

KIND = "per_layer"
LAYER = "Trajectory (dynamics/trajectory.py)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"

SPAN = "chunk/trajectory"


def read(ctx):
    phase = ctx["phase"]
    s = phase.get(SPAN)
    if s is None:
        return None
    waits = sum(v for k, v in phase.items()
                if k.startswith(SPAN + "/sync."))
    return 1e3 * (s - waits) / ctx["steps"]
