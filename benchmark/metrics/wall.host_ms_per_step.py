"""The physics step's host span "wall" (``Simulation.phase_times``
path "chunk/wall", its nested spans included), summed over the timed
steps, ms per timed step: the host's time in the layer, on the host's
clock.  Nothing where the program records no such span.

Only in a cell the host paces is this the layer's own host cost.  Where
the card paces the step (uniaxial-10k: the card busy ~84% of the
segment), a kernel launch blocks while the launch queue is full, and that
wait lands in whichever span is launching: there the value is launch-
queue back-pressure, not the layer's host work (PERF.md §5)."""

KIND = "per_layer"
LAYER = "Wall contact (dynamics/contact.py boundary_contact)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"


def read(ctx):
    s = ctx["phase"].get("chunk/wall")
    if s is None:
        return None
    return 1e3 * s / ctx["steps"]
