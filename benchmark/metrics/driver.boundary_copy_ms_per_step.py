"""The driver's boundary copies and rebuilds (``phase_times``
aux_fetch + merge_fetch + rebuild), ms per timed step."""

KIND = "per_layer"
LAYER = "Driver (sim.py Simulation.run)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"


def read(ctx):
    p = ctx["phase"]
    s = sum(p.get(k, 0.0) for k in ("aux_fetch", "merge_fetch", "rebuild"))
    return 1e3 * s / ctx["steps"]
