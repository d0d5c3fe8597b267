"""The driver's chunk phase (``Simulation.phase_times['chunk']``: the
physics steps and the one summary copy that waits for the card), ms per
timed step."""

KIND = "per_layer"
LAYER = "Driver (sim.py Simulation.run)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"


def read(ctx):
    return 1e3 * ctx["phase"].get("chunk", 0.0) / ctx["steps"]
