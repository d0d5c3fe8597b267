"""The host lifecycle at chunk boundaries (``phase_times['lifecycle']``),
ms per timed step."""

KIND = "per_layer"
LAYER = "Lifecycle (processes/lifecycle.py and its passes)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"


def read(ctx):
    return 1e3 * ctx["phase"].get("lifecycle", 0.0) / ctx["steps"]
