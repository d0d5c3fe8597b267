"""The lifecycle's write-back to the device state
(``Lifecycle.pass_times['apply_edits']``), ms per timed step."""

KIND = "per_layer"
LAYER = "Lifecycle write-back (processes/host.py apply_edits)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"


def read(ctx):
    return 1e3 * ctx["passes"].get("apply_edits", 0.0) / ctx["steps"]
