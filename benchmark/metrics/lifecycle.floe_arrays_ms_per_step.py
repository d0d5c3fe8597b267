"""The births' floe arrays inside the lifecycle's write-back (span
``apply_edits/floe_arrays`` of ``Lifecycle.pass_times``: the vertex caps,
``state.make_floe_arrays`` with its Monte-Carlo mask, and the mass fix of
reshapes), ms per timed step.  Nothing where the program records no such
span: a segment with no birth or reshape, or a program without it."""

KIND = "per_layer"
LAYER = "Lifecycle write-back (processes/host.py apply_edits)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"


def read(ctx):
    s = ctx["passes"].get("apply_edits/floe_arrays")
    if s is None:
        return None
    return 1e3 * s / ctx["steps"]
