"""Slots the lifecycle wrote back to the device state (the count
``apply_edits.slots`` of ``Lifecycle.pass_times``: one a birth, plus each
slot killed, updated or reshaped), in the last timed segment, per segment
step; 0 where nothing was edited.  Nothing where the program keeps no
such count."""

KIND = "per_layer"
LAYER = "Lifecycle (processes/lifecycle.py and its passes)"
UNIT = "slots/step"
SOURCE = "program_counter"
MOVES = "floe_steps_per_s"


def read(ctx):
    run = ctx["run"]
    counts = getattr(getattr(run.end.lifecycle, "pass_times", None),
                     "counts", None)
    if counts is None:
        return None
    return counts.get("apply_edits.slots", 0) / run.n_seg
