"""The physics step's "wall" phase: from the timer mark "wall" to the
next mark, on the card's timeline (CUDA events recorded by the step's
``timer`` hook), summed over the timed steps, ms per timed step.
Where the card waits for the host, this is the host's issue time."""

KIND = "per_layer"
LAYER = "Wall contact (dynamics/contact.py boundary_contact)"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "floe_steps_per_s"


def read(ctx):
    marks = ctx["marks"]
    if marks is None:
        return None
    return marks.get("wall", 0.0) / ctx["steps"]
