"""The physics step's "broadphase" phase: from the timer mark "broadphase" to the
next mark, on the card's timeline (CUDA events recorded by the step's
``timer`` hook), summed over the timed steps, ms per timed step.
Where the card waits for the host, this is the host's issue time."""

KIND = "per_layer"
LAYER = "Broad phase (dynamics/broadphase.py)"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "floe_steps_per_s"


def read(ctx):
    marks = ctx["marks"]
    if marks is None:
        return None
    return marks.get("broadphase", 0.0) / ctx["steps"]
