"""The physics step's "contact" phase: from the timer mark "contact" to the
next mark, on the card's timeline (CUDA events recorded by the step's
``timer`` hook), summed over the timed steps, ms per timed step.
Where the card waits for the host, this is the host's issue time."""

KIND = "per_layer"
LAYER = "Floe contact (dynamics/contact.py contact_forces, geometry/regions.py)"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "floe_steps_per_s"


def read(ctx):
    marks = ctx["marks"]
    if marks is None:
        return None
    return marks.get("contact", 0.0) / ctx["steps"]
