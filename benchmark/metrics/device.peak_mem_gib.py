"""``torch.cuda.max_memory_allocated()`` over the timed segments, GiB."""

KIND = "per_layer"
LAYER = "Device (H100)"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "floe_steps_per_s"


def read(ctx):
    peak = ctx["run"].peak
    return peak / 2**30 if peak else None
