"""1 - (union of the device's operation intervals / the traced segment's
wall time), from torch.profiler."""

KIND = "per_layer"
LAYER = "Device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "floe_steps_per_s"


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
