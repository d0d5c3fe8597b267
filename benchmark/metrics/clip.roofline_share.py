"""The clip kernels (``csrc/clip.cu``, ``csrc/clip_pallas.cu``) against
their roofline: the sum of each call's least time (``trace.clip_bound_ms``:
work counted from the pairs' real edges) over the sum of the kernels'
device time, from torch.profiler, in the traced segment.  Nothing where
the segment launched no clip kernel, or where the kernels seen do not
match the calls one for one."""

KIND = "per_layer"
LAYER = "Kernels (kernels/clip.py, kernels/clip_pallas.py, csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "floe_steps_per_s"


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["clip"] is None:
        return None
    c = prof["clip"]
    return 100.0 * c["bound_ms"] / c["kernel_ms"]
