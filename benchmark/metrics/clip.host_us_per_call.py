"""The host time of one clip call as the contact layer makes it: the
seconds of every "clip" span (``Simulation.phase_times`` paths
".../clip", the wrapper and, on the card, the kernel's launch) over their
entries, in the last timed segment, µs per call.  Nothing where the
program records no such span or no entry counts."""

KIND = "per_layer"
LAYER = "Kernels (kernels/clip.py, kernels/clip_pallas.py, csrc/)"
UNIT = "us/call"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"


def read(ctx):
    table = ctx["run"].end.phase_times
    entries = getattr(table, "entries", None)
    if entries is None:
        return None
    paths = [k for k in table if k.rpartition("/")[2] == "clip"]
    n = sum(entries.get(k, 0) for k in paths)
    if not n:
        return None
    return 1e6 * sum(table[k] for k in paths) / n
