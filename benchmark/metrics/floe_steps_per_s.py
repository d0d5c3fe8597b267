"""Live floes of the segment start state x whole-segment steps / the summed
wall seconds of those ``Simulation.run`` calls, each ending in a
synchronise, over the whole window."""

KIND = "end_to_end"
UNIT = "floe-steps/s"
SOURCE = "host_clock"


def read(ctx):
    run = ctx["run"]
    return run.live0 * ctx["steps"] / sum(run.seg_times)
