"""Seconds from process start to the first timed segment: building the
inputs and the state, loading (and in a fresh checkout building) the
kernels, the warm steps and one throwaway segment."""

KIND = "end_to_end"
UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return ctx["run"].setup_s
