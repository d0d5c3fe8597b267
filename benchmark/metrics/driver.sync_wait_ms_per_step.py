"""Every device->host copy span under the driver's chunk
(``Simulation.phase_times`` paths "chunk/.../sync.<name>": the chunk's
summary copy and the step's thin-floe test), summed over the timed steps,
ms per timed step: the host waiting for the card at those copies.
Nothing where the program records no such span.

It does not see the host's other wait for the card: a kernel launch that
blocks while the launch queue is full.  Where the card paces the step
(uniaxial-10k) that wait is most of the step and falls inside the layer
spans that launch (``wall.host_ms_per_step`` there), while this reads
near 0; no span or counter measures it yet (PERF.md §5, §7)."""

KIND = "per_layer"
LAYER = "Driver (sim.py Simulation.run)"
UNIT = "ms/step"
SOURCE = "program_span"
MOVES = "floe_steps_per_s"


def read(ctx):
    waits = [v for k, v in ctx["phase"].items() if k.startswith("chunk/")
             and k.rpartition("/")[2].startswith("sync.")]
    if not waits:
        return None
    return 1e3 * sum(waits) / ctx["steps"]
