"""Floe-vs-coast pairs that carry a contact force (the count
``contact.coast_pairs`` of ``Simulation.phase_times``: a pair of a free
floe and a static coastline floe, slot < ``n_boundary``), in the last
timed segment, per segment step.  Nothing where the configuration holds
no coastline floes or the program keeps no such count."""

KIND = "per_layer"
LAYER = "Floe contact (dynamics/contact.py contact_forces, geometry/regions.py)"
UNIT = "pairs/step"
SOURCE = "program_counter"
MOVES = "floe_steps_per_s"


def read(ctx):
    run = ctx["run"]
    if run.start.cfg.n_boundary == 0:
        return None
    counts = getattr(getattr(run.end, "phase_times", None), "counts", None)
    if counts is None or "contact.coast_pairs" not in counts:
        return None
    return counts["contact.coast_pairs"] / run.n_seg
