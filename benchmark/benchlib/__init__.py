"""The benchmark of subzero_tpu_torch: harness, yardstick and readers.

Everything here is the benchmark's own.  It drives the program
(``subzero_tpu_torch``) through its public constructors and
``Simulation.run``, and judges what that produces with the plain
reference in ``benchmark/reference/``.
"""
