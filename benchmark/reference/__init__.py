"""The benchmark's plain reference: numpy in float64, and the native polygon
engine copied beside it.  It imports nothing of ``subzero_tpu_torch``,
``subzero_tpu`` or ``jax``; the harness hands it plain numpy arrays."""
