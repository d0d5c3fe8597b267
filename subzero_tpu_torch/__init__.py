"""subzero_tpu_torch — the PyTorch/CUDA port of subzero_tpu.

A second package beside the JAX one, with the same module layout and public
names so that each function's counterpart is easy to find.  Plain tensor
code is PyTorch; the parity-integral clip, the one Pallas TPU kernel of the
JAX package, is a CUDA C++ kernel written for Hopper
(``csrc/clip_pallas.cu``, bound in ``kernels/clip_pallas.py``), and so is
its XLA twin, the default contact clip (``csrc/clip.cu``,
``kernels/clip.py``).

The port imports nothing of ``subzero_tpu`` (its numpy helpers and config
are copied).  Entry points run on the GPU (``device="cuda"``) unless the
caller passes ``device="cpu"``, as the tests do; on CPU tensors every kernel
wrapper uses its plain PyTorch version.

Ported: everything the JAX package does — the ``Simulation`` driver
(``sim.py``) with its figures (``plotting.py``), the lifecycle boundary and
its passes (``processes/``), the Eulerian diagnostics, the Voronoi initial
state, the validation cases and their campaign (``campaign.py``), the whole
geometry surface, the serial oracle
(``oracle.py``) and the multi-device spatial decomposition (``parallel/``,
on ``torch.distributed``) — at every contact and broad-phase option of the
JAX step.
"""

from .config import SimConfig

__version__ = "0.1.0"
__all__ = ["SimConfig", "__version__"]
