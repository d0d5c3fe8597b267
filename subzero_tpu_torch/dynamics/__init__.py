from .broadphase import neighbor_candidates, neighbor_candidates_cells
from .contact import contact_forces, boundary_contact
from .trajectory import trajectory_update
from .step import make_step_fn, StepAux

__all__ = [
    "neighbor_candidates",
    "neighbor_candidates_cells",
    "contact_forces",
    "boundary_contact",
    "trajectory_update",
    "make_step_fn",
    "StepAux",
]
