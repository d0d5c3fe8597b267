# gather_state is the port's counterpart of reading a sharded global
# jax.Array; __all__ is the JAX package's
from .spatial import (
    gather_state,
    make_spatial_step,
    rebalance_slabs,
    shard_state,
    slab_bounds,
)
from .spatial2d import (
    load_imbalance,
    make_spatial_step_2d,
    rebalance_tiles,
    shard_state_2d,
)

__all__ = [
    "make_spatial_step",
    "rebalance_slabs",
    "shard_state",
    "slab_bounds",
    "make_spatial_step_2d",
    "rebalance_tiles",
    "shard_state_2d",
    "load_imbalance",
]
