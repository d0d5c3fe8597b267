"""Typed configuration for the SubZero-TPU solver.

The reference model (SeaIce-Math/SubZero) scatters its physics constants and
process cadences across many files (flags at ``Subzero.m:6-32``, cadences
hard-coded in ``mod(i_step, K)`` expressions at ``Subzero.m:169,220,276,317-339``,
constants like rho_ice=920 repeated in >=6 files).  Here every flag, interval,
clamp, and empirical constant is collected into one frozen dataclass tree so a
run is fully described by its config (SURVEY.md section 5 "Config / flag
system").

All classes are frozen and hashable; numeric fields are plain Python
floats/ints.

This is the PyTorch port's own copy of ``subzero_tpu/config.py``, kept
field-for-field and default-for-default identical so that one set of values
means the same in both packages (the port imports nothing of
``subzero_tpu``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class PhysicsConfig:
    """Physical constants of the ice/ocean/atmosphere system.

    Reference values: ``calc_trajectory.m:58-66`` (densities, drag),
    ``floe_interactions.m:20-21`` (nu, mu), ``initialize_ocean.m:4-8``
    (Coriolis, Ekman turn angle).
    """

    # When False, ocean/atmosphere stresses are never computed (the uniaxial
    # validation case's "doInt.flag = false" edit, README.md Validation 1h).
    ocean_coupling: bool = True
    rho_ice: float = 920.0          # kg/m^3
    rho_ocean: float = 1027.0       # kg/m^3
    rho_air: float = 1.2            # kg/m^3
    cd_ocean: float = 3e-3          # ice-ocean drag coefficient
    cd_atm: float = 1e-3            # ice-atmosphere drag coefficient
    f_coriolis: float = 1.4e-4      # 1/s
    turn_angle: float = 15.0 * 3.141592653589793 / 180.0  # Ekman turn angle, rad
    nu_poisson: float = 0.3         # Poisson ratio (shear modulus G = E/2(1+nu))
    mu_friction: float = 0.2        # Coulomb friction coefficient
    # Thermodynamics (initialize_ocean.m:37-46)
    k_thermal: float = 2.14         # W/(m K)
    t_air: float = -20.0            # deg C
    t_ocean: float = 0.0            # deg C
    latent_heat: float = 2.93e5     # J/kg


@dataclass(frozen=True)
class ContactConfig:
    """Contact-force model constants (floe_interactions.m)."""

    # Region area cull: regions with area < min(N1,N2)*small_region_coeff are
    # dropped (floe_interactions.m:79).
    small_region_coeff: float = 100.0 / 1.75
    # Overlap fraction beyond which two floes are flagged to merge
    # (floe_interactions.m:55-59).
    merge_overlap_frac: float = 0.55
    # Overlap fraction of a floe with the *outside* of the domain beyond which
    # it is absorbed into the boundary (floe_interactions.m:37-39).
    boundary_overlap_frac: float = 0.75
    # Minimum number of boundary crossings for a contact force to be applied
    # (floe_interactions.m:71 requires >=2 InterX points).
    min_crossings: int = 2
    # Minimum contact-chord length for a valid force direction
    # (floe_interactions.m:142 `dl < 0.1`).
    min_chord: float = 0.1
    # Contact-point velocity form for the tangential force:
    # "reference" = the radial v = [U V] + ksi*(p - r) of
    # floe_interactions.m:170-171 (what the MATLAB model actually computes);
    # "rigid" = the physically-correct rigid-body cross product.
    tangential_velocity: str = "reference"
    # Per-region contact forces (floe_interactions.m:92-190 applies one force
    # per disjoint overlap region).  When True (default) the narrow phase
    # decomposes multi-crossing pairs' overlaps into regions on device
    # (geometry/regions.py) and applies force/torque/stress per region, with
    # the small-region cull per region (:79-83); pairs whose decomposition
    # is degenerate fall back to the single aggregate contact.  False =
    # aggregate only: exact for convex/single-region contacts, ~13% faster
    # at 10k floes, with the measured multi-region envelope of
    # tests/test_aggregation_error.py.
    per_region: bool = True
    # Crossing capacity of the on-device region decomposition; pairs with
    # more boundary crossings fall back to the aggregate contact.  16 is the
    # golden-validated value (tests/test_golden.py per-region scenarios).
    region_cap: int = 16
    # Fraction of pair slots eligible for region decomposition per step.
    # Pairs with <= 2 crossings have a single overlap region, where the
    # aggregate contact is exact — so only the (rare) pairs with >= 4
    # crossings are decomposed, compacted into a fixed pool of
    # ceil(frac * n_pairs) slots.  If the pool overflows, the whole step
    # falls back to aggregate contacts (a partial pool would break force
    # antisymmetry); aux.region_overflow flags the degradation.  Under the
    # Simulation driver with region_pool_auto the pool GROWS from this
    # starting fraction on demand, so the default is sized for the common
    # convex-dominated case (the pool's fixed overhead is the tax every
    # step pays; see BASELINE.md).
    region_pair_frac: float = 0.001953125  # 1/512
    # Auto-size the pool (Simulation driver only): when a chunk reports
    # pool overflow, the driver re-jits the step with the pool grown to the
    # measured demand and RE-RUNS the chunk — no step ever executes with
    # degraded (aggregate-fallback) physics, and no manual per-workload
    # frac tuning is needed.  Costs one recompile per growth.
    region_pool_auto: bool = True
    # Active-pair pool: compact the broad-phase candidate pairs whose
    # world-frame bounding boxes actually overlap into a fixed pool and run
    # the clip + force kernels only on those.  EXACT: a pair whose bboxes
    # don't meet has zero overlap area, zero crossings and zero force, so
    # dropping it changes nothing (A/B collision counts match).  Measured
    # OFF by default: in this model's headline regimes (dense packs) the
    # bbox-active fraction is 21-53%, and the pool's random-access polygon
    # gathers break XLA's fused streaming clip — 304k vs 474k floe-steps/s
    # on the 10240-floe bench, 77 vs 105 steps/s on the uniaxial storm
    # state (BASELINE.md).  Worth enabling only for genuinely sparse
    # workloads (low-concentration basins).  Sized by pair_pool_frac of
    # the n*K pair slots; two-way auto-sized by the driver like the region
    # pool (on overflow the whole step's contacts are zeroed, flagged, and
    # the chunk re-runs at the grown size — no degraded step survives).
    pair_pool: bool = False
    pair_pool_frac: float = 0.0625  # 1/16 lean start; auto-sized
    # Tangential length scale dl of per-region contacts: "chord" (default,
    # |region chord|, the TPU-native form — ensemble delta vs the reference
    # measured in validation/GOLDEN.md) or "edge_mean" (reference-exact mean
    # length of the overlap region's edges lying on floe 1's boundary,
    # floe_interactions.m:126-131).
    region_dl: str = "chord"
    # Normal-force direction of per-region contacts:
    # "analytic" (default): the overlap-reducing chord perpendicular — the
    #   exact steepest-descent direction of the region's overlap area (to
    #   first order in the displacement), so no disambiguation pass is
    #   needed.
    # "reclip": reference-exact finite-probe disambiguation
    #   (floe_interactions.m:139-165): displace floe 1 by the unit direction,
    #   re-decompose the overlap, match each region to its displaced image
    #   by bbox overlap with a 1.5 m margin (the reference matches by
    #   polygon intersection; odd toggle count = flip, oracle.py:371-378),
    #   and flip the direction when the displaced region's area GREW.  The
    #   1 m probe is finite, so this occasionally reverses the analytically
    #   correct direction (validation/GOLDEN.md measured 3/60 ensemble
    #   pairs); the knob exists to reproduce the reference bit-for-bit.
    #   Costs one extra region decomposition per pool slot per region.
    normal_dir: str = "analytic"
    # Wall force-component zeroing tolerance (floe_interactions_all.m:157-166
    # zeroes the wall-parallel force component when the contact point sits ON
    # |x|=Lx / |y|=Ly — compared with ==, which never fires for a region
    # centroid, so the reference rule is effectively inert and wall friction
    # survives).  0.0 reproduces that; a positive tolerance (meters) enables
    # the rule as written.
    wall_zero_tol: float = 0.0


@dataclass(frozen=True)
class ClampConfig:
    """Stability clamps applied in the trajectory update (calc_trajectory.m)."""

    max_thickness: float = 10.0     # m  (calc_trajectory.m:36-37)
    min_mass: float = 100.0         # kg; below this the floe dies (:38-40)
    dead_mass: float = 1e3         # mass assigned to a dying tiny floe (:39)
    # |F| may not exceed mass/(force_dt_factor*dt); divided by 10 until it
    # complies (calc_trajectory.m:42-46).
    force_dt_factor: float = 5.0
    # |du/dt * dt| <= accel_h_factor * h (calc_trajectory.m:184-204)
    accel_h_factor: float = 0.5
    max_spin: float = 1e-5          # rad/s (calc_trajectory.m:215-217)


@dataclass(frozen=True)
class ProcessConfig:
    """Flags and cadences of the floe life-cycle processes (Subzero.m:6-32
    flags; cadences at Subzero.m:169,220,276,317-339)."""

    collision: bool = True
    periodic: bool = False
    ridging: bool = False
    rafting: bool = False
    fractures: bool = False
    welding: bool = False
    corners: bool = True
    packing: bool = False
    keep_min: bool = False          # keep floes below min_floe_size
    # Thickness-growth-rate flag: welding fires only when dhdt > 0
    # ("freezing conditions", Subzero.m:318 `WELDING && ... && dhdt > 0`;
    # both reference configs set dhdt = 1).
    dhdt: float = 1.0
    # AVERAGE flag (Subzero.m:230-247,304-314): accumulate Eulerian fields
    # between outputs and emit the time mean instead of the instantaneous
    # snapshot.
    average: bool = False
    # Advect-diffuse the dissolved-mass field each chunk
    # (Advect_Dissolved_Ice.m; the reference driver carries the call
    # DISABLED at Subzero.m:359 in favor of pure accumulation — False
    # reproduces that default).
    advect_dissolved: bool = False

    # Cadences, in steps
    n_dt_out: int = 150             # snapshot/diagnostics output
    n_simplify: int = 20            # boundary simplification
    n_pack: int = 500               # new-ice packing
    n_weld: int = 25                # welding, finest scale
    n_weld_mid: int = 500           # welding at 2x2 scale
    n_weld_coarse: int = 5000       # welding at 1x1 scale
    n_fracture: int = 75            # Mohr-Coulomb fracture
    n_corners: int = 10             # corner grinding
    n_ocean_force: int = 10         # doInt.step: ocean-stress refresh cadence

    # Process constants
    ridge_keep_prob: float = 0.05           # floe_interactions_all.m:294
    ridge_max_h: float = 5.0                # ridging only if h < 5 m
    ridge_boundary_max_h: float = 1.25      # boundary-ridge gate (:353)
    raft_max_h: float = 0.25                # rafting only if h < 0.25 m
    overlap_frac_min: float = 1e-6          # ridge/raft overlap gates (:317)
    overlap_frac_max: float = 0.95
    max_ridge_h: float = 30.0               # ridge_values_update.m:14-16
    min_region_area: float = 1e4            # regions below this dissolve
    weld_coeff: float = 150.0               # Fweld (Subzero.m:318)
    corner_keep_prob: float = 0.7           # rand>0.7 selects ~30% (Subzero.m:341)
    corner_max_overlap: float = 0.15        # skip heavily overlapped (:343)
    fracture_n_pieces: int = 3              # fracture.m:51 -> 3 Voronoi pieces
    # Yield criterion: "mohr" = Mohr-Coulomb cone (fracture.m:21-28, the
    # reference default — the cone assignment overwrites the ellipse), or
    # "ellipse" = the Hibler elliptical yield curve (fracture.m:9-19) that
    # the Nares recipe re-enables with Pstar = 1e5 (README.md Validation
    # 2 item 7: "set Pstar = 1e5 and make sure all the Mohr's cone lines
    # are commented out").
    fracture_criterion: str = "mohr"
    fracture_sig_c: float = 250e3           # Mohr-Coulomb SigC (fracture.m:21-28)
    fracture_q: float = 5.2                 # Mohr-Coulomb slope q
    fracture_sig11: float = -3.375e4        # cone vertex (uniaxial: +1.5e5)
    fracture_pstar: float = 2.25e5          # ellipse P* (fracture.m:9)
    fracture_c: float = 20.0                # ellipse concentration decay C
    # Driver compactness argument: P = Pstar*h*exp(-C*(1-compactness))
    # (Subzero.m:335 passes 1).
    fracture_compactness: float = 1.0
    # Kill floes whose lowest vertex drops below the domain's southern wall
    # (the Nares export rule, README.md Validation 2 item 6b: alive = 0 when
    # min(c_alpha y) + Yi < min(boundary y)).  Their mass is EXPORTED, not
    # dissolved, in the ledger.
    kill_below_ymin: bool = False
    simplify_max_verts: int = 30            # Subzero.m:185
    fuse_min_area: float = 2e4              # kill/transfer fuse gate (f_i_all.m:477)


@dataclass(frozen=True)
class CapacityConfig:
    """Fixed buffer capacities for the SoA state (design delta #1 in
    SURVEY.md section 7: struct arrays -> fixed-capacity masked arrays)."""

    max_floes: int = 256            # Nmax: floe slots (alive mask selects real ones)
    # Vmax: vertex slots per floe.  64 so FloeSimplify's 30-vertex
    # threshold (simplify_max_verts, Subzero.m:185) governs shape
    # complexity, as in the reference, instead of birth-time truncation.
    # Decided by the round-5 matched-seed ensemble (validation/
    # VERTEX_CAP.md): a 32 cap systematically over-fragments the winter
    # pack (137 vs 93 mean floes after 1000 steps, every seed pair; FSD/
    # ITD deltas 2-4x the chaotic noise floor) for a 1.40x wall saving.
    max_verts: int = 64
    # Dynamic vertex rung (two-way auto-sizing, like the contact pools).
    # The state's vertex axis runs at ``active_verts`` (None = max_verts);
    # a birth that needs more vertices grows the rung toward max_verts
    # (the fidelity/truncation bound stays max_verts) and the driver
    # shrinks it back when the population's max vertex count drops.  Clip
    # cost is O(V^2) per candidate pair, so running the arrays at the
    # population's actual need instead of the fidelity cap is a
    # ~(cap/need)^2 saving on the narrow phase — e.g. the uniaxial
    # fracture storm's children are 6-15-vertex Voronoi pieces that never
    # approach the 64-vertex truncation bound.
    active_verts: "int | None" = None
    verts_auto: bool = True
    max_neighbors: int = 16         # K: candidate contacts per floe (broad phase)
    max_ghosts: int = 64            # per-direction halo-exchange buffer (spatial)
    max_per_cell: int = 16          # cell-list broad-phase occupancy cap
    n_mc_points: int = 1000         # Monte-Carlo samples per floe (initialize_floe_values.m:30)
    stress_window: int = 1000       # stress-history ring buffer length (:24)

    @property
    def verts_now(self) -> int:
        """Vertex-axis size the state arrays currently run at."""
        return self.active_verts or self.max_verts


@dataclass(frozen=True)
class NumericsConfig:
    dt: float = 10.0                # s (Subzero.m:36)
    dtype: str = "float32"          # compute dtype on device
    # Broad-phase implementation: "n2" (all-pairs) or "cells" (cell list)
    broadphase: str = "n2"
    # Cell size for the cell-list broad phase; must be >= 2*max(rmax).
    cell_size: float = 0.0
    # Contact geometry implementation: "integral" (closed-form
    # parity-integral clip, the XLA twin; csrc/clip.cu on the card),
    # "pallas" (the Pallas TPU kernel's own float32 math, a different
    # function of the same pairs; csrc/clip_pallas.cu on the card, float32
    # stats in any configuration), or "xla" (segment-midpoint formulation,
    # the original reference implementation of the clip).
    contact_impl: str = "integral"
    # Spatial decomposition (1-D slab mesh): overlap the ghost-floe halo
    # exchange with interior contact compute (SURVEY.md section 7 M5).
    # The narrow phase splits into an interior pass (all local floes vs
    # local sources — no data dependency on the ppermute, so the TPU
    # latency-hiding scheduler can run the collective underneath it) and a
    # packed band pass (floes within a halo width of a slab edge vs the
    # arrived ghosts), merged back into the standard [N, K] pair tables.
    overlap_halo: bool = True


@dataclass(frozen=True)
class DomainConfig:
    """Rectangular domain |x|<=lx, |y|<=ly (initialize_boundaries.m)."""

    lx: float = 1e5
    ly: float = 1e5


@dataclass(frozen=True)
class SimConfig:
    physics: PhysicsConfig = PhysicsConfig()
    contact: ContactConfig = ContactConfig()
    clamps: ClampConfig = ClampConfig()
    processes: ProcessConfig = ProcessConfig()
    capacity: CapacityConfig = CapacityConfig()
    numerics: NumericsConfig = NumericsConfig()
    domain: DomainConfig = DomainConfig()
    # Effective elastic modulus, set from the initial floe field:
    # Modulus = 1.5e3*(mean(sqrt(A)) + min(sqrt(A)))  (Subzero.m:77)
    modulus: float = 1.5e3 * 2e3
    # Minimum floe area to stay in the simulation (Subzero.m:73)
    min_floe_size: float = 1e6
    # Ocean heat flux HFo (initialize_ocean.m:45); negative = freezing
    heat_flux: float = 0.0
    # Number of immovable boundary/topography floes occupying slots [0, n_boundary)
    n_boundary: int = 0

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def default_modulus(areas) -> float:
    """Elastic modulus from the initial floe field (Subzero.m:77)."""
    import numpy as np

    r = np.sqrt(np.asarray(areas, dtype=np.float64))
    return float(1.5e3 * (r.mean() + r.min()))
