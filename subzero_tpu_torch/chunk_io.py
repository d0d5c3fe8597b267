"""The chunk's hand-off to the host: what a chunk of device steps gives the
driver (``sim.py``), and the two device->host copies that carry it.

Every chunk ends with ONE copy of its *summary* (:class:`Summary`): the
chunk's scalar telemetry, one entry a field in the order declared there,
then one exported-mass slot a step.  A lifecycle boundary adds ONE copy of
the *boundary fetch* (:func:`fetch_boundary`): the host view (the columns
of ``processes/host.py``), the last step's contact entries as a compacted
pool, the dissolved grid and, when a merge was flagged, the chunk's merge
pairs as a pool, as column blocks of one ``[N, W]`` tensor laid out by
:func:`boundary_columns`.  A pool that overflows costs one more copy: the
dense tables it stands for.
"""

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .dynamics.contact import compact
from .dynamics.step import StepAux
from .processes.host import HostView, pack_view, unpack_view, view_width
from .trace import span

__all__ = ["ChunkAux", "Summary", "Boundary", "summary_vector",
           "read_summary", "boundary_columns", "pack_boundary",
           "fetch_boundary", "gather_chunk", "chunk_merge_pairs"]


class ChunkAux:
    """The StepAux of every step of one chunk.  Field ``f`` reads as the
    ``[c, ...]`` stack over the chunk's steps (built on first access, like
    the JAX scan's stacked aux); ``last`` is the last step's StepAux."""

    def __init__(self, steps: list):
        self._steps = steps
        self._stacked = {}
        self.last = steps[-1]

    def __getattr__(self, name):
        if name.startswith("_") or name not in StepAux._fields:
            raise AttributeError(name)
        if name not in self._stacked:
            self._stacked[name] = torch.stack(
                [getattr(a, name) for a in self._steps])
        return self._stacked[name]


def gather_chunk(chunk: ChunkAux, mesh, fields=StepAux._fields) -> ChunkAux:
    """A mesh chunk's aux as the global arrays: the last step whole and
    the ``fields`` of every earlier step, each per-floe field gathered from
    every rank's slab along the floe axis (scalars are global already).
    Every rank calls it at the same point of the loop, so the gathers line
    up."""
    def gather(aux: StepAux, names) -> StepAux:
        return aux._replace(**{
            f: mesh.all_gather(getattr(aux, f)) for f in names
            if getattr(aux, f).dim()})

    steps = chunk._steps
    return ChunkAux([gather(a, fields) for a in steps[:-1]]
                    + [gather(steps[-1], StepAux._fields)])


# -- the summary -------------------------------------------------------------

class Summary(NamedTuple):
    """The chunk's summary, in the order of its device vector.  On the
    device (:func:`summary_vector`) each field is a 0-d tensor; on the host
    (:func:`read_summary`) it has the type annotated here."""

    merge_any: bool            # a merge flag at any step
    region_overflow: int       # steps whose per-region pool overflowed
    region_pool_need: int      # the largest per-region pool demand
    n_collisions: int          # the largest step's collision count
    # lifecycle skip hints (Lifecycle.dues)
    any_oversize: bool
    any_contact: bool
    any_pair_overlap: bool
    nbr_overflow: bool         # broad-phase candidate overflow at any step
    nbr_demand: int
    pair_pool_overflow: int    # steps whose active-pair pool overflowed
    pair_pool_need: int
    max_nv: int                # the largest live vertex count
    coast_pairs: int           # trace count contact.coast_pairs
    exported_floes: int        # trace count step.exported_floes
    export_slots: np.ndarray   # exported mass of each step, last

    @property
    def exported_mass(self) -> float:
        """The per-step export slots summed in float64 on the host."""
        return float(np.sum(self.export_slots.astype(np.float64)))

    @property
    def hints(self) -> dict:
        return {k: getattr(self, k) for k in (
            "any_oversize", "any_contact", "any_pair_overlap")}


_TYPES = tuple(Summary.__annotations__.values())[:-1]


def summary_vector(chunk: ChunkAux, state, exported: list, n_exported: list,
                   slots: int, cfg, dtype, mesh=None) -> torch.Tensor:
    """The chunk's :class:`Summary` as ONE vector in ``dtype``: the scalar
    fields, then ``slots`` export slots (``exported``: each step's exported
    mass, ``n_exported`` its exported floes).  ``state`` is the chunk's end
    state."""
    last = chunk.last
    exp = torch.zeros((slots,), dtype=dtype, device=state.x.device)
    exp[:len(exported)] = torch.stack(exported).to(dtype)
    i32 = torch.int32
    s = Summary(
        merge_any=chunk.merge_i.any(),
        region_overflow=chunk.region_overflow.to(i32).sum(),
        region_pool_need=chunk.region_pool_need.max(),
        n_collisions=chunk.n_collisions.max(),
        any_oversize=torch.any(state.alive & (
            state.nv > cfg.processes.simplify_max_verts)),
        any_contact=torch.any(last.pair_valid)
        | torch.any(last.boundary_contact),
        any_pair_overlap=torch.any(last.overlap_area > 0),
        nbr_overflow=chunk.nbr_overflow.any(),
        nbr_demand=chunk.nbr_demand.max(),
        pair_pool_overflow=chunk.pair_pool_overflow.to(i32).sum(),
        pair_pool_need=chunk.pair_pool_need.max(),
        max_nv=torch.max(torch.where(state.alive, state.nv,
                                     torch.zeros_like(state.nv))),
        coast_pairs=chunk.n_coast_pairs.sum(),
        exported_floes=torch.stack(n_exported).sum(),
        export_slots=exp,
    )
    head = torch.stack([t.to(dtype) for t in s[:-1]])
    if mesh is not None:
        # the flags read from this rank's slab; every other entry is
        # global already
        head = mesh.pmax(head)
    return torch.cat([head, exp])


def read_summary(vec: np.ndarray) -> Summary:
    """The fetched summary vector as a :class:`Summary`."""
    n = len(_TYPES)
    return Summary(*(t(v) for t, v in zip(_TYPES, vec[:n])), vec[n:])


# -- the boundary fetch ------------------------------------------------------

# merge-pair pool capacity of the boundary fetch: merges are a few per
# chunk in every reference case; the full [c, N, K] tables are fetched
# only when the pool overflows
MERGE_POOL = 256

# the last step's [N, K] tables the lifecycle reads, in the order of the
# contact-entry rows (after the flat slot) and of the dense tables
_AUX_FIELDS = ("pair_valid", "pair_px", "pair_py", "pair_fx", "pair_fy",
               "pair_overlap", "nbr_idx")


class Boundary(NamedTuple):
    """What the lifecycle gets at a boundary, from :func:`fetch_boundary`."""

    view: HostView
    aux: SimpleNamespace       # the last step's [N, K] tables (_AUX_FIELDS)
                               # and boundary_contact [N], as numpy arrays
    dissolved: np.ndarray      # the dissolved grid, float64
    merge_pairs: list          # (absorbee, partner), first occurrence first
    aux_cap: int               # the contact-entry pool of the next fetch


def boundary_columns(n: int, v_cap: int, aux_cap: int, grid_cells: int,
                     merges: bool) -> dict:
    """The boundary fetch's column blocks of an ``[n, W]`` tensor, in
    order: the view, the boundary-contact flag, the contact-entry pool
    (count, then ``aux_cap`` rows of the flat slot and :data:`_AUX_FIELDS`;
    slot -1 past the count), the dissolved grid and, with ``merges``, the
    merge-pair pool (count, i_0, j_0, i_1, j_1, ...; -1 past the count).
    A flat block fills its columns column-major, padded with zeros."""
    flat = {"aux": 1 + 8 * aux_cap, "dissolved": grid_cells}
    if merges:
        flat["merges"] = 1 + 2 * MERGE_POOL
    widths = {"view": view_width(v_cap), "contact": 1,
              **{k: -(-m // n) for k, m in flat.items()}}
    cols, at = {}, 0
    for k, w in widths.items():
        cols[k] = slice(at, at + w)
        at += w
    return cols


def _contact_entries(last: StepAux, cap: int) -> torch.Tensor:
    """The last step's contact entries as a pool: the slots with a valid
    contact or a positive overlap, all the lifecycle reads (corner contact
    points, fracture deform info, ridge/raft selection)."""
    keep = (last.pair_valid | (last.pair_overlap > 0)).reshape(-1)
    _, count, filled, sel = compact(keep, cap)
    dt = last.pair_px.dtype
    rows = torch.stack([torch.where(filled, sel, -1).to(dt)] + [
        getattr(last, f).reshape(-1)[sel].to(dt) for f in _AUX_FIELDS],
        dim=1)                                          # [cap, 8]
    return torch.cat([count[None].to(dt), rows.reshape(-1)])


def _merge_entries(chunk: ChunkAux) -> torch.Tensor:
    """The chunk's merge flags as a pool of (floe, partner) pairs in
    np.nonzero's (step, floe, slot) order, so the host's first-occurrence
    dedup matches :func:`_merge_pairs_from`, each partner from its own
    step's neighbour table."""
    mi = chunk.merge_i                                  # [c, N, K] bool
    _, nn, k = mi.shape
    _, count, filled, sel = compact(mi.reshape(-1), MERGE_POOL)
    pairs = torch.stack([(sel // k) % nn,
                         chunk.nbr_idx.reshape(-1)[sel].to(torch.int64)], 1)
    pool = torch.where(filled[:, None], pairs, -1)
    return torch.cat([count[None], pool.reshape(-1)])


def pack_boundary(state, chunk: ChunkAux, dissolved: torch.Tensor,
                  aux_cap: int, merges: bool = False) -> torch.Tensor:
    """The boundary fetch as ONE ``[N, W]`` tensor in the state dtype
    (:func:`boundary_columns`)."""
    n, dt = state.n, state.x.dtype
    blocks = {"view": pack_view(state),
              "contact": chunk.last.boundary_contact[:, None],
              "aux": _contact_entries(chunk.last, aux_cap),
              "dissolved": dissolved.reshape(-1)}
    if merges:
        blocks["merges"] = _merge_entries(chunk)
    out = []
    for k, cols in boundary_columns(n, state.v_cap, aux_cap,
                                    dissolved.numel(), merges).items():
        b = blocks[k].to(dt)
        if b.dim() == 1:
            w = cols.stop - cols.start
            b = torch.cat([b, b.new_zeros(n * w - b.shape[0])]
                          ).reshape(w, n).T
        out.append(b)
    return torch.cat(out, dim=1)


def _aux_tables(d, bc: np.ndarray) -> SimpleNamespace:
    """The lifecycle's aux from the [N, K] tables of _AUX_FIELDS, in
    order, and the boundary-contact flags."""
    aux = dict(zip(_AUX_FIELDS, d))
    aux["pair_valid"] = aux["pair_valid"] != 0
    aux["nbr_idx"] = aux["nbr_idx"].astype(np.int32)
    return SimpleNamespace(**aux, boundary_contact=bc != 0)


def fetch_boundary(state, chunk: ChunkAux, dissolved: torch.Tensor,
                   aux_cap: int, merges: bool, mesh=None) -> Boundary:
    """:func:`pack_boundary`, its ONE device->host copy and the unpacking:
    the span ``aux_fetch`` holds the copy, the view, the aux and the
    dissolved grid, ``merge_fetch`` the merge pairs.  A contact-entry pool
    that overflowed is fetched as the dense tables instead (one more copy)
    and its capacity grown for the next fetch; a merge pool that overflowed
    (a storm-scale merge burst), as the chunk's full merge tables.  On a
    mesh every rank calls it (the summary is reduced over the mesh, the
    lifecycle is shared)."""
    with span("aux_fetch"):
        if mesh is not None:
            chunk = gather_chunk(chunk, mesh,
                                 ("merge_i", "nbr_idx") if merges else ())
        n, last = state.n, chunk.last
        cols = boundary_columns(n, state.v_cap, aux_cap, dissolved.numel(),
                                merges)
        packed = pack_boundary(state, chunk, dissolved, aux_cap,
                               merges).cpu().numpy()

        def flat(k):
            return packed[:, cols[k]].T.reshape(-1)

        view = unpack_view(packed[:, cols["view"]], n)
        entries = flat("aux")
        count = int(entries[0])
        if count > aux_cap:
            while aux_cap < count * 1.25:
                aux_cap *= 2
            d = torch.stack([getattr(last, f).to(last.pair_px.dtype)
                             for f in _AUX_FIELDS]).cpu().numpy()
        else:
            rows = entries[1:1 + 8 * aux_cap].reshape(-1, 8)
            ok = rows[:, 0] >= 0
            slot = rows[ok, 0].astype(np.int64)
            d = []
            # one table a field: [N, K] blocks the allocator reuses, where
            # one [7, N, K] block is mapped and faulted in anew each fetch
            for i in range(len(_AUX_FIELDS)):
                t = np.zeros(last.nbr_idx.shape)
                t.reshape(-1)[slot] = rows[ok, 1 + i]
                d.append(t)
        aux = _aux_tables(d, packed[:, cols["contact"]][:, 0])
        grid = np.asarray(flat("dissolved")[:dissolved.numel()].reshape(
            tuple(dissolved.shape)), np.float64)
    with span("merge_fetch"):
        pairs = []
        if merges:
            vals = flat("merges")
            cnt = int(vals[0])
            if cnt > MERGE_POOL:
                pairs = chunk_merge_pairs(chunk, chunk.merge_i.shape[0])
            else:
                pool = vals[1:1 + 2 * cnt].astype(np.int64).reshape(-1, 2)
                pairs = list(dict.fromkeys((int(i), int(j)) for i, j in pool))
    return Boundary(view, aux, grid, pairs, aux_cap)


def _merge_pairs_from(mi: np.ndarray, nbr: np.ndarray, n: int
                      ) -> "list[tuple[int, int]] | None":
    mi = mi[:n]
    nbr = nbr[:n]
    if not mi.any():
        return None
    s_t, i_t, k_t = np.nonzero(mi)
    return list(dict.fromkeys(
        (int(i), int(nbr[s, i, k]))
        for s, i, k in zip(s_t, i_t, k_t)))


def chunk_merge_pairs(auxes: ChunkAux, n: int
                      ) -> "list[tuple[int, int]] | None":
    """(absorbee, partner) merge pairs OR'd across the chunk's first ``n``
    steps (``auxes.merge_i`` / ``auxes.nbr_idx`` are [c, N, K]), fetched in
    one copy.

    The reference fuses >55%-overlap pairs EVERY step
    (floe_interactions_all.m:470-501); flags raised at any step of the chunk
    must not be dropped just because the overlap cleared by the last step —
    each flag is resolved against its own step's neighbor table."""
    mk = torch.stack([auxes.merge_i.to(torch.int64),
                      auxes.nbr_idx.to(torch.int64)], dim=-1).cpu().numpy()
    return _merge_pairs_from(mk[..., 0] != 0, mk[..., 1], n)
