"""Mutation state and the delete / consolidate / reuse / grow lifecycle.

Port of `repro.core.mutations`: the packed tombstone bitmap and the
per-row label plane that every search path reads, the free pool and
counters, and the operations over them — `delete_rows` (tombstone),
`consolidate` (graph repair around tombstoned rows, slots freed),
`take_free_slots` (insert-side reuse) and `grow_state` / `grow_rows`
(capacity growth by copy-extension).

  * `tombstone_bits` is a PACKED bitmap (uint8[ceil(capacity/8)], one bit
    per row, little-endian within each byte): "may this id be returned?"
    is a single bit test.
  * `labels` is a per-row label bitset (uint8[capacity, N_LABEL_BYTES]); a
    row matches a filter when its bitset intersects the filter's byte mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.medoid import compute_medoid
from repro_torch.core.robust_prune import robust_prune_batch
from repro_torch.core.vamana import VamanaGraph

# ---------------------------------------------------------------------------
# Packed row bitmap (1 bit per capacity row, little-endian within each byte)
# ---------------------------------------------------------------------------


def bitmap_bytes(capacity: int) -> int:
    return (capacity + 7) // 8


def pack_bitmap(dense: torch.Tensor) -> torch.Tensor:
    """bool[N] -> uint8[ceil(N/8)] (bit i of byte j = row 8*j + i)."""
    n = dense.shape[0]
    pad = (-n) % 8
    d = torch.nn.functional.pad(dense.to(torch.int32), (0, pad)).reshape(-1, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=dense.device)
    return (d << shifts).sum(dim=-1).to(torch.uint8)


def unpack_bitmap(bits: torch.Tensor, n: int) -> torch.Tensor:
    """uint8[ceil(N/8)] -> bool[N]."""
    b = bits.to(torch.int32)[:, None]
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return ((b >> shifts) & 1).reshape(-1)[:n].to(torch.bool)


def bitmap_gather(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-id bit test: int32[...] -> bool[...] (negative ids -> False).
    One byte gather + shift/mask per id; the bitmap never unpacks."""
    safe = torch.clamp(ids, min=0).long()
    byte = bits[safe >> 3].to(torch.int64)
    bit = (byte >> (safe & 7)) & 1
    return (bit == 1) & (ids >= 0)


# ---------------------------------------------------------------------------
# Per-row label bitsets (filtered / multi-tenant search)
# ---------------------------------------------------------------------------

N_LABEL_BYTES = 4
N_LABELS = 8 * N_LABEL_BYTES


def _check_label(label: int) -> int:
    label = int(label)
    if not 0 <= label < N_LABELS:
        raise ValueError(f"label id {label} out of range [0, {N_LABELS})")
    return label


def filter_to_bytes(label_ids) -> np.ndarray:
    """Label-id set -> uint8[N_LABEL_BYTES] byte mask (the runtime search
    operand: a row matches when its label row ANDs nonzero against it)."""
    fb = np.zeros((N_LABEL_BYTES,), np.uint8)
    for label in label_ids:
        label = _check_label(label)
        fb[label >> 3] |= np.uint8(1 << (label & 7))
    return fb


def pack_label_rows(labels, n_rows: int) -> np.ndarray:
    """Per-row label sets -> uint8[n_rows, N_LABEL_BYTES] bitset rows.

    `labels` may be None (all-zero rows: the row matches no filter), a
    scalar label id (broadcast to every row), a 1-D int sequence (one
    label per row), or a sequence of per-row label-id iterables.
    """
    out = np.zeros((n_rows, N_LABEL_BYTES), np.uint8)
    if labels is None:
        return out
    if np.isscalar(labels) or getattr(labels, "ndim", None) == 0:
        labels = [labels] * n_rows
    rows = list(labels)
    if len(rows) != n_rows:
        raise ValueError(f"labels: got {len(rows)} rows, want {n_rows}")
    for i, row in enumerate(rows):
        ids = (row,) if np.isscalar(row) else tuple(row)
        for label in ids:
            label = _check_label(label)
            out[i, label >> 3] |= np.uint8(1 << (label & 7))
    return out


def label_match_gather(labels: torch.Tensor, filter_bytes: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """Per-id filter test: int32[...] -> bool[...] — True iff the row's
    label bitset intersects `filter_bytes` (negative ids -> False)."""
    safe = torch.clamp(ids, min=0).long()
    rows = labels[safe]
    hit = ((rows & filter_bytes.to(torch.uint8)) != 0).any(dim=-1)
    return hit & (ids >= 0)


# ---------------------------------------------------------------------------
# Mutation state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MutationState:
    """Delete/reuse bookkeeping for one capacity-allocated index.

    tombstone_bits: uint8[ceil(cap/8)]  1 = dead (deleted or freed)
    labels:         uint8[cap, NB]      per-row label bitsets
    free_ids:       int32[cap]          reusable slots, ascending, -1 padded
    n_free, n_deleted, generation:      host ints (checkpointed as int32)
    """

    tombstone_bits: torch.Tensor
    labels: torch.Tensor
    free_ids: torch.Tensor
    n_free: int
    n_deleted: int
    generation: int

    @property
    def capacity(self) -> int:
        return self.free_ids.shape[0]


def init_mutation_state(capacity: int, device) -> MutationState:
    return MutationState(
        tombstone_bits=torch.zeros((bitmap_bytes(capacity),), dtype=torch.uint8,
                                   device=device),
        labels=torch.zeros((capacity, N_LABEL_BYTES), dtype=torch.uint8,
                           device=device),
        free_ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        n_free=0, n_deleted=0, generation=0)


# ---------------------------------------------------------------------------
# Batched delete
# ---------------------------------------------------------------------------

def delete_rows(state: MutationState, ids: torch.Tensor, n_valid: int
                ) -> tuple[MutationState, int]:
    """Tombstone `ids` (int[B]); duplicate / out-of-range / already-dead
    entries are ignored. Returns (state', number of rows newly deleted).

    Pure metadata: no vector, code or adjacency bytes move — that work is
    deferred to `consolidate`, which amortizes it over a batch of deletes.
    """
    cap = state.capacity
    dev = state.tombstone_bits.device
    dense = unpack_bitmap(state.tombstone_bits, cap)
    ids = ids.to(device=dev, dtype=torch.long)
    in_range = (ids >= 0) & (ids < n_valid)
    # an extra sink slot stands in for JAX's mode="drop"
    hit = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    hit[torch.where(in_range, ids, torch.full_like(ids, cap))] = True
    newly = hit[:cap] & ~dense
    n_new = int(newly.sum())
    return MutationState(
        tombstone_bits=pack_bitmap(dense | newly),
        labels=state.labels,        # deletes keep label rows (cleared on reuse)
        free_ids=state.free_ids,
        n_free=state.n_free,
        n_deleted=state.n_deleted + n_new,
        generation=state.generation + 1,
    ), n_new


# ---------------------------------------------------------------------------
# Consolidation (batched tombstone-neighbourhood repair)
# ---------------------------------------------------------------------------

def _touched_mask(adjacency: torch.Tensor, deleted_now: torch.Tensor,
                  live: torch.Tensor) -> torch.Tensor:
    """Live rows with at least one out-edge into a freshly deleted row."""
    nbr_dead = (adjacency >= 0) & deleted_now[
        torch.clamp(adjacency, min=0).long()]
    return nbr_dead.any(dim=1) & live


def _repair_rows(vectors: torch.Tensor, adjacency: torch.Tensor,
                 deleted_dense: torch.Tensor, live: torch.Tensor,
                 touched: torch.Tensor, n_valid: int, *, degree_bound: int,
                 alpha: float, chunk: int) -> torch.Tensor:
    """Re-prune one slab of touched rows. touched: int32[T] (-1 padded).

    Candidates for vertex u = (u's live neighbours) ∪ (live neighbours of
    every deleted neighbour of u) — the FreshDiskANN repair rule. Deleted
    candidates are masked through `live` inside RobustPrune, so repaired
    rows never point at tombstoned vertices.
    """
    from repro_torch.core.construction import _adjacency_distances

    r = degree_bound
    rows = adjacency[torch.clamp(touched, min=0).long()]          # (T, R)
    rows = torch.where((touched >= 0)[:, None], rows,
                       torch.full_like(rows, -1))
    dead = (rows >= 0) & deleted_dense[torch.clamp(rows, min=0).long()]
    own = torch.where(dead, torch.full_like(rows, -1), rows)
    # neighbours-of-deleted-neighbours: (T, R, R) -> (T, R*R)
    repl = adjacency[torch.where(dead, rows, torch.zeros_like(rows)).long()]
    repl = torch.where(dead[:, :, None], repl, torch.full_like(repl, -1))
    repl = repl.reshape(rows.shape[0], r * r)
    cand = torch.cat([own, repl], dim=1)                           # (T, R+R*R)
    cand_d = _adjacency_distances(vectors, touched, cand, chunk)
    res = robust_prune_batch(vectors, touched, cand, cand_d, n_valid,
                             degree_bound=r, alpha=alpha, chunk_size=chunk,
                             live=live)
    return res.selected_ids


def consolidate(vectors: torch.Tensor, graph: VamanaGraph,
                state: MutationState, *, params, repair_slab: int = 1024,
                refine: bool = True, vec_sqnorm: torch.Tensor | None = None
                ) -> tuple[VamanaGraph, MutationState, dict]:
    """Repair the graph around tombstoned rows and free their slots.

    Returns (graph', state', {"n_freed", "n_repaired"}); a no-op when
    nothing is tombstoned. The adjacency is repaired in place (the JAX
    version returns a new array).

    refine=True (default) — snapshot RE-LINK: every touched row re-runs
    the insertion pipeline against the tombstoned graph (beam search
    traverses THROUGH deleted rows, the live mask keeps them out of every
    pruned edge list) via `batch_insert_at(already_inserted=True)`.
    refine=False — LOCAL one-hop repair (FreshDiskANN's rule): each
    touched row re-prunes over its live neighbours ∪ its deleted
    neighbours' live neighbours.
    """
    cap = graph.capacity
    r = params.degree_bound
    n_valid = graph.n_valid
    dev = graph.adjacency.device
    dense = unpack_bitmap(state.tombstone_bits, cap)
    row = torch.arange(cap, device=dev) < n_valid
    free_dense = torch.zeros((cap,), dtype=torch.bool, device=dev)
    free_dense[state.free_ids[:state.n_free].long()] = True
    deleted_now = dense & ~free_dense & row
    del_ids = torch.nonzero(deleted_now).flatten()               # ascending
    if del_ids.numel() == 0:
        return graph, state, {"n_freed": 0, "n_repaired": 0}

    live = row & ~dense
    touched = torch.nonzero(
        _touched_mask(graph.adjacency, deleted_now, live)).flatten()
    n_touched = touched.numel()

    adj = graph.adjacency
    if refine and n_touched:
        from repro_torch.core.construction import batch_insert_at
        # pad to the JAX version's power-of-two rung by repeating a real
        # id: the duplicates' reverse-edge proposals take rev_cap slots
        # exactly as they do there, which keeps the result bit-equal
        rung = 1 << max(0, (n_touched - 1).bit_length())
        t_pad = torch.cat([touched, touched[:1].expand(rung - n_touched)])
        graph = batch_insert_at(vectors, graph, t_pad.to(torch.int32),
                                params=params, already_inserted=True,
                                vec_sqnorm=vec_sqnorm,
                                tombstone_bits=state.tombstone_bits)
        adj = graph.adjacency
    elif n_touched:
        # local repair in fixed-shape slabs; chunk bounds the
        # (chunk, R+R*R, D) gathers
        chunk = max(16, min(int(params.prune_chunk), 4096 // max(1, r)))
        for s in range(0, n_touched, repair_slab):
            slab = touched[s:s + repair_slab]
            slab_ids = torch.nn.functional.pad(
                slab, (0, (-slab.numel()) % chunk), value=-1).to(torch.int32)
            new_rows = _repair_rows(vectors, adj, deleted_now, live,
                                    slab_ids, n_valid, degree_bound=r,
                                    alpha=params.alpha, chunk=chunk)
            adj[slab] = new_rows[:slab.numel()]

    # deleted rows lose their out-edges; nothing points at them any more
    adj[deleted_now] = -1
    medoid = compute_medoid(vectors, live)
    graph = VamanaGraph(adjacency=adj, n_valid=n_valid, medoid=medoid)

    old_free = state.free_ids[:state.n_free]
    new_free = torch.sort(torch.cat([old_free, del_ids.to(torch.int32)])
                          ).values
    free_ids = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    free_ids[:new_free.numel()] = new_free
    state = MutationState(
        tombstone_bits=state.tombstone_bits,   # bits stay set until reuse
        labels=state.labels,                   # live rows' labels untouched
        free_ids=free_ids,
        n_free=new_free.numel(),
        n_deleted=0,
        generation=state.generation + 1,
    )
    return graph, state, {"n_freed": int(del_ids.numel()),
                          "n_repaired": int(n_touched)}


# ---------------------------------------------------------------------------
# Slot allocation (insert-side reuse) and capacity growth
# ---------------------------------------------------------------------------

def take_free_slots(state: MutationState, want: int
                    ) -> tuple[MutationState, np.ndarray]:
    """Pop up to `want` reusable slots (ascending ids — deterministic).

    The popped slots' tombstone bits are cleared: they are LIVE again the
    moment the caller writes their rows. Their label rows are cleared in
    place, so a reused slot never inherits its dead predecessor's labels.
    """
    take = min(want, state.n_free)
    if take == 0:
        return state, np.empty((0,), np.int32)
    cap = state.capacity
    dev = state.free_ids.device
    taken = state.free_ids[:take].clone()
    rest = state.free_ids[take:state.n_free]
    free_ids = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    free_ids[:rest.numel()] = rest
    dense = unpack_bitmap(state.tombstone_bits, cap)
    dense[taken.long()] = False
    state.labels[taken.long()] = 0
    state = MutationState(
        tombstone_bits=pack_bitmap(dense),
        labels=state.labels,
        free_ids=free_ids,
        n_free=rest.numel(),
        n_deleted=state.n_deleted,
        generation=state.generation + 1,
    )
    return state, taken.cpu().numpy().astype(np.int32)


def grow_state(state: MutationState, new_capacity: int) -> MutationState:
    """Copy-extend the mutation state to a larger capacity."""
    old_cap = state.capacity
    if new_capacity < old_cap:
        raise ValueError(f"cannot shrink {old_cap} -> {new_capacity}")
    dev = state.free_ids.device
    bits = torch.zeros((bitmap_bytes(new_capacity),), dtype=torch.uint8,
                       device=dev)
    bits[:state.tombstone_bits.shape[0]] = state.tombstone_bits
    free = torch.full((new_capacity,), -1, dtype=torch.int32, device=dev)
    free[:old_cap] = state.free_ids
    return MutationState(tombstone_bits=bits,
                         labels=grow_rows(state.labels, new_capacity, 0),
                         free_ids=free,
                         n_free=state.n_free, n_deleted=state.n_deleted,
                         generation=state.generation + 1)


def grow_rows(arr: torch.Tensor, new_capacity: int, fill) -> torch.Tensor:
    """Copy-extend a capacity-major tensor: rows [cap:new_cap) = fill.

    Packed RaBitQ codes, vec_sqnorm and adjacency are all capacity-major,
    so growth is one allocation + copy per buffer and the resident prefix
    is byte-identical.
    """
    old = arr.shape[0]
    if new_capacity < old:
        raise ValueError(f"cannot shrink {old} -> {new_capacity}")
    out = torch.full((new_capacity, *arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    out[:old] = arr
    return out
