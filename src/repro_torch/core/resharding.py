"""Elastic resharding: resplit and merge of per-shard IndexCore payloads.

Port of `repro.core.resharding` (the same names and semantics). A
`ShardedJasperIndex` checkpoint is S single-device-format shard payloads
plus a manifest (core/distributed.py). Every shard is a plain
`IndexCore`, so changing the shard count is array surgery — no
re-encoding, no retraining:

  1. concatenate the shards' buffers (capacity-major, so each old shard
     is one contiguous row block);
  2. take the canonical LIVE-row sequence (old shards in order, live
     local ids ascending) and deal it into S' contiguous, capacity-
     balanced groups — resharding is also a consolidation point:
     tombstoned rows and free-pool holes are compacted away;
  3. remap stride-encoded global ids (`old_shard * old_stride + local`
     -> `new_shard * new_stride + local'`) into an old-id -> new-id
     `IdTranslation`, so outstanding tickets survive the move (dead old
     ids translate to -1);
  4. rewrite adjacency neighbour ids through the same remap. Edges whose
     endpoint lands on a DIFFERENT new shard (splits) or was tombstoned
     (compaction) drop to -1;
  5. repair: per new core, bridge the fresh medoid to every merged
     sub-graph's entry point, then re-link every row that lost an edge
     via `batch_insert_at(already_inserted=True)`. `relink="none"` skips
     step 5 (the pure mechanical remap); `relink="all"` re-links every
     row.

Rows, vec_sqnorm, label rows and packed RaBitQ code bytes of live rows
move bit for bit; `rq_params` is dataset-level state and rides along.
The row data stays on the cores' device; the id bookkeeping is host
numpy.

`rebalance_plan` is the online half: given per-shard live locals it
decides which rows move off overfull shards, for
`ShardedJasperIndex.rebalance()` to execute with `core_insert_at` +
`core_delete`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.construction import ConstructionParams, batch_insert_at
from repro_torch.core.index_core import IndexCore, core_live_locals
from repro_torch.core.medoid import compute_medoid
from repro_torch.core.mutations import init_mutation_state
from repro_torch.core.rabitq import RaBitQCodes


# ---------------------------------------------------------------------------
# Id translation (outstanding-ticket contract)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IdTranslation:
    """Old-global-id -> new-global-id table.

    old_ids / new_ids: aligned int64 arrays, sorted by old_ids. `default`
    decides what happens to ids NOT in the table: "drop" maps them to -1
    (resharding: an absent id was dead), "identity" leaves them unchanged
    (rebalancing: unmoved rows keep their ids).
    """

    old_ids: np.ndarray
    new_ids: np.ndarray
    default: str = "drop"

    @classmethod
    def build(cls, old_ids, new_ids, default: str = "drop") -> "IdTranslation":
        old_ids = np.asarray(old_ids, np.int64).ravel()
        new_ids = np.asarray(new_ids, np.int64).ravel()
        if old_ids.shape != new_ids.shape:
            raise ValueError("old_ids / new_ids must align")
        order = np.argsort(old_ids, kind="stable")
        return cls(old_ids=old_ids[order], new_ids=new_ids[order],
                   default=default)

    def __len__(self) -> int:
        return int(self.old_ids.size)

    def apply(self, ids) -> np.ndarray:
        """Translate a batch of old global ids (any shape)."""
        ids = np.asarray(ids, np.int64)
        if self.old_ids.size == 0:
            miss = np.full(ids.shape, -1, np.int64)
            return ids.copy() if self.default == "identity" else miss
        pos = np.clip(np.searchsorted(self.old_ids, ids), 0,
                      self.old_ids.size - 1)
        hit = self.old_ids[pos] == ids
        fallback = ids if self.default == "identity" else -1
        return np.where(hit, self.new_ids[pos], fallback)

    def then(self, other: "IdTranslation") -> "IdTranslation":
        """Compose: apply self, then `other` (for chained reshards)."""
        return IdTranslation.build(self.old_ids, other.apply(self.new_ids),
                                   default=self.default)

    def inverse(self) -> "IdTranslation":
        return IdTranslation.build(self.new_ids, self.old_ids,
                                   default=self.default)


# ---------------------------------------------------------------------------
# Resharding
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReshardResult:
    """S' compacted per-shard cores + the id contract that binds them."""

    cores: list[IndexCore]
    translation: IdTranslation
    capacity_per_shard: int
    id_stride: int


_RELINK_CHUNK = 256     # rows re-linked per sequential repair batch


def pow2_rung(n: int) -> int:
    """Smallest power of two >= n (>= 1): variable batch sizes pad up to
    one rung."""
    return 1 << max(0, int(n - 1).bit_length())


def _round_up8(n: int) -> int:
    return max(8, (n + 7) & ~7)


def balanced_group_sizes(total: int, n_groups: int) -> list[int]:
    """Contiguous capacity-balanced split: sizes differ by at most one."""
    base, rem = divmod(total, n_groups)
    return [base + (1 if g < rem else 0) for g in range(n_groups)]


def _pow2_pad(ids: np.ndarray) -> np.ndarray:
    """Pad to a power-of-two rung by repeating the first id (a duplicate
    re-link is idempotent; -1 would corrupt the adjacency scatter)."""
    rung = pow2_rung(ids.size)
    return np.concatenate([ids, np.full((rung - ids.size,), ids[0],
                                        ids.dtype)])


def _insert_edges(adj: torch.Tensor, row: int, targets: list[int]) -> None:
    """Add edges row->targets in place: free (-1) slots first, then
    overwrite from the tail (RobustPrune emits edge lists in ascending
    distance order, so the lowest-priority neighbours live there)."""
    cur = adj[row].tolist()
    have = set(e for e in cur if e >= 0)
    want = [t for t in targets if t != row and t not in have]
    if not want:
        return
    slots = [i for i, e in enumerate(cur) if e < 0]
    tail = [i for i in range(len(cur) - 1, -1, -1) if i not in slots]
    for t, slot in zip(want, slots + tail):
        cur[slot] = t
    adj[row] = torch.as_tensor(cur, dtype=adj.dtype, device=adj.device)


def reshard_cores(cores: list[IndexCore], *, old_id_stride: int,
                  n_shards: int, new_id_stride: int | None = None,
                  capacity_per_shard: int | None = None,
                  params: ConstructionParams | None = None,
                  relink: str = "auto") -> ReshardResult:
    """Re-partition S per-shard cores into S' capacity-balanced cores, on
    the cores' device.

    relink: "auto" re-links rows that lost edges (cut by a split or
    pointing into compacted tombstones) and bridges merged sub-graphs;
    "all" re-links every live row; "none" is the pure mechanical remap.
    params is required unless relink="none".
    """
    from repro_torch.obs.tracing import span as obs_span
    with obs_span("reshard.cores", s_old=len(cores), s_new=n_shards,
                  relink=relink):
        return _reshard_cores_impl(
            cores, old_id_stride=old_id_stride, n_shards=n_shards,
            new_id_stride=new_id_stride,
            capacity_per_shard=capacity_per_shard, params=params,
            relink=relink)


def _reshard_cores_impl(cores: list[IndexCore], *, old_id_stride: int,
                        n_shards: int, new_id_stride: int | None = None,
                        capacity_per_shard: int | None = None,
                        params: ConstructionParams | None = None,
                        relink: str = "auto") -> ReshardResult:
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if relink not in ("auto", "all", "none"):
        raise ValueError(f"relink must be auto|all|none, got {relink!r}")
    if relink != "none" and params is None:
        raise ValueError("params is required unless relink='none'")
    dev = cores[0].device
    caps_old = [c.capacity for c in cores]
    store_dims = cores[0].store_dims
    degree = cores[0].degree_bound
    base = np.concatenate([[0], np.cumsum(caps_old)]).astype(np.int64)

    # 1. concatenate the payloads (one row block per old shard)
    def cat(get):
        return torch.cat([get(c) for c in cores])

    all_vecs = cat(lambda c: c.vectors)
    all_sq = cat(lambda c: c.vec_sqnorm)
    all_adj = cat(lambda c: c.adjacency)
    all_labels = cat(lambda c: c.mut.labels)
    quantized = cores[0].codes is not None
    if quantized:
        all_packed = cat(lambda c: c.codes.packed)
        all_add = cat(lambda c: c.codes.data_add)
        all_rescale = cat(lambda c: c.codes.data_rescale)

    # 2. canonical live sequence -> contiguous balanced groups
    live_flat, old_gids, src_shard = [], [], []
    for s, c in enumerate(cores):
        locs = core_live_locals(c)
        live_flat.append(base[s] + locs)
        old_gids.append(s * np.int64(old_id_stride) + locs)
        src_shard.append(np.full(locs.size, s, np.int64))
    live_flat = np.concatenate(live_flat)
    old_gids = np.concatenate(old_gids)
    src_shard = np.concatenate(src_shard)
    total_live = int(live_flat.size)
    sizes = balanced_group_sizes(total_live, n_shards)
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    cap_new = capacity_per_shard or max(
        _round_up8(-(-int(sum(caps_old)) // n_shards)),
        _round_up8(max(sizes)))
    if cap_new % 8 or cap_new < max(sizes):
        raise ValueError(
            f"capacity_per_shard {cap_new} must be a multiple of 8 and hold "
            f"the largest group ({max(sizes)} rows)")
    stride_new = new_id_stride or 4 * cap_new
    if stride_new < cap_new:
        raise ValueError(f"id_stride {stride_new} < capacity {cap_new}")

    # 3. the remap: old flat row position -> new flat position (g*cap+local)
    new_flat = np.full(int(base[-1]), -1, np.int64)
    dest_local = np.empty(total_live, np.int64)
    dest_group = np.empty(total_live, np.int64)
    for g in range(n_shards):
        lo, hi = int(starts[g]), int(starts[g + 1])
        dest_group[lo:hi] = g
        dest_local[lo:hi] = np.arange(hi - lo)
        new_flat[live_flat[lo:hi]] = g * cap_new + np.arange(hi - lo)
    translation = IdTranslation.build(
        old_gids, dest_group * np.int64(stride_new) + dest_local)
    new_flat_t = torch.as_tensor(new_flat, device=dev)
    base_t = torch.as_tensor(base, device=dev)

    # 4./5. assemble each new core, rewrite adjacency, bridge + re-link
    gen_next = int(sum(int(c.mut.generation) for c in cores)) + 1
    new_cores: list[IndexCore] = []
    for g in range(n_shards):
        lo, hi = int(starts[g]), int(starts[g + 1])
        size = hi - lo
        src = torch.as_tensor(live_flat[lo:hi], device=dev)

        def placed(rows, fill, dtype):
            out = torch.full((cap_new,) + tuple(rows.shape[1:]), fill,
                             dtype=dtype, device=dev)
            out[:size] = rows[src]
            return out

        vecs = placed(all_vecs, 0.0, torch.float32)
        sq = placed(all_sq, 0.0, torch.float32)
        labels = placed(all_labels, 0, torch.uint8)   # label rows move as is

        old_edges = all_adj[src].to(torch.int64)                 # (size, R)
        src_base = base_t[torch.as_tensor(src_shard[lo:hi], device=dev)]
        flat_edges = torch.where(old_edges >= 0,
                                 src_base[:, None] + old_edges,
                                 torch.full_like(old_edges, -1))
        mapped = torch.where(flat_edges >= 0,
                             new_flat_t[flat_edges.clamp(min=0)],
                             torch.full_like(flat_edges, -1))
        keep = (mapped >= 0) & (torch.div(mapped, cap_new,
                                          rounding_mode="floor") == g)
        adj = torch.full((cap_new, degree), -1, dtype=torch.int32,
                         device=dev)
        adj[:size] = torch.where(keep, mapped % cap_new,
                                 torch.full_like(mapped, -1)).to(torch.int32)
        dropped = ((old_edges >= 0).sum(1)
                   - (adj[:size] >= 0).sum(1)).cpu().numpy()

        codes = rq = None
        if quantized:
            c0 = cores[0].codes
            codes = RaBitQCodes(
                packed=placed(all_packed, 0, torch.uint8),
                data_add=placed(all_add, 0.0, torch.float32),
                data_rescale=placed(all_rescale, 0.0, torch.float32),
                bits=c0.bits, dims=c0.dims)
            rq = cores[0].rq_params
        medoid = 0
        if size:
            medoid = compute_medoid(
                vecs, torch.arange(cap_new, device=dev) < size)
            if relink != "none":
                # bridge the medoid to every merged sub-graph's entry
                # point (relink="none" invents no edges)
                entries = _segment_entries(src_shard[lo:hi], cores,
                                           new_flat, base, cap_new, g)
                _insert_edges(adj, medoid, entries)
                for e in entries:
                    _insert_edges(adj, e, [medoid])

        core = IndexCore(
            vectors=vecs, vec_sqnorm=sq, adjacency=adj, n_valid=size,
            medoid=medoid,
            mut=replace(init_mutation_state(cap_new, dev), labels=labels,
                        generation=gen_next),
            codes=codes, rq_params=rq)

        if relink != "none" and size:
            touched = (np.arange(size, dtype=np.int64) if relink == "all"
                       else np.where(dropped > 0)[0])
            # sequential chunks: each chunk searches a graph the earlier
            # chunks already repaired (the snapshot right after a split
            # is half-broken)
            graph = core.graph
            for i in range(0, touched.size, _RELINK_CHUNK):
                chunk = touched[i:i + _RELINK_CHUNK]
                graph = batch_insert_at(
                    core.vectors, graph,
                    torch.as_tensor(_pow2_pad(chunk), dtype=torch.int32,
                                    device=dev),
                    params=params, already_inserted=True,
                    vec_sqnorm=core.vec_sqnorm,
                    tombstone_bits=core.mut.tombstone_bits)
            core = replace(core, adjacency=graph.adjacency,
                           n_valid=graph.n_valid, medoid=graph.medoid)
        new_cores.append(core)

    return ReshardResult(cores=new_cores, translation=translation,
                         capacity_per_shard=cap_new, id_stride=stride_new)


def _segment_entries(src_shards: np.ndarray, cores: list[IndexCore],
                     new_flat: np.ndarray, base: np.ndarray, cap_new: int,
                     g: int) -> list[int]:
    """Entry points (new local ids) of each contiguous old-shard segment
    inside group g: the old shard's medoid when it landed live in this
    group, else the segment's first row."""
    entries: list[int] = []
    if src_shards.size == 0:
        return entries
    seg_starts = np.concatenate(
        [[0], np.where(np.diff(src_shards) != 0)[0] + 1])
    for st in seg_starts:
        s = int(src_shards[st])
        entry = int(st)                       # first row of the segment
        m = int(cores[s].medoid)
        m_new = int(new_flat[int(base[s]) + m]) if m < cores[s].capacity else -1
        if m_new >= 0 and m_new // cap_new == g:
            entry = int(m_new % cap_new)
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# Online rebalancing plan (executed by ShardedJasperIndex.rebalance)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RebalancePlan:
    """Which live rows move where. moves[r] = (src_shard, src_local) pairs
    destined for receiver shard r (absent shards receive nothing)."""

    moves: dict[int, list[tuple[int, int]]]
    counts_before: np.ndarray
    counts_after: np.ndarray

    @property
    def n_moved(self) -> int:
        return sum(len(v) for v in self.moves.values())


def rebalance_plan(live_locals: list[np.ndarray],
                   tolerance: float = 0.05) -> RebalancePlan:
    """Decide the round-robin row moves that level per-shard live counts.

    live_locals[s]: ascending live local ids of shard s. Shards above
    their balanced quota donate their HIGHEST local ids; receivers are
    filled round-robin in shard order. No-op when the max-min spread is
    already within `tolerance` of the mean.
    """
    counts = np.asarray([len(v) for v in live_locals], np.int64)
    s = counts.size
    total = int(counts.sum())
    mean = total / s if s else 0.0
    before = counts.copy()
    if s < 2 or (counts.max() - counts.min()) <= max(1.0, tolerance * mean):
        return RebalancePlan(moves={}, counts_before=before,
                             counts_after=before.copy())
    # balanced quota; the +1 remainders go to the fullest shards so the
    # plan moves as few rows as possible (deterministic: count desc, id asc)
    base, rem = divmod(total, s)
    desired = np.full(s, base, np.int64)
    order = sorted(range(s), key=lambda i: (-counts[i], i))
    for i in order[:rem]:
        desired[i] += 1
    donors: list[tuple[int, int]] = []       # (shard, local), tail-first
    for i in range(s):
        give = int(counts[i] - desired[i])
        if give > 0:
            for loc in live_locals[i][-give:][::-1]:
                donors.append((i, int(loc)))
    receivers = [i for i in range(s) if counts[i] < desired[i]]
    deficits = {i: int(desired[i] - counts[i]) for i in receivers}
    moves: dict[int, list[tuple[int, int]]] = {i: [] for i in receivers}
    r = 0
    for mv in donors:                        # round-robin off the donors
        while deficits[receivers[r % len(receivers)]] == 0:
            r += 1
        dst = receivers[r % len(receivers)]
        moves[dst].append(mv)
        deficits[dst] -= 1
        r += 1
    return RebalancePlan(moves={k: v for k, v in moves.items() if v},
                         counts_before=before, counts_after=desired)
