"""Batch-parallel lock-free Vamana construction (paper §3.3/§4.3, Alg. 3).

Port of `repro.core.construction`, the ParlayANN recipe:

  Step 1  beam-search every point of the batch against a read-only
          snapshot of the graph — candidate edges = visited set ∪ frontier.
  Step 2  forward prune: RobustPrune each new point's candidates, write its
          adjacency row.
  Step 3  reverse edges: every forward edge (x -> v) proposes (v -> x).
          One full sort by (dst, dist) groups the proposals (GPU Jasper's
          replacement for ParlayANN's semisort), segment arithmetic builds
          fixed-shape per-vertex candidate buffers, and a batched
          RobustPrune rewrites every touched adjacency row.

Per-vertex incoming candidates are capped at `rev_cap`, keeping the
closest proposals (the sort puts them first). The JAX version prunes all
B*R rows of the reverse-edge table, padding included; here only the
touched rows are pruned (padding rows are dropped by the final scatter in
both versions, so the graph is the same).

The adjacency is updated in place (the JAX version's `.at[].set` returns
a new array): at a million rows the graph is 256 MB, and a copy per batch
buys nothing — the snapshot that step 1 searches is complete before any
row is written.

Step 1 searches at most `_SEARCH_CHUNK` rows at a time. Each row's walk
over the read-only snapshot is independent of the others, so chunking
changes no result; it bounds the (chunk, R, D) candidate gather of the
exact scorer when `consolidate` re-links hundreds of thousands of rows in
one batch. Build batches (<= 100,000 rows) never chunk.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.beam_search import beam_search, make_exact_scorer
from repro_torch.core.medoid import compute_medoid
from repro_torch.core.robust_prune import robust_prune_batch
from repro_torch.core.vamana import VamanaGraph, init_graph

_INF = float("inf")

# rows per snapshot-search chunk in batch_insert_at (above the build's
# max_batch, so bulk construction searches each batch in one piece)
_SEARCH_CHUNK = 131072


@dataclass(frozen=True)
class ConstructionParams:
    """Static construction hyper-parameters (paper defaults: R=64, alpha=1.2)."""

    degree_bound: int = 64        # R
    alpha: float = 1.2
    beam_width: int = 64          # L during construction
    max_iters: int = 96           # expansion budget / visited-log length
    rev_cap: int = 64             # max incoming reverse-edge candidates kept
    prune_chunk: int = 1024       # vertices per prune chunk (memory knob)


def _adjacency_distances(vectors: torch.Tensor, pivot_ids: torch.Tensor,
                         adj_rows: torch.Tensor, chunk_size: int
                         ) -> torch.Tensor:
    """d2(pivot, each existing neighbour). (V,), (V, R) -> (V, R)."""
    out = []
    for s in range(0, pivot_ids.shape[0], chunk_size):
        p_ids = pivot_ids[s:s + chunk_size]
        rows = adj_rows[s:s + chunk_size]
        pv = vectors[torch.clamp(p_ids, min=0).long()].to(torch.float32)
        nv = vectors[torch.clamp(rows, min=0).long()].to(torch.float32)
        d = ((nv - pv[:, None, :]) ** 2).sum(dim=-1)
        out.append(torch.where(rows >= 0, d, torch.full_like(d, _INF)))
    if not out:
        return torch.empty(adj_rows.shape, dtype=torch.float32,
                           device=adj_rows.device)
    return torch.cat(out)


def _group_reverse_edges(dst: torch.Tensor, src: torch.Tensor,
                         dist: torch.Tensor, rev_cap: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sort + segment-scatter edge grouping.

    dst/src/dist: (E,) flat reverse-edge proposals (-1 dst = dead).
    Returns (touched (E,), in_ids (E, rev_cap), in_dists (E, rev_cap)):
    row u of in_* holds the closest <= rev_cap proposals for vertex
    touched[u]; unused rows have touched = -1. The touched vertices fill a
    prefix of `touched`, in ascending order.
    """
    e = dst.shape[0]
    dev = dst.device
    big = 2**30
    key = torch.where(dst >= 0, dst, torch.full_like(dst, big))
    # lexicographic stable sort by (key, dist): stable by the minor key
    # first, then stable by the major key
    _, o1 = torch.sort(dist, stable=True)
    _, o2 = torch.sort(key[o1], stable=True)
    order = o1[o2]
    s_key, s_dist, s_src = key[order], dist[order], src[order]
    valid = s_key < big
    new_seg = torch.cat([valid[:1], (s_key[1:] != s_key[:-1]) & valid[1:]])
    seg_id = torch.cumsum(new_seg.to(torch.int32), dim=0,
                          dtype=torch.int32) - 1                   # (E,)
    pos = torch.arange(e, dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(new_seg, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = pos - seg_start

    # scatters with an extra sink row/slot stand in for JAX's mode="drop"
    touched = torch.full((e + 1,), -1, dtype=torch.int32, device=dev)
    touched[torch.where(new_seg, seg_id,
                        torch.full_like(seg_id, e)).long()] = s_key
    keep = valid & (rank < rev_cap)
    row = torch.where(keep, seg_id, torch.full_like(seg_id, e)).long()
    col = torch.clamp(rank, max=rev_cap - 1).long()
    in_ids = torch.full((e + 1, rev_cap), -1, dtype=torch.int32, device=dev)
    in_ids[row, col] = s_src.to(torch.int32)
    in_dists = torch.full((e + 1, rev_cap), _INF, dtype=torch.float32,
                          device=dev)
    in_dists[row, col] = s_dist
    return touched[:e], in_ids[:e], in_dists[:e]


def batch_insert(vectors: torch.Tensor, graph: VamanaGraph, batch_start: int,
                 *, batch_size: int, params: ConstructionParams,
                 already_inserted: bool = False,
                 vec_sqnorm: torch.Tensor | None = None) -> VamanaGraph:
    """Insert vectors[batch_start : batch_start + batch_size] into the graph
    (contiguous-range wrapper over `batch_insert_at`). With
    already_inserted=True this is a refinement pass over existing
    vertices: n_valid does not advance."""
    new_ids = batch_start + torch.arange(batch_size, dtype=torch.int32,
                                         device=vectors.device)
    return batch_insert_at(vectors, graph, new_ids, params=params,
                           already_inserted=already_inserted,
                           vec_sqnorm=vec_sqnorm)


def batch_insert_at(vectors: torch.Tensor, graph: VamanaGraph,
                    new_ids: torch.Tensor, *, params: ConstructionParams,
                    already_inserted: bool = False,
                    vec_sqnorm: torch.Tensor | None = None,
                    tombstone_bits: torch.Tensor | None = None
                    ) -> VamanaGraph:
    """Insert the (already written) rows `new_ids` into the graph.

    new_ids need not be contiguous. n_valid is the high-water mark — it
    advances only past fresh tail ids. tombstone_bits: tombstoned rows stay
    traversable during candidate search but are excluded from every pruned
    edge list.
    """
    from repro_torch.core.mutations import unpack_bitmap

    r = params.degree_bound
    adj = graph.adjacency
    n_old = graph.n_valid
    batch_size = new_ids.shape[0]
    queries = vectors[new_ids.long()]
    live = None
    if tombstone_bits is not None:
        live = ~unpack_bitmap(tombstone_bits, adj.shape[0])

    # ---- Step 1: snapshot beam search ------------------------------------
    # candidate edges: visited set ∪ final frontier
    cand_ids, cand_dists = [], []
    for s in range(0, batch_size, _SEARCH_CHUNK):
        qs = queries[s:s + _SEARCH_CHUNK]
        score = make_exact_scorer(vectors, qs, n_old, vec_sqnorm)
        res = beam_search(graph, score, qs.shape[0],
                          beam_width=params.beam_width,
                          max_iters=params.max_iters)
        cand_ids.append(torch.cat([res.visited_ids, res.frontier_ids], dim=1))
        cand_dists.append(torch.cat([res.visited_dists, res.frontier_dists],
                                    dim=1))
        del res
    cand_ids = torch.cat(cand_ids)
    cand_dists = torch.cat(cand_dists)

    # ---- Step 2: forward prune -------------------------------------------
    fwd = robust_prune_batch(vectors, new_ids, cand_ids, cand_dists, n_old,
                             degree_bound=r, alpha=params.alpha,
                             chunk_size=params.prune_chunk, live=live)
    del cand_ids, cand_dists
    adj[new_ids.long()] = fwd.selected_ids

    # ---- Step 3: reverse edges (full sort + batched prune) ----------------
    dst = fwd.selected_ids.reshape(-1)                     # (B*R,)
    src = torch.repeat_interleave(new_ids, r)
    dist = fwd.selected_dists.reshape(-1)
    touched, in_ids, in_dists = _group_reverse_edges(dst, src, dist,
                                                     params.rev_cap)
    # touched vertices fill a prefix; the rest is padding that the JAX
    # version prunes and then drops
    n_touched = int((touched >= 0).sum())
    touched = touched[:n_touched]
    in_ids, in_dists = in_ids[:n_touched], in_dists[:n_touched]

    exist_rows = adj[touched.long()]                       # (T, R)
    exist_dists = _adjacency_distances(vectors, touched, exist_rows,
                                       params.prune_chunk)

    n_after = (n_old if already_inserted
               else max(n_old, int(new_ids.max()) + 1))
    cand2_ids = torch.cat([exist_rows, in_ids], dim=1)
    cand2_dists = torch.cat([exist_dists, in_dists], dim=1)
    del in_ids, in_dists, exist_dists
    rev = robust_prune_batch(vectors, touched, cand2_ids, cand2_dists,
                             n_after, degree_bound=r, alpha=params.alpha,
                             chunk_size=params.prune_chunk, live=live)
    adj[touched.long()] = rev.selected_ids
    return VamanaGraph(adjacency=adj, n_valid=n_after, medoid=graph.medoid)


def bootstrap_graph(vectors: torch.Tensor, graph: VamanaGraph, *, n0: int,
                    params: ConstructionParams) -> VamanaGraph:
    """All-pairs bootstrap for the first n0 points (empty-graph base case):
    candidates for each point = its 4R nearest in the bootstrap set, then
    RobustPrune."""
    r = params.degree_bound
    dev = vectors.device
    ids = torch.arange(n0, dtype=torch.int32, device=dev)
    v = vectors[:n0].to(torch.float32)
    sq = (v * v).sum(dim=-1)
    d = torch.clamp(sq[:, None] - 2.0 * (v @ v.T) + sq[None, :], min=0.0)
    c = min(4 * r, n0)
    # nearest c with ties to the lower index (lax.top_k's order)
    sd, si = torch.sort(d, dim=1, stable=True)
    cand_ids = si[:, :c].to(torch.int32)
    cand_dists = sd[:, :c]
    res = robust_prune_batch(vectors, ids, cand_ids, cand_dists, n0,
                             degree_bound=r, alpha=params.alpha,
                             chunk_size=params.prune_chunk)
    adj = graph.adjacency
    adj[:n0] = res.selected_ids
    medoid = compute_medoid(vectors,
                            torch.arange(vectors.shape[0], device=dev) < n0)
    return VamanaGraph(adjacency=adj, n_valid=n0, medoid=medoid)


def build_graph(vectors: torch.Tensor, n_total: int, *,
                params: ConstructionParams, bootstrap_size: int = 1024,
                min_batch: int = 256, max_batch: int = 100_000,
                refine: bool = False, progress_fn=None) -> VamanaGraph:
    """Bulk construction: bootstrap + prefix-doubling batch insertion (the
    paper's Fig. 2 pipeline; batch sizes double as the index grows, the
    same ParlayANN schedule as the JAX version)."""
    capacity = vectors.shape[0]
    if n_total > capacity:
        raise ValueError(f"n_total {n_total} exceeds capacity {capacity}")
    graph = init_graph(capacity, params.degree_bound, vectors.device)
    n0 = min(bootstrap_size, n_total)
    graph = bootstrap_graph(vectors, graph, n0=n0, params=params)
    vf = vectors.to(torch.float32)
    vec_sqnorm = (vf * vf).sum(dim=-1)

    inserted = n0
    while inserted < n_total:
        remaining = n_total - inserted
        b = min(max(min_batch, 1 << (inserted.bit_length() - 1)), max_batch)
        b = min(b, remaining)
        # round down to a power of two; exact remainder batches only happen
        # once at the tail
        if b != remaining:
            b = 1 << (b.bit_length() - 1)
        graph = batch_insert(vectors, graph, inserted, batch_size=b,
                             params=params, vec_sqnorm=vec_sqnorm)
        inserted += b
        if progress_fn is not None:
            progress_fn(inserted, n_total)

    if refine:  # optional Vamana second pass over everything
        done = 0
        while done < n_total:
            b = min(max_batch, n_total - done)
            b = 1 << (b.bit_length() - 1) if b != n_total - done else b
            graph = batch_insert(vectors, graph, done, batch_size=b,
                                 params=params, already_inserted=True,
                                 vec_sqnorm=vec_sqnorm)
            done += b

    # refresh the entry point once construction settles
    medoid = compute_medoid(
        vectors, torch.arange(capacity, device=vectors.device) < graph.n_valid)
    return VamanaGraph(adjacency=graph.adjacency, n_valid=graph.n_valid,
                       medoid=medoid)
