"""Batched greedy beam search (paper Alg. 1 + §4.1/4.2) in PyTorch.

Port of `repro.core.beam_search`: the unfused reference loop. All queries
advance in lockstep; per-query state is a set of small fixed-shape
tensors. Faithful simplifications carried over from the paper (§4.2): no
visited hash table (the frontier's own visited bit is the only dedup
state), a full merge every step, squared distances.

The distance computation is pluggable via `score_fn`, so the exact path,
the RaBitQ estimator path and the CUDA kernel scorers share one loop.
Merges keep the tie order of `lax.top_k` (ties to the lower position,
i.e. frontier before candidates): "topk"/"sort" through a stable sort
(`torch.topk` does not promise that order), "kernel" through the CUDA
`topk` kernel, which selects the same stable order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.mutations import bitmap_gather, label_match_gather
from repro_torch.core.rabitq import RaBitQCodes, RaBitQQuery, rabitq_estimate
from repro_torch.core.vamana import VamanaGraph

ScoreFn = Callable[[torch.Tensor], torch.Tensor]  # (Q, K) ids -> (Q, K) dists

_INF = float("inf")


class SearchTelemetry(NamedTuple):
    """Per-search counters, identical semantics across the unfused loop,
    the ref oracle and the fused kernel (the oracle's values are the
    bit-exact contract).

    Per hop, over the expanded nodes' neighbour candidates:
      scored     — in-range, not already in the frontier, not masked
      masked     — in-range, not duplicate, but tombstone/filter-masked
                   (exclude mode only)
      duplicates — in-range but already present in the frontier
      occupancy  — live frontier slots (id >= 0) after the hop's merge +
                   schedule-narrow, recorded only for hops the row expanded
    """

    scored: torch.Tensor      # (Q,) int32, summed over hops
    masked: torch.Tensor      # (Q,) int32, summed over hops
    duplicates: torch.Tensor  # (Q,) int32, summed over hops
    occupancy: torch.Tensor   # (Q, max_iters) int32, per hop


class BeamSearchResult(NamedTuple):
    frontier_ids: torch.Tensor     # (Q, L) int32, sorted by distance, -1 padded
    frontier_dists: torch.Tensor   # (Q, L) f32, +inf padded
    visited_ids: torch.Tensor      # (Q, max_iters) int32 expansion log
    visited_dists: torch.Tensor    # (Q, max_iters) f32
    n_hops: torch.Tensor           # (Q,) int32 expansions performed
    telemetry: SearchTelemetry | None = None


def make_exact_scorer(vectors: torch.Tensor, queries: torch.Tensor,
                      n_valid, vec_sqnorm: torch.Tensor | None = None,
                      query_sqnorm: torch.Tensor | None = None) -> ScoreFn:
    """Exact squared-L2 scorer over gathered candidate rows (the plain
    reference; kernels/distance is the CUDA drop-in). `query_sqnorm`, the
    (Q,) |q|^2, is computed here when not given."""
    v = vectors
    q = queries.to(torch.float32)
    q_sq = (q * q).sum(dim=-1) if query_sqnorm is None else query_sqnorm
    if vec_sqnorm is None:
        vf = v.to(torch.float32)
        vec_sqnorm = (vf * vf).sum(dim=-1)

    def score(ids: torch.Tensor) -> torch.Tensor:
        safe = torch.clamp(ids, min=0).long()
        cand = v[safe].to(torch.float32)                      # (Q, K, D)
        dot = torch.einsum("qkd,qd->qk", cand, q)
        d = q_sq[:, None] - 2.0 * dot + vec_sqnorm[safe]
        return torch.clamp(d, min=0.0)

    return score


def make_rabitq_scorer(codes: RaBitQCodes, query: RaBitQQuery) -> ScoreFn:
    """RaBitQ estimated-distance scorer (paper §5.1)."""

    def score(ids: torch.Tensor) -> torch.Tensor:
        return rabitq_estimate(codes, query, ids)

    return score


MERGE_STRATEGIES = ("topk", "sort", "kernel")


def _concat(f_ids, f_dists, f_vis, c_ids, c_dists):
    all_d = torch.cat([f_dists, c_dists], dim=1)
    all_i = torch.cat([f_ids, c_ids], dim=1)
    all_v = torch.cat([f_vis, torch.zeros_like(c_ids, dtype=torch.bool)],
                      dim=1)
    return all_i, all_d, all_v


def merge_frontier_sort(f_ids, f_dists, f_vis, c_ids, c_dists, beam_width):
    """Reference merge: one stable sort over the L + E*R concatenation."""
    all_i, all_d, all_v = _concat(f_ids, f_dists, f_vis, c_ids, c_dists)
    sd, order = torch.sort(all_d, dim=1, stable=True)
    order = order[:, :beam_width]
    return (torch.gather(all_i, 1, order), sd[:, :beam_width],
            torch.gather(all_v, 1, order))


def merge_frontier_topk(f_ids, f_dists, f_vis, c_ids, c_dists, beam_width):
    """Partial top-L merge. Selects the L smallest with ties to the lower
    position (frontier first) — the semantics of `lax.top_k(-d, L)` in the
    JAX reference — through a stable sort."""
    return merge_frontier_sort(f_ids, f_dists, f_vis, c_ids, c_dists,
                               beam_width)


def merge_frontier_kernel(f_ids, f_dists, f_vis, c_ids, c_dists, beam_width):
    """Partial top-L merge through the CUDA `topk` kernel (its plain
    version on CPU tensors). Positions go in as the ids; the kernel
    returns the L smallest with their positions (ties to the lower
    position, every position once), and ids + visited bits ride along
    through the positions. Same result as `merge_frontier_topk`."""
    from repro_torch.kernels.topk.ops import topk

    all_i, all_d, all_v = _concat(f_ids, f_dists, f_vis, c_ids, c_dists)
    pos_in = torch.arange(all_d.shape[1], dtype=torch.int32,
                          device=all_d.device).expand(all_d.shape)
    sd, pos = topk(all_d.contiguous(), pos_in.contiguous(), beam_width)
    pos = pos.long()
    return (torch.gather(all_i, 1, pos), sd, torch.gather(all_v, 1, pos))


MERGE_FNS = {
    "sort": merge_frontier_sort,
    "topk": merge_frontier_topk,
    "kernel": merge_frontier_kernel,
}


def expand_schedule(beam_schedule, beam_width: int, max_iters: int
                    ) -> tuple[int, ...]:
    """Static per-hop frontier widths, one entry per iteration. Hop t runs
    at width schedule[min(t, len-1)]; None means constant beam_width."""
    if beam_schedule is None:
        return (beam_width,) * max_iters
    sched = tuple(int(w) for w in beam_schedule)
    return tuple(sched[min(t, len(sched) - 1)] for t in range(max_iters))


def apply_beam_width(f_ids, f_dists, f_vis, w):
    """Narrow a merged frontier to `w` live slots (positions >= w become
    empty: id -1, dist +inf, unvisited)."""
    keep = torch.arange(f_ids.shape[1], device=f_ids.device)[None, :] < w
    return (torch.where(keep, f_ids, torch.full_like(f_ids, -1)),
            torch.where(keep, f_dists, torch.full_like(f_dists, _INF)),
            torch.where(keep, f_vis, torch.zeros_like(f_vis)))


def finalize_frontier(f_ids, f_dists, tombstone_bits, labels=None,
                      filter_bytes=None):
    """Shared search epilogue: drop tombstoned and out-of-filter entries to
    the (+inf, -1) tail and mask unconverged +inf padding back to -1 ids.
    Every search path finishes through this one function."""
    drop = None
    if tombstone_bits is not None:
        drop = bitmap_gather(tombstone_bits, f_ids)
    if labels is not None:
        miss = ~label_match_gather(labels, filter_bytes, f_ids) & (f_ids >= 0)
        drop = miss if drop is None else (drop | miss)
    if drop is not None:
        f_dists = torch.where(drop, torch.full_like(f_dists, _INF), f_dists)
        f_dists, order = torch.sort(f_dists, dim=1, stable=True)
        f_ids = torch.gather(f_ids, 1, order)
    f_ids = torch.where(torch.isfinite(f_dists), f_ids,
                        torch.full_like(f_ids, -1))
    return f_ids, f_dists


def beam_search(graph: VamanaGraph, score_fn: ScoreFn,
                num_queries: int | None = None, *, beam_width: int,
                max_iters: int, expand_per_iter: int = 1,
                merge_strategy: str = "topk",
                tombstone_bits: torch.Tensor | None = None,
                traverse_deleted: bool = True,
                labels: torch.Tensor | None = None,
                filter_bytes: torch.Tensor | None = None,
                filter_exclude: bool = False,
                beam_schedule: tuple | None = None,
                telemetry: bool = False) -> BeamSearchResult:
    """Run greedy beam search for a batch of queries.

    Same arguments and semantics as `repro.core.beam_search.beam_search`:
    `score_fn` maps (Q, K) ids -> (Q, K) dists (scorers flagged
    `self_masking` write +inf for invalid ids themselves); E =
    `expand_per_iter` closest unvisited nodes are expanded per iteration;
    tombstoned / out-of-filter ids never reach the returned frontier, and
    `traverse_deleted=False` / `filter_exclude=True` additionally mask
    them during the walk. The loop stops when no row has an unvisited
    slot (one host sync per iteration) or after `max_iters`; converged
    rows are frozen, so each row's result is independent of the batch.
    """
    if merge_strategy not in MERGE_STRATEGIES:
        raise ValueError(
            f"merge_strategy must be one of {MERGE_STRATEGIES}, "
            f"got {merge_strategy!r}")
    merge = MERGE_FNS[merge_strategy]
    self_masking = getattr(score_fn, "self_masking", False)
    exclude_in_body = (tombstone_bits is not None and not traverse_deleted
                       and not self_masking)
    filter_in_body = labels is not None and filter_exclude and not self_masking
    adj = graph.adjacency
    dev = adj.device
    n_valid = graph.n_valid
    e_exp = expand_per_iter
    sched = (None if beam_schedule is None else
             expand_schedule(beam_schedule, beam_width, max_iters))
    if num_queries is None:
        raise ValueError("num_queries is required")
    q = num_queries
    arange_l = torch.arange(beam_width, device=dev)

    f_ids = torch.full((q, beam_width), -1, dtype=torch.int32, device=dev)
    f_ids[:, 0] = graph.medoid
    d0 = score_fn(f_ids[:, :1])                                 # (Q, 1)
    f_dists = torch.full((q, beam_width), _INF, dtype=torch.float32,
                         device=dev)
    f_dists[:, :1] = d0
    f_vis = torch.zeros((q, beam_width), dtype=torch.bool, device=dev)
    # the loop state below is updated in place (JAX's `.at[].set` on the
    # loop carry): the logs are the only per-iteration writes
    vlog = torch.full((q, max_iters), -1, dtype=torch.int32, device=dev)
    vdlog = torch.full((q, max_iters), _INF, dtype=torch.float32, device=dev)
    hops = torch.zeros((q,), dtype=torch.int32, device=dev)

    count_masked = (telemetry and tombstone_bits is not None
                    and not traverse_deleted)
    count_fmasked = telemetry and labels is not None and filter_exclude
    if telemetry:
        scored = torch.zeros((q,), dtype=torch.int32, device=dev)
        masked = torch.zeros((q,), dtype=torch.int32, device=dev)
        dups = torch.zeros((q,), dtype=torch.int32, device=dev)
        occ_log = torch.zeros((q, max_iters), dtype=torch.int32, device=dev)

    for it in range(max_iters):
        unvis = (f_ids >= 0) & ~f_vis                           # (Q, L)
        if not bool(unvis.any()):
            break
        order = torch.where(unvis, arange_l[None, :],
                            torch.full_like(arange_l, beam_width)[None, :])
        picks = torch.sort(order, dim=1).values[:, :e_exp]      # (Q, E)
        pick_valid = picks < beam_width
        safe_picks = torch.clamp(picks, max=beam_width - 1)
        cur = torch.gather(f_ids, 1, safe_picks)
        cur = torch.where(pick_valid, cur, torch.full_like(cur, -1))
        cur_d = torch.gather(f_dists, 1, safe_picks)
        active = pick_valid[:, 0]

        hit = (arange_l[None, None, :] == picks[:, :, None]).any(dim=1)
        f_vis = f_vis | (hit & unvis)

        vlog[:, it] = cur[:, 0]
        vdlog[:, it] = torch.where(active, cur_d[:, 0],
                                   torch.full_like(cur_d[:, 0], _INF))
        hops += pick_valid.sum(dim=1).to(torch.int32)

        nbrs = adj[torch.clamp(cur, min=0).long()]              # (Q, E, R)
        nbrs = torch.where((cur >= 0)[:, :, None], nbrs,
                           torch.full_like(nbrs, -1))
        nbrs = nbrs.reshape(q, -1)                              # (Q, E*R)
        if e_exp > 1:
            # different expanded nodes may share neighbours: dedup within
            # the candidate row (order is irrelevant — the merge re-sorts)
            big = 2**30
            key = torch.sort(torch.where(nbrs >= 0, nbrs,
                                         torch.full_like(nbrs, big)),
                             dim=1).values
            dup_in_row = torch.cat(
                [torch.zeros_like(key[:, :1], dtype=torch.bool),
                 key[:, 1:] == key[:, :-1]], dim=1)
            nbrs = torch.where(dup_in_row | (key >= big),
                               torch.full_like(key, -1), key)
        in_range = (nbrs >= 0) & (nbrs < n_valid)
        dup = (nbrs[:, :, None] == f_ids[:, None, :]).any(dim=2)
        valid = in_range & ~dup
        if count_masked or exclude_in_body:
            dead = bitmap_gather(tombstone_bits, nbrs) & valid
        if exclude_in_body:
            valid &= ~dead
        if count_fmasked or filter_in_body:
            # tombstone test FIRST: a dead candidate counts once in
            # `masked`, whatever the filter says about it
            fmiss = ~label_match_gather(labels, filter_bytes, nbrs) & valid
            if count_masked and not exclude_in_body:
                fmiss &= ~dead
        if filter_in_body:
            valid &= ~fmiss
        nbrs = torch.where(valid, nbrs, torch.full_like(nbrs, -1))
        if telemetry:
            dead_n = dead.sum(dim=1).to(torch.int32) if count_masked else 0
            fmiss_n = fmiss.sum(dim=1).to(torch.int32) if count_fmasked else 0
            scored = scored + (valid.sum(dim=1).to(torch.int32)
                               - (0 if exclude_in_body else dead_n)
                               - (0 if filter_in_body else fmiss_n))
            masked = masked + dead_n + fmiss_n
            dups = dups + (in_range & dup).sum(dim=1).to(torch.int32)

        d = score_fn(nbrs)                                      # (Q, E*R)
        if not self_masking:
            d = torch.where(valid, d, torch.full_like(d, _INF))

        f_ids, f_dists, f_vis = merge(f_ids, f_dists, f_vis, nbrs, d,
                                      beam_width=beam_width)
        if sched is not None:
            # narrow only rows that expanded work this hop: a converged
            # row's frontier is frozen
            ni, nd, nv = apply_beam_width(f_ids, f_dists, f_vis, sched[it])
            act = pick_valid.any(dim=1)[:, None]
            f_ids = torch.where(act, ni, f_ids)
            f_dists = torch.where(act, nd, f_dists)
            f_vis = torch.where(act, nv, f_vis)
        if telemetry:
            occ = (f_ids >= 0).sum(dim=1).to(torch.int32)
            occ_log[:, it] = torch.where(active, occ, torch.zeros_like(occ))

    tel = (SearchTelemetry(scored, masked, dups, occ_log) if telemetry
           else None)
    f_ids, f_dists = finalize_frontier(f_ids, f_dists, tombstone_bits,
                                       labels=labels,
                                       filter_bytes=filter_bytes)
    return BeamSearchResult(frontier_ids=f_ids, frontier_dists=f_dists,
                            visited_ids=vlog, visited_dists=vdlog,
                            n_hops=hops, telemetry=tel)


def rerank_frontier(vectors: torch.Tensor, vec_sqnorm: torch.Tensor,
                    queries: torch.Tensor, ids: torch.Tensor, *,
                    tile_q: int = 512,
                    use_kernels: bool = False) -> torch.Tensor:
    """Exact distances for a (Q, L) frontier; invalid ids (< 0) -> +inf.

    use_kernels: one launch of the CUDA `gather_l2` kernel over the whole
    frontier — it reads the candidate rows itself, so no (Q, L, D) buffer
    exists and there is nothing to tile. Otherwise the plain gather+einsum
    reference, `tile_q` queries at a time to bound its (tile_q, L, D)
    gather buffer.
    """
    if use_kernels:
        from repro_torch.kernels.distance.ops import gather_l2
        return gather_l2(queries.to(torch.float32).contiguous(), vectors,
                         vec_sqnorm, ids.to(torch.int32).contiguous())
    q_n = ids.shape[0]
    tile_q = max(1, min(tile_q, q_n))
    q = queries.to(torch.float32)
    out = []
    for s in range(0, q_n, tile_q):
        qt, it = q[s:s + tile_q], ids[s:s + tile_q]
        score = make_exact_scorer(vectors, qt, None, vec_sqnorm)
        out.append(torch.where(it >= 0, score(it),
                               torch.full(it.shape, _INF, device=it.device)))
    if not out:
        return torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    return torch.cat(out)


def sort_frontier(exact_d: torch.Tensor, ids: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rerank's epilogue: a stable sort of the frontier by its exact
    distances, ids with no finite distance -> -1, the first k of each."""
    sd, order = torch.sort(exact_d, dim=1, stable=True)
    si = torch.gather(ids, 1, order)
    si = torch.where(torch.isfinite(sd), si, torch.full_like(si, -1))
    return si[:, :k], sd[:, :k]


def beam_search_quantized(graph: VamanaGraph, codes: RaBitQCodes,
                          query: RaBitQQuery, *, beam_width: int,
                          max_iters: int,
                          rerank_score_fn: ScoreFn | None = None,
                          expand_per_iter: int = 1,
                          use_kernels: bool = False,
                          merge_strategy: str = "topk",
                          tombstone_bits: torch.Tensor | None = None,
                          traverse_deleted: bool = True,
                          labels: torch.Tensor | None = None,
                          filter_bytes: torch.Tensor | None = None,
                          filter_exclude: bool = False,
                          beam_schedule: tuple | None = None,
                          telemetry: bool = False) -> BeamSearchResult:
    """Beam search on RaBitQ estimated distances (Jasper RaBitQ).

    use_kernels routes scoring through the CUDA `rabitq_search_step`
    kernel (packed-row gather + unpack + estimator + masking epilogue);
    otherwise the plain estimator is used. Optionally reranks the final
    frontier with exact distances.
    """
    if use_kernels:
        from repro_torch.kernels.rabitq_dot.ops import (
            make_rabitq_kernel_scorer)
        score = make_rabitq_kernel_scorer(
            codes, query, n_valid=graph.n_valid,
            tombstone_bits=(None if traverse_deleted else tombstone_bits),
            labels=(labels if filter_exclude else None),
            filter_bytes=(filter_bytes if filter_exclude else None))
    else:
        score = make_rabitq_scorer(codes, query)
    res = beam_search(graph, score, query.q_rot.shape[0],
                      beam_width=beam_width, max_iters=max_iters,
                      expand_per_iter=expand_per_iter,
                      merge_strategy=merge_strategy,
                      tombstone_bits=tombstone_bits,
                      traverse_deleted=traverse_deleted,
                      labels=labels, filter_bytes=filter_bytes,
                      filter_exclude=filter_exclude,
                      beam_schedule=beam_schedule, telemetry=telemetry)
    if rerank_score_fn is None:
        return res
    exact_d = rerank_score_fn(res.frontier_ids)
    exact_d = torch.where(res.frontier_ids >= 0, exact_d,
                          torch.full_like(exact_d, _INF))
    sd, order = torch.sort(exact_d, dim=1, stable=True)
    si = torch.gather(res.frontier_ids, 1, order)
    return res._replace(frontier_ids=si, frontier_dists=sd)
