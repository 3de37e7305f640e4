"""Reference oracle for the fused search kernel (plain PyTorch).

Port of `repro/kernels/search_step/ref.py`: the per-hop dataflow the
megakernel implements — pick first unvisited, gather adjacency,
validity/liveness epilogue, score, partial top-L merge, per-hop beam
narrowing — with the same ops as the unfused `core.beam_search` loop at
`merge="topk"`, `expand=1`. The megakernel's plain version
(`ops.fused_search_plain`) runs `search_loop` below, and the CUDA kernel
answers to that bit for bit on integer-valued inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core.beam_search import (
    apply_beam_width,
    expand_schedule,
    finalize_frontier,
    merge_frontier_topk,
)
from repro_torch.core.mutations import bitmap_gather, label_match_gather

_INF = float("inf")


def init_frontier(medoid: int, d0: torch.Tensor, num_queries: int,
                  beam_width: int):
    """The entry-point frontier every search path starts from: medoid in
    slot 0 (scored), the rest empty. d0: (Q, 1) medoid distances."""
    dev = d0.device
    f_ids = torch.full((num_queries, beam_width), -1, dtype=torch.int32,
                       device=dev)
    f_ids[:, 0] = medoid
    f_dists = torch.full((num_queries, beam_width), _INF,
                         dtype=torch.float32, device=dev)
    f_dists[:, :1] = d0
    f_vis = torch.zeros((num_queries, beam_width), dtype=torch.bool,
                        device=dev)
    return f_ids, f_dists, f_vis


def fused_hop_ref(f_ids, f_dists, f_vis, *, score_fn, adjacency, n_valid,
                  width, tombstone_bits=None, labels=None,
                  filter_bytes=None, telemetry: bool = False):
    """ONE hop of the fused dataflow. Returns (f_ids, f_dists, f_vis,
    pick_valid) — with `telemetry` a fifth element (scored, masked, dups,
    occ) of this hop's (Q,) int32 counters."""
    l_width = f_ids.shape[1]
    dev = f_ids.device
    arange_l = torch.arange(l_width, device=dev)
    unvis = (f_ids >= 0) & ~f_vis
    order = torch.where(unvis, arange_l[None, :],
                        torch.full_like(arange_l, l_width)[None, :])
    pick = order.min(dim=1).values                       # (Q,)
    pick_valid = pick < l_width
    safe_pos = torch.clamp(pick, max=l_width - 1)
    cur = torch.gather(f_ids, 1, safe_pos[:, None])[:, 0]
    cur = torch.where(pick_valid, cur, torch.full_like(cur, -1))

    hit = arange_l[None, :] == safe_pos[:, None]
    f_vis = f_vis | (hit & unvis & pick_valid[:, None])

    nbrs = adjacency[torch.clamp(cur, min=0).long()]     # (Q, R)
    nbrs = torch.where((cur >= 0)[:, None], nbrs, torch.full_like(nbrs, -1))
    in_range = (nbrs >= 0) & (nbrs < n_valid)
    dup = (nbrs[:, :, None] == f_ids[:, None, :]).any(dim=2)
    valid = in_range & ~dup
    dead = None
    if tombstone_bits is not None:
        dead = bitmap_gather(tombstone_bits, nbrs) & valid
        valid &= ~dead
    fmiss = None
    if labels is not None:
        # tombstone test FIRST: a dead candidate counts once in `masked`
        fmiss = ~label_match_gather(labels, filter_bytes, nbrs) & valid
        valid &= ~fmiss
    nbrs = torch.where(valid, nbrs, torch.full_like(nbrs, -1))
    if telemetry:
        scored = valid.sum(dim=1).to(torch.int32)
        masked = (dead.sum(dim=1).to(torch.int32) if dead is not None
                  else torch.zeros_like(scored))
        if fmiss is not None:
            masked = masked + fmiss.sum(dim=1).to(torch.int32)
        dups = (in_range & dup).sum(dim=1).to(torch.int32)

    d = score_fn(nbrs)                                   # (Q, R)
    d = torch.where(valid, d, torch.full_like(d, _INF))

    f_ids, f_dists, f_vis = merge_frontier_topk(
        f_ids, f_dists, f_vis, nbrs, d, beam_width=l_width)
    # narrowing applies only to rows that expanded work this hop
    ni, nd, nv = apply_beam_width(f_ids, f_dists, f_vis, width)
    act = pick_valid[:, None]
    f_ids = torch.where(act, ni, f_ids)
    f_dists = torch.where(act, nd, f_dists)
    f_vis = torch.where(act, nv, f_vis)
    if telemetry:
        occ = torch.where(pick_valid, (f_ids >= 0).sum(dim=1).to(torch.int32),
                          torch.zeros_like(scored))
        return f_ids, f_dists, f_vis, pick_valid, (scored, masked, dups, occ)
    return f_ids, f_dists, f_vis, pick_valid


def search_loop(f_ids, f_dists, f_vis, *, score_fn, adjacency, n_valid,
                schedule, max_iters: int, tombstone_bits=None, labels=None,
                filter_bytes=None, telemetry: bool = False):
    """The whole-search loop from a given frontier, unfinalized: hops until
    no row has an unvisited slot or `max_iters` is reached. `schedule` is
    the per-hop width tuple (`expand_schedule`); tombstone_bits / labels
    here are the exclude-mode (in-walk) masks. Returns (f_ids, f_dists,
    n_hops, telemetry) — telemetry (scored, masked, dups, occ_log) or None.
    """
    q = f_ids.shape[0]
    dev = f_ids.device
    hops = torch.zeros((q,), dtype=torch.int32, device=dev)
    if telemetry:
        scored = torch.zeros((q,), dtype=torch.int32, device=dev)
        masked = torch.zeros_like(scored)
        dups = torch.zeros_like(scored)
        occ_log = torch.zeros((q, max_iters), dtype=torch.int32, device=dev)
    for it in range(max_iters):
        if not bool(((f_ids >= 0) & ~f_vis).any()):
            break
        hop = fused_hop_ref(
            f_ids, f_dists, f_vis, score_fn=score_fn, adjacency=adjacency,
            n_valid=n_valid, width=schedule[it],
            tombstone_bits=tombstone_bits, labels=labels,
            filter_bytes=filter_bytes, telemetry=telemetry)
        f_ids, f_dists, f_vis, pv = hop[:4]
        hops += pv.to(torch.int32)
        if telemetry:
            hs, hm, hd, ho = hop[4]
            scored += hs
            masked += hm
            dups += hd
            occ_log[:, it] = ho
    tel = (scored, masked, dups, occ_log) if telemetry else None
    return f_ids, f_dists, hops, tel


def fused_search_ref(adjacency, n_valid, medoid, score_fn, num_queries, *,
                     beam_width: int, max_iters: int,
                     beam_schedule: tuple | None = None,
                     tombstone_bits=None, traverse_deleted: bool = True,
                     labels=None, filter_bytes=None,
                     filter_exclude: bool = False,
                     telemetry: bool = False):
    """Whole-search oracle: the megakernel's semantics in plain PyTorch.

    Returns (frontier_ids (Q, L), frontier_dists (Q, L), n_hops (Q,)),
    finalized — plus, with `telemetry`, (scored, masked, dups, occ_log).
    """
    sched = expand_schedule(beam_schedule, beam_width, max_iters)
    exclude = tombstone_bits is not None and not traverse_deleted
    body_tomb = tombstone_bits if exclude else None
    body_labels = labels if (labels is not None and filter_exclude) else None
    dev = adjacency.device
    d0 = score_fn(torch.full((num_queries, 1), medoid, dtype=torch.int32,
                             device=dev))
    f_ids, f_dists, f_vis = init_frontier(medoid, d0, num_queries,
                                          beam_width)
    f_ids, f_dists, hops, tel = search_loop(
        f_ids, f_dists, f_vis, score_fn=score_fn, adjacency=adjacency,
        n_valid=n_valid, schedule=sched, max_iters=max_iters,
        tombstone_bits=body_tomb, labels=body_labels,
        filter_bytes=filter_bytes, telemetry=telemetry)
    f_ids, f_dists = finalize_frontier(f_ids, f_dists, tombstone_bits,
                                       labels=labels,
                                       filter_bytes=filter_bytes)
    if telemetry:
        return f_ids, f_dists, hops, tel
    return f_ids, f_dists, hops
