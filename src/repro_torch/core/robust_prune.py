"""Batched alpha-RobustPrune (paper Alg. 2 / DiskANN) in PyTorch.

Port of `repro.core.robust_prune`. Many vertices are pruned in lockstep:
one loop over the R selection steps, the V axis supplying the
parallelism. The JAX version recomputes d2(p*, c) for every candidate at
every step with a (V, C, D) batched matvec; here the (V, C, C) Gram matrix
of each chunk's candidates is computed once with one batched matmul and
each step reads one row of it, which moves C*D floats per vertex once
instead of R times. The arithmetic is the same dot products.

Distances are squared L2, so alpha is applied squared
(alpha * d(p*, p') <= d(p, p')  <=>  alpha^2 * d2(p*, p') <= d2(p, p')).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INF = float("inf")
_BIG_ID = 2**30


class PruneResult(NamedTuple):
    selected_ids: torch.Tensor    # (V, R) int32, insertion order, -1 padded
    selected_dists: torch.Tensor  # (V, R) f32 d(p, sel), +inf padded
    n_selected: torch.Tensor      # (V,) int32


def dedup_sort_candidates(cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                          pivot_ids: torch.Tensor, n_valid: int,
                          live: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask invalid/self/duplicate candidates and sort by distance.

    Returns sorted (ids, dists) with dead entries pushed to the end as
    (-1, +inf). `live`: optional bool[N_cap] row-liveness mask.
    """
    valid = ((cand_ids >= 0) & (cand_ids < n_valid)
             & (cand_ids != pivot_ids[:, None]))
    if live is not None:
        valid &= live[torch.clamp(cand_ids, min=0).long()]
    ids_for_dup = torch.where(valid, cand_ids,
                              torch.full_like(cand_ids, _BIG_ID))
    # sort by id to make duplicates adjacent; keep dists aligned
    s_ids, order = torch.sort(ids_for_dup, dim=1, stable=True)
    s_dists = torch.gather(cand_dists, 1, order)
    dup = torch.cat([torch.zeros_like(s_ids[:, :1], dtype=torch.bool),
                     s_ids[:, 1:] == s_ids[:, :-1]], dim=1)
    dead = dup | (s_ids >= _BIG_ID)
    d = torch.where(dead, torch.full_like(s_dists, _INF), s_dists)
    i = torch.where(dead, torch.full_like(s_ids, -1), s_ids)
    # final order: by distance ascending
    d, order = torch.sort(d, dim=1, stable=True)
    return torch.gather(i, 1, order), d


def _robust_prune_sorted(cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                         cand_vecs: torch.Tensor, degree_bound: int,
                         alpha: float) -> PruneResult:
    """Core greedy loop. Candidates must be dedup'd + distance-sorted.

    cand_vecs: (V, C, D) gathered candidate vectors (invalid rows arbitrary).
    """
    v_n, c_n = cand_ids.shape
    dev = cand_ids.device
    alpha2 = torch.tensor(alpha * alpha, dtype=torch.float32, device=dev)
    cv = cand_vecs.to(torch.float32)
    cv_sq = (cv * cv).sum(dim=-1)                            # (V, C)
    gram = torch.bmm(cv, cv.transpose(1, 2))                 # (V, C, C)

    sel_ids = torch.full((v_n, degree_bound), -1, dtype=torch.int32,
                         device=dev)
    sel_dists = torch.full((v_n, degree_bound), _INF, dtype=torch.float32,
                           device=dev)
    alive = torch.isfinite(cand_dists)
    n_sel = torch.zeros((v_n,), dtype=torch.int32, device=dev)
    rows = torch.arange(v_n, device=dev)

    for s in range(degree_bound):
        has = alive.any(dim=1)                               # (V,)
        # candidates are distance-sorted => first alive is the closest;
        # argmax returns the first maximum, as jnp.argmax does
        pick = torch.argmax(alive.to(torch.uint8), dim=1)    # (V,)
        pid = cand_ids[rows, pick]
        pdist = cand_dists[rows, pick]
        sel_ids[:, s] = torch.where(has, pid, torch.full_like(pid, -1))
        sel_dists[:, s] = torch.where(has, pdist,
                                      torch.full_like(pdist, _INF))
        n_sel += has.to(torch.int32)

        # d2(p*, c) for all candidates from the chunk's Gram matrix
        dot = gram[rows, pick]                               # (V, C)
        p_sq = cv_sq[rows, pick][:, None]                    # (V, 1)
        d_star = torch.clamp(p_sq - 2.0 * dot + cv_sq, min=0.0)

        # alpha-domination: drop c if alpha^2 * d2(p*, c) <= d2(p, c)
        kill = alpha2 * d_star <= cand_dists
        onehot = torch.zeros_like(alive)
        onehot[rows, pick] = True
        alive = alive & ~kill & ~onehot
        alive = alive & has[:, None]  # exhausted rows stay exhausted
    return PruneResult(selected_ids=sel_ids, selected_dists=sel_dists,
                       n_selected=n_sel)


def robust_prune_batch(vectors: torch.Tensor, pivot_ids: torch.Tensor,
                       cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                       n_valid: int, *, degree_bound: int,
                       alpha: float = 1.2, chunk_size: int = 1024,
                       live: torch.Tensor | None = None) -> PruneResult:
    """alpha-RobustPrune for a batch of vertices.

    vectors:    (N_cap, D) full vector table (rows gathered per chunk)
    pivot_ids:  (V,)   vertex being pruned (-1 rows are padding, emit all -1)
    cand_ids:   (V, C) merged candidate lists (may contain dups/-1/self)
    cand_dists: (V, C) d2(pivot, cand)
    chunk_size: vertices per chunk — bounds the (chunk, C, D) gather and the
                (chunk, C, C) Gram matrix; changes no result.
    live:       optional bool[N_cap] — rows whose bit is False are
                excluded from every selection.
    """
    v_total = pivot_ids.shape[0]
    out_ids, out_dists, out_n = [], [], []
    for start in range(0, v_total, chunk_size):
        p_ids = pivot_ids[start:start + chunk_size]
        c_ids, c_dists = dedup_sort_candidates(
            cand_ids[start:start + chunk_size],
            cand_dists[start:start + chunk_size], p_ids, n_valid, live)
        cv = vectors[torch.clamp(c_ids, min=0).long()]
        res = _robust_prune_sorted(c_ids, c_dists, cv, degree_bound, alpha)
        # padded pivots produce empty rows
        real = (p_ids >= 0)[:, None]
        out_ids.append(torch.where(real, res.selected_ids,
                                   torch.full_like(res.selected_ids, -1)))
        out_dists.append(torch.where(real, res.selected_dists,
                                     torch.full_like(res.selected_dists,
                                                     _INF)))
        out_n.append(torch.where(real[:, 0], res.n_selected,
                                 torch.zeros_like(res.n_selected)))
    if not out_ids:
        dev = pivot_ids.device
        return PruneResult(
            torch.full((0, degree_bound), -1, dtype=torch.int32, device=dev),
            torch.full((0, degree_bound), _INF, dtype=torch.float32,
                       device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev))
    return PruneResult(torch.cat(out_ids), torch.cat(out_dists),
                       torch.cat(out_n))
