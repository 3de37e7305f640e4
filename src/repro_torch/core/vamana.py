"""Vamana graph structure (§3.1) as fixed-shape tensors.

Port of `repro.core.vamana`. The adjacency is a dense int32[N_cap, R]
tensor, -1 padded; `N_cap` is a capacity, not the live size. `n_valid`
and `medoid` are host ints: they are kernel launch arguments and loop
bounds, so keeping them on the host saves a device sync per search.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID = -1


class VamanaGraph(NamedTuple):
    """Directed bounded-degree proximity graph.

    adjacency: int32[N_cap, R]   out-edges, -1 padded (sorted by distance)
    n_valid:   int               number of live vertices (prefix of rows)
    medoid:    int               entry point for search/construction
    """

    adjacency: torch.Tensor
    n_valid: int
    medoid: int

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degree_bound(self) -> int:
        return self.adjacency.shape[1]


def init_graph(capacity: int, degree_bound: int, device) -> VamanaGraph:
    """Empty graph with pre-allocated capacity."""
    adj = torch.full((capacity, degree_bound), INVALID, dtype=torch.int32,
                     device=device)
    return VamanaGraph(adjacency=adj, n_valid=0, medoid=0)


def graph_degree_stats(graph: VamanaGraph) -> dict:
    """Live-vertex degree statistics (used by tests and benchmarks)."""
    n = graph.n_valid
    adj = graph.adjacency
    live = torch.arange(graph.capacity, device=adj.device) < n
    deg = (adj >= 0).sum(dim=1)
    deg = torch.where(live, deg, torch.zeros_like(deg))
    n_f = max(float(n), 1.0)
    return {
        "mean_degree": deg.sum().to(torch.float32) / n_f,
        "max_degree": deg.max(),
        "min_degree": torch.where(live, deg,
                                  torch.full_like(deg, graph.degree_bound + 1)
                                  ).min(),
        "n_valid": n,
    }


def validate_graph(graph: VamanaGraph,
                   live_mask: torch.Tensor | None = None) -> dict:
    """Structural invariants: every edge target is a live vertex (or -1
    padding), no self loops, padding is suffix-contiguous per row. With
    `live_mask`, additionally no live row keeps an edge into a dead row."""
    n = graph.n_valid
    adj = graph.adjacency
    row_ids = torch.arange(graph.capacity, dtype=torch.int32,
                           device=adj.device)[:, None]
    live_row = row_ids < n
    is_pad = adj < 0
    in_range = torch.where(is_pad, True, (adj >= 0) & (adj < n))
    no_self = torch.where(is_pad, True, adj != row_ids)
    pad_prefix = torch.cumsum(is_pad.to(torch.int32), dim=1)
    contiguous = torch.all(torch.where(is_pad, True, pad_prefix == 0)
                           | ~live_row)
    checks = {
        "edges_in_range": torch.all(in_range | ~live_row),
        "no_self_loops": torch.all(no_self | ~live_row),
        "padding_contiguous": contiguous,
    }
    if live_mask is not None:
        live_row = live_row & live_mask[:, None]
        tgt_live = torch.where(is_pad, True,
                               live_mask[torch.clamp(adj, min=0).long()])
        checks["edges_to_live"] = torch.all(tgt_live | ~live_row)
    return checks
