"""Product Quantization baseline (paper §5, Jégou et al. 2011). DEPRECATED.

Port of `repro.core.pq`. The paper implements PQ in Jasper and finds it
strictly worse than exact search on a GPU: the per-subspace codebook
lookups scatter over memory and the lookup table does not fit shared
memory. It is kept as the comparison baseline of the paper's Fig 12; it
has no kernel of its own and never will. RaBitQ (`core/rabitq.py` and the
`rabitq_dot` kernels) is the kernel-backed quantized path. Index-level use
needs the explicit `JasperIndex(quantization="pq")` opt-in, which warns.

Layout: D dims split into K contiguous subspaces of D/K dims, each
quantized to one of 256 centroids learned by a few Lloyd iterations from
seeded initial centroids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# rows assigned per block in Lloyd's and the encoder: bounds the (rows,
# centroids) distance block to 64 MB at 256 centroids
_ASSIGN_CHUNK = 65536


class PQParams(NamedTuple):
    codebooks: torch.Tensor  # (K, 256, Dsub)

    @property
    def n_subspaces(self) -> int:
        return self.codebooks.shape[0]

    @property
    def subdim(self) -> int:
        return self.codebooks.shape[2]


def _nearest(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(N, Dsub) x (C, Dsub) -> int64[N] index of the nearest centroid in
    squared L2, |x|^2 - 2 x.c + |c|^2 (first on ties), in row blocks."""
    c_sq = (cent * cent).sum(dim=1)
    out = []
    for s in range(0, x.shape[0], _ASSIGN_CHUNK):
        xs = x[s:s + _ASSIGN_CHUNK]
        d = ((xs * xs).sum(dim=1)[:, None] - 2.0 * (xs @ cent.T)
             + c_sq[None, :])
        out.append(torch.argmin(d, dim=1))
    if not out:
        return torch.empty((0,), dtype=torch.long, device=x.device)
    return torch.cat(out)


def initial_indices(generator: torch.Generator, n: int,
                    n_centroids: int) -> torch.Tensor:
    """Seeded initial centroid rows: distinct when n >= n_centroids."""
    if n >= n_centroids:
        return torch.randperm(n, generator=generator)[:n_centroids]
    return torch.randint(n, (n_centroids,), generator=generator)


def kmeans_lloyd(x: torch.Tensor, init_idx: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Plain Lloyd's on one subspace from the rows `init_idx`: (N, Dsub)
    -> (C, Dsub). An empty cluster keeps its centroid. Sums per cluster by
    `index_add_` (no (N, C) one-hot)."""
    x = x.to(torch.float32)
    cent = x[init_idx.to(x.device).long()]
    c = cent.shape[0]
    for _ in range(iters):
        assign = _nearest(x, cent)
        counts = torch.bincount(assign, minlength=c).to(torch.float32)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cent = torch.where((counts > 0)[:, None], new, cent)
    return cent


def _subspaces(vectors: torch.Tensor, k: int, dsub: int) -> torch.Tensor:
    """(N, D) -> (N, K, Dsub) float32 view of the first K*Dsub dims."""
    n = vectors.shape[0]
    return vectors.to(torch.float32)[:, :k * dsub].reshape(n, k, dsub)


def pq_train(generator: torch.Generator, vectors: torch.Tensor,
             n_subspaces: int = 16, n_centroids: int = 256,
             iters: int = 8) -> PQParams:
    """K codebooks of `n_centroids`, one Lloyd's run a subspace, its
    initial rows drawn from `generator` (a seeded CPU generator)."""
    n, d = vectors.shape
    if d % n_subspaces != 0:
        raise ValueError(
            f"dims {d} not divisible by n_subspaces {n_subspaces}")
    xs = _subspaces(vectors, n_subspaces, d // n_subspaces)
    books = [kmeans_lloyd(xs[:, s], initial_indices(generator, n,
                                                    n_centroids), iters)
             for s in range(n_subspaces)]
    return PQParams(codebooks=torch.stack(books))


def pq_encode(params: PQParams, vectors: torch.Tensor) -> torch.Tensor:
    """(N, D) -> uint8[N, K] nearest-centroid codes."""
    k, _, dsub = params.codebooks.shape
    books = params.codebooks.to(vectors.device)
    xs = _subspaces(vectors, k, dsub)
    codes = [_nearest(xs[:, s], books[s]) for s in range(k)]
    return torch.stack(codes, dim=1).to(torch.uint8)


def pq_lookup_table(params: PQParams, queries: torch.Tensor) -> torch.Tensor:
    """ADC tables: (Q, K, 256) squared L2 of each query subvector to the
    centroids."""
    k, _, dsub = params.codebooks.shape
    qs = _subspaces(queries, k, dsub)
    diff = qs[:, :, None, :] - params.codebooks[None, :, :, :]
    return (diff * diff).sum(dim=-1)


def _adc_lookup(lut: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per-candidate ADC gather-and-sum: lut (Q, K, 256) x codes (Q, C, K)
    -> (Q, C). The paper's "scattered lookup" pattern: one flat gather
    into each query's (K * 256) table, with no copy of the table per
    candidate."""
    q_n, k, n_c = lut.shape
    flat = c.long() + torch.arange(k, device=c.device) * n_c   # (Q, C, K)
    g = torch.gather(lut.reshape(q_n, k * n_c), 1, flat.reshape(q_n, -1))
    return g.reshape(c.shape).sum(dim=-1)


def pq_distance(params: PQParams, codes: torch.Tensor, queries: torch.Tensor,
                candidate_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Asymmetric distances by table lookups: every coded row (Q, N), or
    the rows `candidate_ids` (Q, C) (ids < 0 read row 0)."""
    lut = pq_lookup_table(params, queries)
    if candidate_ids is None:
        return _adc_lookup(lut, codes[None].expand(lut.shape[0], -1, -1))
    return _adc_lookup(lut, codes[candidate_ids.clamp(min=0).long()])


def make_pq_scorer(params: PQParams, codes: torch.Tensor,
                   queries: torch.Tensor):
    """Beam-search ScoreFn over PQ codes (deprecated baseline path).

    The ADC tables are computed once a query batch; each score call is
    then the scattered per-candidate lookup the paper measures. Invalid
    ids are masked by beam_search itself.
    """
    lut = pq_lookup_table(params, queries)

    def score(candidate_ids: torch.Tensor) -> torch.Tensor:
        return _adc_lookup(lut, codes[candidate_ids.clamp(min=0).long()])

    return score
