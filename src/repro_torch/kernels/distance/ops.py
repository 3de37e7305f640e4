"""Exact gather distances: the CUDA `gather_l2` kernel and its plain version.

Replaces `gather_l2_chunked_pallas` (`repro/kernels/distance/
distance_kernel.py:130`) together with its wrapper's XLA gather
(`repro/kernels/distance/ops.py:74`): the kernel reads the candidate rows
itself, so no (Q, K, D) candidate buffer is ever built.

    out[q, k] = max(|q|^2 - 2 q.c + |c|^2, 0),  c = table[ids[q, k]]
              = +inf where ids[q, k] < 0
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_INF = float("inf")


def gather_l2_plain(q: torch.Tensor, table: torch.Tensor,
                    sqnorm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device): gather + batched dot. Ids past
    the table clamp to its last row, as an XLA gather does."""
    q = q.to(torch.float32)
    safe = torch.clamp(ids.long(), 0, table.shape[0] - 1)
    cand = table[safe].to(torch.float32)                      # (Q, K, D)
    q_sq = (q * q).sum(dim=-1, keepdim=True)
    dot = torch.einsum("qkd,qd->qk", cand, q)
    d = torch.clamp(q_sq - 2.0 * dot + sqnorm[safe], min=0.0)
    return torch.where(ids >= 0, d, torch.full_like(d, _INF))


def gather_l2(q: torch.Tensor, table: torch.Tensor, sqnorm: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 queries, (N, D) f32 table, (N,) f32 squared norms, (Q, K)
    int32 ids -> (Q, K) f32 squared L2, +inf for ids < 0.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    dev = ids.device
    if dev.type == "cpu":
        return gather_l2_plain(q, table, sqnorm, ids)
    if dev.type != "cuda":
        raise ValueError(f"gather_l2 runs on cuda or cpu tensors, got {dev}")
    for t, name, dt, nd in ((q, "q", torch.float32, 2),
                            (table, "table", torch.float32, 2),
                            (sqnorm, "sqnorm", torch.float32, 1),
                            (ids, "ids", torch.int32, 2)):
        build.require(t, name, dt, nd, dev)
    qn, k = ids.shape
    n, d = table.shape
    if q.shape != (qn, d) or sqnorm.shape != (n,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, table "
                         f"{tuple(table.shape)}, sqnorm "
                         f"{tuple(sqnorm.shape)}, ids {tuple(ids.shape)}")
    out = torch.empty((qn, k), dtype=torch.float32, device=dev)
    if qn == 0 or k == 0:
        return out
    if n == 0:
        raise ValueError("gather_l2 needs a non-empty table")
    fn = build.entry("gather_l2", "gather_l2_launch",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    err = fn(build.ptr(q), build.ptr(ids), build.ptr(table),
             build.ptr(sqnorm), build.ptr(out), qn, k, d, n,
             ctypes.c_void_p(build.stream_handle()))
    build.check(err, "gather_l2")
    gather_l2.launches += 1
    return out


gather_l2.launches = 0


def make_kernel_scorer(vectors: torch.Tensor, queries: torch.Tensor,
                       n_valid: int, vec_sqnorm: torch.Tensor | None = None,
                       *, tombstone_bits: torch.Tensor | None = None,
                       labels: torch.Tensor | None = None,
                       filter_bytes: torch.Tensor | None = None):
    """Beam-search ScoreFn backed by `gather_l2` (drop-in for
    `core.beam_search.make_exact_scorer`). Out-of-range, tombstoned
    (exclude mode) and out-of-filter (exclude mode) ids become -1 before
    the kernel, which writes +inf for them: the scorer is self-masking."""
    from repro_torch.core.mutations import bitmap_gather, label_match_gather

    v = vectors
    if vec_sqnorm is None:
        vec_sqnorm = (v.to(torch.float32) ** 2).sum(dim=-1)
    q = queries.to(torch.float32).contiguous()

    def score(ids: torch.Tensor) -> torch.Tensor:
        in_range = (ids >= 0) & (ids < n_valid)
        if tombstone_bits is not None:
            in_range &= ~bitmap_gather(tombstone_bits, ids)
        if labels is not None:
            in_range &= label_match_gather(labels, filter_bytes, ids)
        masked = torch.where(in_range, ids, torch.full_like(ids, -1))
        return gather_l2(q, v, vec_sqnorm, masked.to(torch.int32).contiguous())

    score.self_masking = True
    return score
