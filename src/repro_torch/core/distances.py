"""Distance computations for ANNS (port of `repro.core.distances`).

All comparisons run on squared L2 (the square root is monotone). MIPS is
reduced to L2 by the one-extra-dimension augmentation (§6.3), because
RobustPrune needs a metric space.
"""

from __future__ import annotations

import torch

METRICS = ("l2", "mips")


def l2_squared(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance between two batched vector sets, last-dim reduced."""
    d = x.to(torch.float32) - y.to(torch.float32)
    return (d * d).sum(dim=-1)


def inner_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) * y.to(torch.float32)).sum(dim=-1)


def pairwise_inner_product(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (C, D) -> (Q, C) inner products."""
    return q.to(torch.float32) @ x.to(torch.float32).T


def pairwise_l2_squared(q: torch.Tensor, x: torch.Tensor,
                        x_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, D) x (C, D) -> (Q, C) squared L2 in the expanded form
    |q|^2 - 2<q,x> + |x|^2 (one matmul); `x_sqnorm` may be precomputed."""
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if x_sqnorm is None:
        x_sqnorm = (x * x).sum(dim=-1)
    q_sqnorm = (q * q).sum(dim=-1)
    d = q_sqnorm[:, None] - 2.0 * (q @ x.T) + x_sqnorm[None, :]
    # clamp tiny negatives from cancellation
    return torch.clamp(d, min=0.0)


def pairwise_distance(q: torch.Tensor, x: torch.Tensor, metric: str = "l2",
                      x_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """Smaller-is-better pairwise distance under `metric` ("mips" returns
    the negated inner product)."""
    if metric == "l2":
        return pairwise_l2_squared(q, x, x_sqnorm)
    if metric == "mips":
        return -pairwise_inner_product(q, x)
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")


def mips_augment_data(x: torch.Tensor) -> torch.Tensor:
    """Lift data vectors (C, D) -> (C, D+1) so MIPS becomes L2:
    x' = [x, sqrt(M^2 - |x|^2)] with M = max row norm."""
    x = x.to(torch.float32)
    sq = (x * x).sum(dim=-1)
    m2 = sq.max()
    extra = torch.sqrt(torch.clamp(m2 - sq, min=0.0))
    return torch.cat([x, extra[:, None]], dim=-1)


def mips_augment_query(q: torch.Tensor) -> torch.Tensor:
    """Lift query vectors (Q, D) -> (Q, D+1) with a zero last coordinate."""
    q = q.to(torch.float32)
    return torch.cat([q, torch.zeros_like(q[..., :1])], dim=-1)
