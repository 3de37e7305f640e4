"""Medoid (entry point) selection for the Vamana graph (§3.2): the vector
closest to the dataset centre. Port of `repro.core.medoid`."""

from __future__ import annotations

import torch

from repro_torch.core.distances import pairwise_l2_squared


def compute_medoid(vectors: torch.Tensor,
                   valid_mask: torch.Tensor | None = None) -> int:
    """Index of the vector closest to the (masked) centroid.

    vectors: (N, D). valid_mask: optional (N,) bool — capacity-allocated
    indexes carry trailing unwritten rows that must not vote. torch.argmin
    returns the first minimum, as jnp.argmin does.
    """
    v = vectors.to(torch.float32)
    if valid_mask is None:
        centroid = v.mean(dim=0, keepdim=True)
        d = pairwise_l2_squared(centroid, v)[0]
        return int(torch.argmin(d))
    w = valid_mask.to(torch.float32)
    denom = torch.clamp(w.sum(), min=1.0)
    centroid = ((v * w[:, None]).sum(dim=0) / denom)[None, :]
    d = pairwise_l2_squared(centroid, v)[0]
    d = torch.where(valid_mask, d, torch.full_like(d, float("inf")))
    return int(torch.argmin(d))
