"""Mutation state: the search-side subset of `repro.core.mutations`.

Carries the packed tombstone bitmap and the per-row label plane that every
search path reads, plus the free pool / counters so checkpoints round-trip.
The mutation operations themselves (`delete_rows`, `consolidate`,
`take_free_slots`, `grow_*`) are not ported yet (ROADMAP queue A).

  * `tombstone_bits` is a PACKED bitmap (uint8[ceil(capacity/8)], one bit
    per row, little-endian within each byte): "may this id be returned?"
    is a single bit test.
  * `labels` is a per-row label bitset (uint8[capacity, N_LABEL_BYTES]); a
    row matches a filter when its bitset intersects the filter's byte mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Packed row bitmap (1 bit per capacity row, little-endian within each byte)
# ---------------------------------------------------------------------------


def bitmap_bytes(capacity: int) -> int:
    return (capacity + 7) // 8


def pack_bitmap(dense: torch.Tensor) -> torch.Tensor:
    """bool[N] -> uint8[ceil(N/8)] (bit i of byte j = row 8*j + i)."""
    n = dense.shape[0]
    pad = (-n) % 8
    d = torch.nn.functional.pad(dense.to(torch.int32), (0, pad)).reshape(-1, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=dense.device)
    return (d << shifts).sum(dim=-1).to(torch.uint8)


def unpack_bitmap(bits: torch.Tensor, n: int) -> torch.Tensor:
    """uint8[ceil(N/8)] -> bool[N]."""
    b = bits.to(torch.int32)[:, None]
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return ((b >> shifts) & 1).reshape(-1)[:n].to(torch.bool)


def bitmap_gather(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-id bit test: int32[...] -> bool[...] (negative ids -> False).
    One byte gather + shift/mask per id; the bitmap never unpacks."""
    safe = torch.clamp(ids, min=0).long()
    byte = bits[safe >> 3].to(torch.int64)
    bit = (byte >> (safe & 7)) & 1
    return (bit == 1) & (ids >= 0)


# ---------------------------------------------------------------------------
# Per-row label bitsets (filtered / multi-tenant search)
# ---------------------------------------------------------------------------

N_LABEL_BYTES = 4
N_LABELS = 8 * N_LABEL_BYTES


def _check_label(label: int) -> int:
    label = int(label)
    if not 0 <= label < N_LABELS:
        raise ValueError(f"label id {label} out of range [0, {N_LABELS})")
    return label


def filter_to_bytes(label_ids) -> np.ndarray:
    """Label-id set -> uint8[N_LABEL_BYTES] byte mask (the runtime search
    operand: a row matches when its label row ANDs nonzero against it)."""
    fb = np.zeros((N_LABEL_BYTES,), np.uint8)
    for label in label_ids:
        label = _check_label(label)
        fb[label >> 3] |= np.uint8(1 << (label & 7))
    return fb


def pack_label_rows(labels, n_rows: int) -> np.ndarray:
    """Per-row label sets -> uint8[n_rows, N_LABEL_BYTES] bitset rows.

    `labels` may be None (all-zero rows: the row matches no filter), a
    scalar label id (broadcast to every row), a 1-D int sequence (one
    label per row), or a sequence of per-row label-id iterables.
    """
    out = np.zeros((n_rows, N_LABEL_BYTES), np.uint8)
    if labels is None:
        return out
    if np.isscalar(labels) or getattr(labels, "ndim", None) == 0:
        labels = [labels] * n_rows
    rows = list(labels)
    if len(rows) != n_rows:
        raise ValueError(f"labels: got {len(rows)} rows, want {n_rows}")
    for i, row in enumerate(rows):
        ids = (row,) if np.isscalar(row) else tuple(row)
        for label in ids:
            label = _check_label(label)
            out[i, label >> 3] |= np.uint8(1 << (label & 7))
    return out


def label_match_gather(labels: torch.Tensor, filter_bytes: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """Per-id filter test: int32[...] -> bool[...] — True iff the row's
    label bitset intersects `filter_bytes` (negative ids -> False)."""
    safe = torch.clamp(ids, min=0).long()
    rows = labels[safe]
    hit = ((rows & filter_bytes.to(torch.uint8)) != 0).any(dim=-1)
    return hit & (ids >= 0)


# ---------------------------------------------------------------------------
# Mutation state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MutationState:
    """Delete/reuse bookkeeping for one capacity-allocated index.

    tombstone_bits: uint8[ceil(cap/8)]  1 = dead (deleted or freed)
    labels:         uint8[cap, NB]      per-row label bitsets
    free_ids:       int32[cap]          reusable slots, ascending, -1 padded
    n_free, n_deleted, generation:      host ints (checkpointed as int32)
    """

    tombstone_bits: torch.Tensor
    labels: torch.Tensor
    free_ids: torch.Tensor
    n_free: int
    n_deleted: int
    generation: int

    @property
    def capacity(self) -> int:
        return self.free_ids.shape[0]


def init_mutation_state(capacity: int, device) -> MutationState:
    return MutationState(
        tombstone_bits=torch.zeros((bitmap_bytes(capacity),), dtype=torch.uint8,
                                   device=device),
        labels=torch.zeros((capacity, N_LABEL_BYTES), dtype=torch.uint8,
                           device=device),
        free_ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        n_free=0, n_deleted=0, generation=0)
