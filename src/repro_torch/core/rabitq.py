"""RaBitQ quantization (paper §5.1, Gao & Long 2024) in PyTorch.

Port of `repro.core.rabitq`. A vector v is (1) centred (v - c), (2)
rotated by a random orthonormal P, (3) normalised to a unit vector o and
(4) scalar-quantised to m bits per coordinate. Squared L2 to a query q is
then one inner product between the integer codes and the rotated query
plus per-vector / per-query scalars:

    d^2(v, q) ~= data_add + query_add
                 + data_rescale * (<codes, q_rot> - query_sumq)

with
    o        = P(v - c) / |v - c|
    delta    = 2 * max_i |o_i| / (2^m - 1)          (per-vector step)
    codes    = clip(round(o / delta + (2^m-1)/2), 0, 2^m-1)
    o_bar    = delta * (codes - (2^m-1)/2)
    data_add     = |v - c|^2
    data_rescale = -2 * |v - c| * delta / <o_bar, o>
    q_rot        = P(q - c)
    query_add    = |q - c|^2
    query_sumq   = (2^m - 1)/2 * sum(q_rot)

The packed form (`pack_codes`, little-endian within a byte) is the only
full-width array kept on the device: uint8[N, ceil(D*m/8)].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

_EPS = 1e-12

SUPPORTED_BITS = (1, 2, 4, 8)


@dataclass(frozen=True)
class RaBitQParams:
    """Dataset-level quantizer state (trained once, tiny)."""

    rotation: torch.Tensor   # (D, D) orthonormal
    centroid: torch.Tensor   # (D,)
    bits: int                # m

    @property
    def dims(self) -> int:
        return self.rotation.shape[0]


@dataclass(frozen=True)
class RaBitQCodes:
    """Per-vector quantized storage — packed codes are canonical.

    packed:       uint8[N, ceil(D*bits/8)]
    data_add:     f32[N]
    data_rescale: f32[N]
    """

    packed: torch.Tensor
    data_add: torch.Tensor
    data_rescale: torch.Tensor
    bits: int
    dims: int

    def unpacked(self) -> torch.Tensor:
        """Transient uint8[N, D] view (materialised on demand, never kept)."""
        return unpack_codes(self.packed, self.bits, self.dims)

    def gather_unpacked(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows in packed form, then unpack: ids[...] -> uint8[..., D]."""
        return unpack_codes(self.packed[ids], self.bits, self.dims)


class RaBitQQuery(NamedTuple):
    """Per-query preprocessed state (computed once per query batch)."""

    q_rot: torch.Tensor       # (Q, D) rotated, centred query
    query_add: torch.Tensor   # (Q,)
    query_sumq: torch.Tensor  # (Q,)


def random_rotation(generator: torch.Generator, dims: int,
                    device=None) -> torch.Tensor:
    """Random orthonormal matrix via QR of a Gaussian (Haar measure).

    The Gaussian is drawn on the CPU from `generator` (a seeded CPU
    `torch.Generator`), so the rotation depends on the seed only, not on
    the device it is moved to afterwards.
    """
    g = torch.randn((dims, dims), generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(g)
    # fix signs so the distribution is exactly Haar (and deterministic)
    d = torch.sign(torch.diagonal(r))
    return (q * d[None, :]).to(device if device is not None else "cpu")


def rabitq_train(generator: torch.Generator, vectors: torch.Tensor,
                 bits: int = 4, valid_mask: torch.Tensor | None = None
                 ) -> RaBitQParams:
    """Fit the (trivial) trainable state: centroid + rotation."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    v = vectors.to(torch.float32)
    if valid_mask is None:
        centroid = v.mean(dim=0)
    else:
        w = valid_mask.to(torch.float32)
        centroid = (v * w[:, None]).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
    rot = random_rotation(generator, v.shape[1], device=v.device)
    return RaBitQParams(rotation=rot, centroid=centroid, bits=bits)


def _encode(vectors: torch.Tensor, rotation: torch.Tensor,
            centroid: torch.Tensor, bits: int) -> RaBitQCodes:
    levels = float(2**bits - 1)
    half = levels / 2.0
    r = vectors.to(torch.float32) - centroid[None, :]
    norm2 = (r * r).sum(dim=-1)                          # |v-c|^2
    norm = torch.sqrt(norm2)
    o_un = r @ rotation.T                                # P(v-c)
    o = o_un / torch.clamp(norm, min=_EPS)[:, None]      # unit
    delta = 2.0 * o.abs().amax(dim=-1) / levels          # per-vector step
    delta = torch.clamp(delta, min=_EPS)
    # torch.round rounds half to even, as jnp.round does
    u = torch.clamp(torch.round(o / delta[:, None] + half), 0.0, levels)
    o_bar = delta[:, None] * (u - half)
    ip = (o_bar * o).sum(dim=-1)                         # <o_bar, o>
    rescale = -2.0 * norm * delta / torch.where(ip.abs() > _EPS, ip,
                                                torch.ones_like(ip))
    rescale = torch.where(norm > _EPS, rescale, torch.zeros_like(rescale))
    return RaBitQCodes(packed=pack_codes(u.to(torch.uint8), bits),
                       data_add=norm2, data_rescale=rescale, bits=bits,
                       dims=vectors.shape[1])


def rabitq_encode(params: RaBitQParams, vectors: torch.Tensor) -> RaBitQCodes:
    """Quantize (N, D) vectors -> packed codes + metadata."""
    return _encode(vectors, params.rotation, params.centroid, params.bits)


def _preprocess_query(queries: torch.Tensor, rotation: torch.Tensor,
                      centroid: torch.Tensor, bits: int) -> RaBitQQuery:
    half = (2**bits - 1) / 2.0
    r = queries.to(torch.float32) - centroid[None, :]
    q_rot = r @ rotation.T
    return RaBitQQuery(q_rot=q_rot, query_add=(r * r).sum(dim=-1),
                       query_sumq=half * q_rot.sum(dim=-1))


def rabitq_preprocess_query(params: RaBitQParams,
                            queries: torch.Tensor) -> RaBitQQuery:
    """Rotate/centre queries and compute the two query-side scalars."""
    return _preprocess_query(queries, params.rotation, params.centroid,
                             params.bits)


def rabitq_estimate(codes: RaBitQCodes, query: RaBitQQuery,
                    candidate_ids: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Estimated squared L2 distances.

    With candidate_ids (Q, K): per-query candidate sets, returns (Q, K).
    Without: all-pairs (Q, N).
    """
    if candidate_ids is None:
        dot = query.q_rot @ codes.unpacked().to(torch.float32).T   # (Q, N)
        add = codes.data_add[None, :]
        rsc = codes.data_rescale[None, :]
    else:
        safe = torch.clamp(candidate_ids, min=0).long()
        # gather PACKED rows (the bytes that actually move), unpack after
        c = codes.gather_unpacked(safe).to(torch.float32)          # (Q, K, D)
        dot = torch.einsum("qkd,qd->qk", c, query.q_rot)
        add = codes.data_add[safe]
        rsc = codes.data_rescale[safe]
    est = add + query.query_add[..., None] + rsc * (
        dot - query.query_sumq[..., None])
    return torch.clamp(est, min=0.0)


# ---------------------------------------------------------------------------
# Bit packing — the device / wire representation
# ---------------------------------------------------------------------------

def packed_dim(dims: int, bits: int) -> int:
    cpb = 8 // bits
    return (dims + cpb - 1) // cpb


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8[..., D] (values < 2^m) -> uint8[..., ceil(D*m/8)].

    Little-endian within each byte: code j of a byte occupies bits
    [j*m, (j+1)*m). D is zero-padded to a multiple of (8//m). Leading
    dimensions are preserved.
    """
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}")
    cpb = 8 // bits
    d = codes.shape[-1]
    d_pad = packed_dim(d, bits) * cpb
    c = torch.nn.functional.pad(codes.to(torch.int32), (0, d_pad - d))
    c = c.reshape(*codes.shape[:-1], d_pad // cpb, cpb)
    shifts = torch.arange(cpb, dtype=torch.int32, device=codes.device) * bits
    return (c << shifts).sum(dim=-1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int, dims: int) -> torch.Tensor:
    """Inverse of pack_codes -> uint8[..., dims] (leading dims preserved)."""
    cpb = 8 // bits
    mask = 2**bits - 1
    p = packed.to(torch.int32)[..., None]
    shifts = torch.arange(cpb, dtype=torch.int32, device=packed.device) * bits
    u = (p >> shifts) & mask
    u = u.reshape(*packed.shape[:-1], -1)[..., :dims]
    return u.to(torch.uint8)


def packed_bytes_per_vector(dims: int, bits: int) -> int:
    """Storage per vector incl. the two f32 metadata (paper's size formula)."""
    return packed_dim(dims, bits) + 2 * 4
