"""The work of each hand-written kernel's function, by formula.

One function a kernel (#1-#12, the numbering of `PERF.md`'s table) gives
the bytes the function must move — each input read once, each output
written once — and the operations it does, at the rate its products run
at: "f32" on the SIMT units, "bf16" on the tensor cores. Where the work
depends on the data (a walk's hops, the candidates it scores, the valid
ids of a gather), the count is an argument: the caller passes what its
run's data needed, or the most it could need.

`bound` turns a count into the least time the card could take
(`roofline/analysis.py`'s H100 peaks); `chip_smoke.py` prints every
kernel's bound from here, and every kernel function reports its `Cost`
to an active `op_analyzer.OpAnalyzer`, so a roofline reads the same work
whichever implementation ran.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.roofline.analysis import H100, HwSpec, roofline_terms

RATES = ("f32", "bf16")


@dataclass(frozen=True)
class Cost:
    """Bytes moved and operations done by one call, the operations at
    `rate` ("f32" or "bf16")."""

    bytes: float
    flops: float
    rate: str = "f32"

    def bound(self, hw: HwSpec = H100) -> tuple[float, str]:
        """(least milliseconds, "bytes" or "operations")."""
        return bound(self.bytes, self.flops, self.rate, hw)


def bound(bytes_moved: float, flops: float, rate: str = "f32",
          hw: HwSpec = H100) -> tuple[float, str]:
    """The least milliseconds for `bytes_moved` over the card's memory rate
    and `flops` at `rate` (`analysis.roofline_terms` on one card, no
    collective): the larger, and which it is."""
    if rate not in RATES:
        raise ValueError(f"rate must be one of {RATES}, got {rate!r}")
    t = roofline_terms(flops, bytes_moved, 0.0, 1, hw,
                       f32_flops=flops if rate == "f32" else 0.0)
    if t["memory_s"] >= t["compute_s"]:
        return t["memory_s"] * 1e3, "bytes"
    return t["compute_s"] * 1e3, "operations"


# ------------------------------------------------------------ ANNS kernels
def fused_search(n_q: int, beam: int, r: int, row_bytes: int,
                 meta_bytes: int, dq: int, *, hops: float, scored: float,
                 d: int | None = None) -> Cost:
    """#1, the whole search: R·4 B of adjacency a hop, a row and its
    metadata a scored candidate; the initial frontier (ids, dists,
    visited: 12 B a slot) in, the final frontier (8 B a slot) out, the
    hop counts, the (Dq,) query and its two scalars; 2·D operations a
    scored candidate (D the stored dims, default Dq). `hops` and `scored`
    are totals over the queries."""
    return Cost(bytes=(hops * r * 4 + scored * (row_bytes + meta_bytes)
                       + n_q * (beam * 12 + beam * 8 + 4 + dq * 4 + 8)),
                flops=scored * 2 * (dq if d is None else d))


def fused_hop(n_q: int, beam: int, r: int, row_bytes: int, meta_bytes: int,
              dq: int, *, active: float, scored: float,
              d: int | None = None) -> Cost:
    """#4, one hop: the frontier in and out (ids, dists, visited: 24 B a
    slot), R·4 B of adjacency an expanded row (`active`), a row and its
    metadata a scored candidate, the query operands, the increments; 2·D
    operations a scored candidate."""
    return Cost(bytes=(n_q * beam * 24 + active * r * 4
                       + scored * (row_bytes + meta_bytes)
                       + n_q * (dq * 4 + 8) + n_q * 4),
                flops=scored * 2 * (dq if d is None else d))


def gather_l2(n_q: int, k: int, d: int, *, n_valid: float) -> Cost:
    """#2 and #8: the (Q, K) ids in and distances out, each valid id's
    row and squared norm (4D + 4 B), the queries."""
    return Cost(bytes=n_q * k * 8 + n_valid * (4 * d + 4) + n_q * d * 4,
                flops=n_valid * 2 * d)


def rabitq_search_step(n_q: int, k: int, p: int, dq: int, d: int, *,
                       n_valid: float) -> Cost:
    """#3: the (Q, K) ids in and estimates out, each in-range id's code row
    and two metadata floats (P + 8 B), the (Dq,) query and its scalars;
    2·D operations an in-range id."""
    return Cost(bytes=n_q * k * 8 + n_valid * (p + 8) + n_q * (dq * 4 + 8),
                flops=n_valid * 2 * d)


def rabitq_gather_distance(n_q: int, k: int, p: int, d: int) -> Cost:
    """#5: the gathered (Q, K) code rows and metadata, the queries and
    their scalars in, the (Q, K) estimates out."""
    return Cost(bytes=n_q * k * (p + 8) + n_q * (d * 4 + 8) + n_q * k * 4,
                flops=2.0 * n_q * k * d)


def rabitq_distance(n_q: int, c: int, p: int, d: int) -> Cost:
    """#6: every (query, row) pair: C code rows and metadata, the queries
    and scalars in, the (Q, C) estimates out; the 2·Q·C·D products are
    exact on the tensor cores, so they count at the bf16 rate."""
    return Cost(bytes=c * (p + 8) + n_q * (d * 4 + 8) + n_q * c * 4,
                flops=2.0 * n_q * c * d, rate="bf16")


def pairwise_l2(n_q: int, c: int, d: int, *, tensor_flops: float) -> Cost:
    """#7: both float32 operands in, the (Q, C) distances out;
    `tensor_flops` the products of bf16 parts the kernel takes on these
    operands (`kernels.distance.ops.pairwise_tensor_flops`), at the bf16
    rate."""
    return Cost(bytes=(n_q + c) * d * 4 + n_q * c * 4, flops=tensor_flops,
                rate="bf16")


def topk(n_q: int, c: int, k: int) -> Cost:
    """#9: read each row's distances and ids once, write the k smallest;
    C·C rank compares a row."""
    return Cost(bytes=n_q * c * 8 + n_q * k * 8, flops=float(n_q * c * c))


# ------------------------------------------------------------ flash kernels
def visible_pairs(sq: int, skv: int, causal: bool, window: int = 0,
                  q_offset: int = 0) -> float:
    """(query, key) pairs a head attends: all of them bidirectional; when
    causal, the keys before each query's position `q_offset + i` counted
    by halves at the diagonal (S²/2 for a square causal call), or a band
    of `window` keys a query where the window is the narrower."""
    if not causal:
        return float(sq * skv)
    pairs = sq * q_offset + sq * sq / 2
    if window and window < q_offset + sq:
        pairs = sq * window - (window * window / 2 if not q_offset else 0)
    return float(min(pairs, sq * skv))


def visible_keys(sq: int, skv: int, causal: bool, window: int = 0,
                 q_offset: int = 0) -> int:
    """Keys that at least one query attends, the only K/V rows the function
    must read: up to the last query's position `q_offset + sq - 1` when
    causal, from the first query's window start `q_offset - window + 1`
    when a window applies (a query at `q_offset` sees no key past
    itself, so the first rank of a context-parallel split reads only its
    own slice's keys)."""
    hi = min(skv, q_offset + sq) if causal else skv
    lo = max(0, q_offset - window + 1) if window else 0
    return max(0, hi - lo)


def flash_attention(b: int, sq: int, skv: int, h: int, hk: int, dh: int, *,
                    causal: bool, window: int = 0, q_offset: int = 0,
                    itemsize: int = 2, lse: bool = False) -> Cost:
    """#10 (and #11 with `lse`): two products of B·H·Dh a visible pair; q
    and o (H heads) once, k and v (Hk) at the visible keys once; #11 also
    writes the float32 lse."""
    pairs = visible_pairs(sq, skv, causal, window, q_offset)
    keys = visible_keys(sq, skv, causal, window, q_offset)
    byts = (2 * b * sq * h + 2 * b * keys * hk) * dh * itemsize
    if lse:
        byts += b * h * sq * 4
    return Cost(bytes=byts, flops=4.0 * b * h * dh * pairs,
                rate="bf16" if itemsize == 2 else "f32")


def flash_attention_fwd(b: int, sq: int, skv: int, h: int, hk: int, dh: int,
                        *, causal: bool, window: int = 0, q_offset: int = 0,
                        itemsize: int = 2) -> Cost:
    """#11: #10's work plus the lse."""
    return flash_attention(b, sq, skv, h, hk, dh, causal=causal,
                           window=window, q_offset=q_offset,
                           itemsize=itemsize, lse=True)


def flash_attention_bwd(b: int, sq: int, skv: int, h: int, hk: int, dh: int,
                        *, causal: bool, window: int = 0, q_offset: int = 0,
                        itemsize: int = 2) -> Cost:
    """#12: five products of B·H·Dh a visible pair (S recomputed, dP, dV,
    dQ, dK); q, o, dO in and dq out (H heads), k, v in at the visible keys
    and dk, dv out whole (Hk), the lse."""
    pairs = visible_pairs(sq, skv, causal, window, q_offset)
    keys = visible_keys(sq, skv, causal, window, q_offset)
    return Cost(bytes=((4 * b * sq * h + 2 * b * (keys + skv) * hk) * dh
                       * itemsize + b * h * sq * 4),
                flops=10.0 * b * h * dh * pairs,
                rate="bf16" if itemsize == 2 else "f32")
