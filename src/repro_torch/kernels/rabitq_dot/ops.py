"""RaBitQ estimator kernels and their plain versions: `rabitq_search_step`
(one hop's candidates, masks fused), `rabitq_gather_distance` (pre-gathered
candidates, no mask) and `rabitq_distance` (every query-row pair).

Replaces `rabitq_search_step_pallas` (`repro/kernels/rabitq_dot/
rabitq_kernel.py:131`) together with the packed-row gather of
`make_rabitq_kernel_scorer` (`repro/kernels/rabitq_dot/ops.py:152-169`):
given raw beam ids, the kernel reads each candidate's packed code row,
metadata, tombstone bit and label row itself, unpacks, takes the
estimator and masks:

    out[q, k] = max(add + qa + rescale * (<codes, q_rot> - qsum), 0)
              = +inf where id < 0, id >= n_valid, tombstoned, or (with a
                filter) the row's labels miss the filter mask

`rabitq_gather_distance` replaces `rabitq_gather_distance_pallas`
(`rabitq_kernel.py:97`): the same estimator over a contiguous (Q, K, P)
buffer of already gathered code rows, with no mask. `rabitq_distance`
replaces `rabitq_distance_pallas` (`rabitq_kernel.py:172`): the estimator
over all (query, row) pairs of a (C, P) packed table, a full scan. Their
plain versions follow `rabitq_distance_ref` (`repro/kernels/rabitq_dot/
ref.py:13`): unpack to the first D codes (D = q_rot's width), a product,
the epilogue.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.mutations import bitmap_gather, label_match_gather
from repro_torch.core.rabitq import RaBitQCodes, RaBitQQuery, unpack_codes
from repro_torch.kernels import build
from repro_torch.roofline import kernel_costs
from repro_torch.roofline import op_analyzer as _oa

_INF = float("inf")
BITS = (1, 2, 4, 8)
# rows per call of the all-pairs kernel (within its grid's y dimension of
# at most 65,535 tiles of 256 rows)
DISTANCE_MAX_ROWS = 65535 * 128
# `rabitq_search_step`'s shared slot of one query, a warp (`slot_of` in
# csrc/rabitq_search_step.cu): a block holds up to STEP_WARPS_PER_BLOCK
SMEM_PER_BLOCK = 232_448
STEP_WARPS_PER_BLOCK = 4
STEP_STAGE_BYTES = 16384
STEP_MAX_ROWS = 128
# `rabitq_gather_distance`'s shared slot of one warp (`gather_slot_of` in
# csrc/rabitq_distance.cu): a block holds up to GATHER_WARPS_PER_BLOCK
GATHER_WARPS_PER_BLOCK = 4
GATHER_STAGE_BYTES = 16384
GATHER_MAX_ROWS = 128


def _align16(n: int) -> int:
    return (n + 15) & ~15


def step_smem_bytes(k: int, p: int, bits: int) -> int:
    """Shared bytes of one query's slot of `rabitq_search_step` at K
    candidates and P-byte rows: the query (P * 8/bits floats) when a row
    has more than 32 units (32-bit words, or bytes when P is not a multiple
    of 4; shorter rows keep it in registers), the rows a
    round stages (as many of K as fit in STEP_STAGE_BYTES at a stride of
    whole 16-byte units, at least one, at most STEP_MAX_ROWS), and their
    ids and dots (4 B each), rounded up to 16 B."""
    stride = _align16(p)
    rows = min(k, max(1, min(STEP_MAX_ROWS, STEP_STAGE_BYTES // stride)))
    units = p // 4 if p % 4 == 0 else p
    q_bytes = _align16(p * (8 // bits) * 4) if units > 32 else 0
    return _align16(q_bytes + rows * stride + rows * 8)


def check_step_shape(k: int, p: int, bits: int) -> None:
    """The shapes `rabitq_search_step`'s kernel takes: one query's slot
    (`step_smem_bytes`) within SMEM_PER_BLOCK bytes of shared memory (a
    block then holds as many as fit, at most STEP_WARPS_PER_BLOCK). Raises
    ValueError naming the limit."""
    need = step_smem_bytes(k, p, bits)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"rabitq_search_step: K={k} and rows of {p} B at {bits} bits "
            f"need {need} bytes of shared memory for one query; the limit is "
            f"{SMEM_PER_BLOCK}")


def gather_smem_bytes(k: int, p: int, bits: int) -> int:
    """Shared bytes of one warp's slot of `rabitq_gather_distance` at K
    candidates and P-byte rows: two buffers (one item staged while the
    other scores), each the query (P * 8/bits floats) and an item's rows
    back to back (as many of K as fit in GATHER_STAGE_BYTES, at least one,
    at most GATHER_MAX_ROWS), then the item's dots (4 B each), each part
    rounded up to 16 B."""
    rows = min(k, max(1, min(GATHER_MAX_ROWS,
                             GATHER_STAGE_BYTES // max(p, 1))))
    buf = _align16(p * (8 // bits) * 4) + _align16(rows * p)
    return 2 * buf + _align16(rows * 4)


def gather_warps_per_block(k: int, p: int, bits: int) -> int:
    """Warps a block of `rabitq_gather_distance` at (K, P, bits): as many
    slots as fit in SMEM_PER_BLOCK, at most GATHER_WARPS_PER_BLOCK."""
    return min(GATHER_WARPS_PER_BLOCK,
               SMEM_PER_BLOCK // gather_smem_bytes(k, p, bits))


def check_gather_shape(k: int, p: int, bits: int) -> None:
    """The shapes `rabitq_gather_distance`'s kernel takes: one warp's slot
    (`gather_smem_bytes`) within SMEM_PER_BLOCK bytes of shared memory (a
    block then holds `gather_warps_per_block`). Raises ValueError naming
    the limit."""
    need = gather_smem_bytes(k, p, bits)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"rabitq_gather_distance: K={k} and rows of {p} B at {bits} bits"
            f" need {need} bytes of shared memory for one warp; the limit "
            f"is {SMEM_PER_BLOCK}")


# the C entry point of each estimator kernel's occupancy, and whether it
# takes (K, P) after the bits
_OCCUPANCY = {"rabitq_distance": ("rabitq_distance", False),
              "rabitq_search_step": ("rabitq_search_step", True),
              "rabitq_gather_distance": ("rabitq_distance", True)}


def occupancy(kernel: str, *, bits: int, p: int, k: int = 64) -> dict:
    """One instance of an estimator kernel on the card, "rabitq_distance"
    (#6), or "rabitq_search_step" (#3, no masks) or
    "rabitq_gather_distance" (#5), both at K and P-byte rows: its registers
    a thread, resident blocks an SM (the CUDA occupancy API), shared bytes
    a block and local (spilled) bytes a thread; #3 and #5 also their warps
    (queries) a block."""
    library, shaped = _OCCUPANCY[kernel]
    symbol = f"{kernel}_occupancy"
    if shaped:
        fn = build.entry(library, symbol,
                         [ctypes.c_int] * 3 + [ctypes.c_void_p])
        info = (ctypes.c_int * 5)()
        err = fn(bits, k, p, ctypes.cast(info, ctypes.c_void_p))
    else:
        fn = build.entry(library, symbol, [ctypes.c_int, ctypes.c_void_p])
        info = (ctypes.c_int * 4)()
        err = fn(bits, ctypes.cast(info, ctypes.c_void_p))
    build.check(err, f"{kernel} occupancy")
    return dict(zip(("registers", "blocks_per_sm", "smem_per_block",
                     "local_bytes", "warps_per_block"), info))


def filter_word(filter_bytes: torch.Tensor) -> int:
    """uint8[4] filter byte mask -> the little-endian uint32 the kernels
    AND against a row's 4 label bytes read as one word."""
    fb = [int(b) for b in filter_bytes.to("cpu").reshape(-1).tolist()]
    if len(fb) != 4:
        raise ValueError(f"filter mask must have 4 bytes, got {len(fb)}")
    return fb[0] | (fb[1] << 8) | (fb[2] << 16) | (fb[3] << 24)


def _check_bits(bits: int) -> None:
    if bits not in BITS:
        raise ValueError(f"bits must be 1, 2, 4 or 8, got {bits}")


def _estimate(dot, add, rescale, query_add, query_sumq):
    """The estimator epilogue, in the reference's association order."""
    est = add + query_add[:, None] + rescale * (dot - query_sumq[:, None])
    return torch.clamp(est, min=0.0)


def _query_operands(q_rot, query_add, query_sumq, dev, width):
    """float32 query operands, checked: q_rot (Q, D) with D <= width (the
    packed row's code count), query_add / query_sumq (Q,)."""
    q = q_rot.to(torch.float32).contiguous()
    for t, name, nd in ((q, "q_rot", 2), (query_add, "query_add", 1),
                        (query_sumq, "query_sumq", 1)):
        build.require(t, name, torch.float32, nd, dev)
    qn, d = q.shape
    if d > width or query_add.shape != (qn,) or query_sumq.shape != (qn,):
        raise ValueError(f"query operands q_rot {tuple(q.shape)}, "
                         f"query_add {tuple(query_add.shape)}, query_sumq "
                         f"{tuple(query_sumq.shape)} do not fit packed rows "
                         f"of {width} codes")
    return q


def rabitq_distance_plain(packed: torch.Tensor, data_add: torch.Tensor,
                          data_rescale: torch.Tensor, q_rot: torch.Tensor,
                          query_add: torch.Tensor, query_sumq: torch.Tensor,
                          *, bits: int) -> torch.Tensor:
    """Plain PyTorch version (any device), JAX's `rabitq_distance_ref`:
    unpack the first D codes of each row, one product, the epilogue."""
    q = q_rot.to(torch.float32)
    codes = unpack_codes(packed, bits, q.shape[1]).to(torch.float32)
    return _estimate(q @ codes.T, data_add[None, :], data_rescale[None, :],
                     query_add, query_sumq)


def _distance_cost(out, packed, data_add, data_rescale, q_rot, query_add,
                   query_sumq, *, bits, fake):
    return kernel_costs.rabitq_distance(q_rot.shape[0], packed.shape[0],
                                        packed.shape[1], q_rot.shape[1])


def _distance_out(packed, data_add, data_rescale, q_rot, query_add,
                  query_sumq, *, bits):
    return torch.empty((q_rot.shape[0], packed.shape[0]),
                       dtype=torch.float32, device=packed.device)


def rabitq_distance(packed: torch.Tensor, data_add: torch.Tensor,
                    data_rescale: torch.Tensor, q_rot: torch.Tensor,
                    query_add: torch.Tensor, query_sumq: torch.Tensor, *,
                    bits: int) -> torch.Tensor:
    """(C, P) uint8 packed codes, (C,) f32 metadata, (Q, D) rotated queries
    (D <= P * 8/bits), (Q,) f32 query scalars -> (Q, C) f32 estimates.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel(
            "rabitq_distance", rabitq_distance, _distance_cost,
            _distance_out, packed, data_add, data_rescale, q_rot, query_add,
            query_sumq, bits=bits)
    dev = packed.device
    if dev.type == "cpu":
        return rabitq_distance_plain(packed, data_add, data_rescale, q_rot,
                                     query_add, query_sumq, bits=bits)
    if dev.type != "cuda":
        raise ValueError(
            f"rabitq_distance runs on cuda or cpu tensors, got {dev}")
    build.device_of("rabitq_distance", packed, data_add, data_rescale, q_rot,
                    query_add, query_sumq)
    _check_bits(bits)
    build.require(packed, "packed", torch.uint8, 2, dev)
    cn, p = packed.shape
    for t, name in ((data_add, "data_add"), (data_rescale, "data_rescale")):
        build.require(t, name, torch.float32, 1, dev)
        if t.shape != (cn,):
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"packed {tuple(packed.shape)}")
    q = _query_operands(q_rot, query_add, query_sumq, dev, p * (8 // bits))
    qn, d = q.shape
    if cn > DISTANCE_MAX_ROWS:
        raise ValueError(f"rabitq_distance takes at most {DISTANCE_MAX_ROWS}"
                         f" rows per call, got {cn}")
    out = torch.empty((qn, cn), dtype=torch.float32, device=dev)
    if qn == 0 or cn == 0:
        return out
    fn = build.entry("rabitq_distance", "rabitq_distance_launch",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    err = build.call(fn, dev, build.ptr(packed), build.ptr(data_add),
                     build.ptr(data_rescale), build.ptr(q),
                     build.ptr(query_add), build.ptr(query_sumq),
                     build.ptr(out), qn, cn, p, d, bits)
    build.check(err, "rabitq_distance")
    rabitq_distance.launches += 1
    return out


rabitq_distance.launches = 0


def rabitq_gather_distance_plain(cand_packed: torch.Tensor,
                                 cand_add: torch.Tensor,
                                 cand_rescale: torch.Tensor,
                                 q_rot: torch.Tensor, query_add: torch.Tensor,
                                 query_sumq: torch.Tensor, *, bits: int
                                 ) -> torch.Tensor:
    """Plain PyTorch version (any device): unpack the first D codes of each
    candidate, a batched dot, the epilogue."""
    q = q_rot.to(torch.float32)
    codes = unpack_codes(cand_packed, bits, q.shape[1]).to(torch.float32)
    return _estimate(torch.einsum("qkd,qd->qk", codes, q), cand_add,
                     cand_rescale, query_add, query_sumq)


def _gather_cost(out, cand_packed, cand_add, cand_rescale, q_rot, query_add,
                 query_sumq, *, bits, fake):
    qn, k, p = cand_packed.shape
    return kernel_costs.rabitq_gather_distance(qn, k, p, q_rot.shape[1])


def _gather_out(cand_packed, cand_add, cand_rescale, q_rot, query_add,
                query_sumq, *, bits):
    return torch.empty(cand_packed.shape[:2], dtype=torch.float32,
                       device=cand_packed.device)


def rabitq_gather_distance(cand_packed: torch.Tensor, cand_add: torch.Tensor,
                           cand_rescale: torch.Tensor, q_rot: torch.Tensor,
                           query_add: torch.Tensor, query_sumq: torch.Tensor,
                           *, bits: int) -> torch.Tensor:
    """(Q, K, P) uint8 gathered code rows, (Q, K) f32 metadata, (Q, D)
    rotated queries (D <= P * 8/bits), (Q,) f32 query scalars -> (Q, K) f32
    estimates, unmasked.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel(
            "rabitq_gather_distance", rabitq_gather_distance, _gather_cost,
            _gather_out, cand_packed, cand_add, cand_rescale, q_rot,
            query_add, query_sumq, bits=bits)
    dev = cand_packed.device
    if dev.type == "cpu":
        return rabitq_gather_distance_plain(
            cand_packed, cand_add, cand_rescale, q_rot, query_add,
            query_sumq, bits=bits)
    if dev.type != "cuda":
        raise ValueError(
            f"rabitq_gather_distance runs on cuda or cpu tensors, got {dev}")
    build.device_of("rabitq_gather_distance", cand_packed, cand_add,
                    cand_rescale, q_rot, query_add, query_sumq)
    _check_bits(bits)
    build.require(cand_packed, "cand_packed", torch.uint8, 3, dev)
    qn, k, p = cand_packed.shape
    for t, name in ((cand_add, "cand_add"), (cand_rescale, "cand_rescale")):
        build.require(t, name, torch.float32, 2, dev)
        if t.shape != (qn, k):
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"cand_packed {tuple(cand_packed.shape)}")
    q = _query_operands(q_rot, query_add, query_sumq, dev, p * (8 // bits))
    if q.shape[0] != qn:
        raise ValueError(f"q_rot {tuple(q.shape)} does not match "
                         f"cand_packed {tuple(cand_packed.shape)}")
    check_gather_shape(k, p, bits)
    out = torch.empty((qn, k), dtype=torch.float32, device=dev)
    if qn == 0 or k == 0:
        return out
    fn = build.entry("rabitq_distance", "rabitq_gather_distance_launch",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int]
                     + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    err = build.call(fn, dev, build.ptr(cand_packed), build.ptr(cand_add),
                     build.ptr(cand_rescale), build.ptr(q), q.shape[1],
                     build.ptr(query_add), build.ptr(query_sumq),
                     build.ptr(out), qn, k, p, bits)
    build.check(err, "rabitq_gather_distance")
    rabitq_gather_distance.launches += 1
    return out


rabitq_gather_distance.launches = 0


def rabitq_search_step_plain(ids: torch.Tensor, packed: torch.Tensor,
                             data_add: torch.Tensor,
                             data_rescale: torch.Tensor, n_valid: int,
                             q_rot: torch.Tensor, query_add: torch.Tensor,
                             query_sumq: torch.Tensor, *, bits: int,
                             tombstone_bits: torch.Tensor | None = None,
                             labels: torch.Tensor | None = None,
                             filter_bytes: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain PyTorch version (any device): gather packed rows, unpack,
    estimator, mask."""
    safe = torch.clamp(ids.long(), min=0)
    dims = q_rot.shape[1]
    codes = unpack_codes(packed[safe], bits, dims).to(torch.float32)
    dot = torch.einsum("qkd,qd->qk", codes, q_rot.to(torch.float32))
    est = _estimate(dot, data_add[safe], data_rescale[safe], query_add,
                    query_sumq)
    valid = (ids >= 0) & (ids < n_valid)
    if tombstone_bits is not None:
        valid &= ~bitmap_gather(tombstone_bits, safe)
    if labels is not None:
        valid &= label_match_gather(labels, filter_bytes, safe)
    return torch.where(valid, est, torch.full_like(est, _INF))


def _step_cost(out, ids, packed, data_add, data_rescale, n_valid, q_rot,
               query_add, query_sumq, *, bits, fake, **filters):
    """#3's work: the code row of each in-range (finite) id."""
    qn, k = ids.shape
    p = packed.shape[1]
    valid = ids.numel() if fake else float(torch.isfinite(out).sum())
    return kernel_costs.rabitq_search_step(qn, k, p, p * (8 // bits),
                                           q_rot.shape[1], n_valid=valid)


def _step_out(ids, packed, data_add, data_rescale, n_valid, q_rot,
              query_add, query_sumq, *, bits, **filters):
    return torch.empty(ids.shape, dtype=torch.float32, device=ids.device)


def rabitq_search_step(ids: torch.Tensor, packed: torch.Tensor,
                       data_add: torch.Tensor, data_rescale: torch.Tensor,
                       n_valid: int, q_rot: torch.Tensor,
                       query_add: torch.Tensor, query_sumq: torch.Tensor, *,
                       bits: int, tombstone_bits: torch.Tensor | None = None,
                       labels: torch.Tensor | None = None,
                       filter_bytes: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """(Q, K) int32 raw beam ids over an (N, P) uint8 packed table ->
    (Q, K) f32 masked estimates. q_rot is (Q, D) with D <= P * 8/bits
    (padding dims read as zero). CUDA tensors launch the kernel (or
    raise); CPU tensors take the plain version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel(
            "rabitq_search_step", rabitq_search_step, _step_cost, _step_out,
            ids, packed, data_add, data_rescale, n_valid, q_rot, query_add,
            query_sumq, bits=bits, tombstone_bits=tombstone_bits,
            labels=labels, filter_bytes=filter_bytes)
    dev = ids.device
    if dev.type == "cpu":
        return rabitq_search_step_plain(
            ids, packed, data_add, data_rescale, n_valid, q_rot, query_add,
            query_sumq, bits=bits, tombstone_bits=tombstone_bits,
            labels=labels, filter_bytes=filter_bytes)
    if dev.type != "cuda":
        raise ValueError(
            f"rabitq_search_step runs on cuda or cpu tensors, got {dev}")
    build.device_of("rabitq_search_step", ids, packed, data_add,
                    data_rescale, q_rot, query_add, query_sumq,
                    tombstone_bits, labels)
    _check_bits(bits)
    qn, k = ids.shape
    n, p = packed.shape
    check_step_shape(k, p, bits)
    d_need = p * (8 // bits)
    if q_rot.shape[0] != qn or q_rot.shape[1] > d_need:
        raise ValueError(f"q_rot {tuple(q_rot.shape)} does not fit ids "
                         f"{tuple(ids.shape)} / packed width {p}")
    q = q_rot.to(torch.float32)
    if q.shape[1] < d_need:   # unpacked padding dims x zero q = inert
        q = torch.nn.functional.pad(q, (0, d_need - q.shape[1]))
    q = q.contiguous()
    for t, name, dt, nd in ((ids, "ids", torch.int32, 2),
                            (q, "q_rot", torch.float32, 2),
                            (packed, "packed", torch.uint8, 2),
                            (data_add, "data_add", torch.float32, 1),
                            (data_rescale, "data_rescale", torch.float32, 1),
                            (query_add, "query_add", torch.float32, 1),
                            (query_sumq, "query_sumq", torch.float32, 1)):
        build.require(t, name, dt, nd, dev)
    if tombstone_bits is not None:
        build.require(tombstone_bits, "tombstone_bits", torch.uint8, 1, dev)
        if tombstone_bits.shape[0] * 8 < n:
            raise ValueError("tombstone bitmap shorter than the table")
    fb = 0
    if labels is not None:
        build.require(labels, "labels", torch.uint8, 2, dev)
        if labels.shape != (n, 4) or labels.data_ptr() % 4:
            raise ValueError("labels must be a 4-byte aligned (N, 4) plane")
        fb = filter_word(filter_bytes)
    out = torch.empty((qn, k), dtype=torch.float32, device=dev)
    if qn == 0 or k == 0:
        return out
    fn = build.entry("rabitq_search_step", "rabitq_search_step_launch",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p] * 2 + [ctypes.c_uint32]
                     + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p] * 2)
    err = build.call(fn, dev, build.ptr(ids), build.ptr(packed),
                     build.ptr(data_add), build.ptr(data_rescale), qn, k, p,
                     n, build.ptr(tombstone_bits), build.ptr(labels), fb,
                     build.ptr(q), build.ptr(query_add),
                     build.ptr(query_sumq), int(n_valid), bits,
                     build.ptr(out))
    build.check(err, "rabitq_search_step")
    rabitq_search_step.launches += 1
    return out


rabitq_search_step.launches = 0


def make_rabitq_kernel_scorer(codes: RaBitQCodes, query: RaBitQQuery, *,
                              n_valid: int,
                              tombstone_bits: torch.Tensor | None = None,
                              labels: torch.Tensor | None = None,
                              filter_bytes: torch.Tensor | None = None):
    """Beam-search ScoreFn over the canonical packed codes: one
    `rabitq_search_step` launch per call, masking in its epilogue (the
    scorer is self-masking). tombstone_bits / labels+filter_bytes: the
    exclude-mode liveness and label tests, read per candidate in-kernel."""
    q_rot = query.q_rot.to(torch.float32).contiguous()
    qa = query.query_add.to(torch.float32).contiguous()
    qs = query.query_sumq.to(torch.float32).contiguous()

    def score(ids: torch.Tensor) -> torch.Tensor:
        return rabitq_search_step(
            ids.to(torch.int32).contiguous(), codes.packed, codes.data_add,
            codes.data_rescale, n_valid, q_rot, qa, qs, bits=codes.bits,
            tombstone_bits=tombstone_bits, labels=labels,
            filter_bytes=filter_bytes)

    score.self_masking = True
    return score
