"""The fused search kernels: CUDA `fused_search` (the whole-search
megakernel) and `fused_hop` (one hop per launch), their plain versions,
and `fused_beam_search`, the entry `core_search` routes to when
`spec.fusion` is "megakernel" or "hop".

`fused_search` replaces `fused_search_pallas` (`repro/kernels/search_step/
search_step_kernel.py:352`): one launch runs the whole greedy beam search,
one warp per query, frontier in shared memory throughout; only the final
(Q, L) frontier, the hop counts and (with telemetry) the counters go to
device memory. `fused_hop` replaces `fused_hop_pallas` (`:309`): the
same hop body (`csrc/search_step.cu` `hop`) once per launch, the frontier
loaded from and stored to device memory around it. The plain versions are
the oracle (`ref.search_loop`, `ref.fused_hop_ref`) over the same operands.

`fused_beam_search` prepares the operands, runs the kernels (or, for CPU
tensors, the plain versions) and finishes through the shared
`finalize_frontier` epilogue, like every search path.

`n_valid` (and the graph's medoid) may be a 0-d int32 device tensor, and
the exclude-mode filter value a uint8[4] device tensor: the kernels then
read them through pointers, so a search captured in a CUDA graph follows
their current values (core/plans.py).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.beam_search import (
    BeamSearchResult,
    SearchTelemetry,
    expand_schedule,
    finalize_frontier,
    make_exact_scorer,
    make_rabitq_scorer,
)
from repro_torch.core.rabitq import RaBitQCodes, RaBitQQuery
from repro_torch.core.vamana import VamanaGraph
from repro_torch.kernels import build
from repro_torch.kernels.rabitq_dot.ops import filter_word
from repro_torch.kernels.search_step.ref import (
    fused_hop_ref,
    init_frontier,
    search_loop,
)
from repro_torch.roofline import kernel_costs
from repro_torch.roofline import op_analyzer as _oa

_INF = float("inf")

# csrc/search_step.cu: kQueriesPerBlock query slots share a block's
# shared memory, of which an H100 block has at most SMEM_PER_BLOCK bytes;
# a slot stages up to STAGE_BYTES of candidate rows at once
QUERIES_PER_BLOCK = 4
SMEM_PER_BLOCK = 232_448
STAGE_BYTES = 5120


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def query_smem_bytes(l_width: int, r: int, row_bytes: int,
                     codes_per_unit: int) -> int:
    """Shared bytes of one query slot of the fused kernels (`layout` and
    `set_rows` in `csrc/search_step.cu`) for rows of `row_bytes` bytes,
    whose 16-byte units hold `codes_per_unit` codes (128 / bits packed, 4
    floats exact): the query padded to whole units (f32, or three bf16
    parts when 4-bit rows of whole 64-byte groups go to the tensor cores),
    two (L,) frontier buffers of ids, dists and visited bits, the
    candidates' ids and compacted positions (R each), the sort keys (a
    power of two >= R, 8 B each), the stage (rows as many as fit in
    STAGE_BYTES up to R, at least one, at a stride of an odd count of
    units on the SIMT path) with two metadata floats a row, and 32 B of
    counters; each part rounded up to 16 B."""
    units = -(-row_bytes // 16)
    mma = codes_per_unit == 32 and units % 4 == 0
    stride = 16 * (units if mma or units % 2 else units + 1)
    fit = STAGE_BYTES // stride
    rows = 1 if fit < 1 else min(fit, r)
    return (_align16((6 if mma else 4) * units * codes_per_unit)
            + 6 * _align16(4 * l_width) + 2 * _align16(4 * r)
            + _align16(8 * _pow2(r)) + rows * stride + 2 * _align16(4 * rows)
            + 32)


def check_fused_shape(l_width: int, r: int, row_bytes: int,
                      codes_per_unit: int) -> None:
    """The shapes the fused kernels take: L >= 1, R >= 1, and a block of
    QUERIES_PER_BLOCK query slots (`query_smem_bytes`) within
    SMEM_PER_BLOCK bytes of shared memory. Raises ValueError naming the
    limit; both wrappers call it before they launch."""
    if l_width < 1 or r < 1:
        raise ValueError(f"fused search: L and R must be >= 1, got L={l_width}"
                         f", R={r}")
    need = QUERIES_PER_BLOCK * query_smem_bytes(l_width, r, row_bytes,
                                                codes_per_unit)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused search: L={l_width}, R={r} and rows of {row_bytes} B need "
            f"{need} bytes of shared memory a block ({QUERIES_PER_BLOCK} "
            f"queries of {need // QUERIES_PER_BLOCK}); the limit is "
            f"{SMEM_PER_BLOCK}")


def occupancy(*, hop: bool, quantized: bool, bits: int, l_width: int,
              r: int, dq: int, row_width: int, tomb: bool = False,
              labels: bool = False, telemetry: bool = False) -> dict:
    """One instance of the fused kernels on the card: its registers a
    thread, resident queries per SM (the CUDA occupancy API), shared bytes
    a block, local (spilled) bytes a thread and queries a block, at
    (L, R, Dq) and a row of `row_width` bytes (quantized) or floats."""
    fn = build.entry("search_step", "fused_search_occupancy",
                     [ctypes.c_int] * 10 + [ctypes.c_void_p])
    info = (ctypes.c_int * 5)()
    build.check(fn(int(hop), int(quantized), int(bits), int(tomb),
                   int(labels), int(telemetry), l_width, r, dq, row_width,
                   ctypes.cast(info, ctypes.c_void_p)), "fused_search_occupancy")
    return dict(zip(("registers", "queries_per_sm", "smem_per_block",
                     "local_bytes", "queries_per_block"), info))


def _operand_scorer(q, qa, qb, data, meta0, meta1, n_valid, *, quantized,
                    bits):
    """The plain scorer over the kernel's operands (estimator or exact L2,
    clamped at 0), as the unfused loop scores."""
    if quantized:
        return make_rabitq_scorer(
            RaBitQCodes(packed=data, data_add=meta0, data_rescale=meta1,
                        bits=bits, dims=q.shape[1]),
            RaBitQQuery(q_rot=q, query_add=qa, query_sumq=qb))
    return make_exact_scorer(data, q, n_valid, vec_sqnorm=meta0,
                             query_sqnorm=qa)


def _check_operands(what, f_ids, f_dists, f_vis, q, qa, qb, adjacency, data,
                    meta0, meta1, tomb, labels, fb, *, quantized: bool,
                    bits: int):
    """The argument checks `fused_search` and `fused_hop` share: device,
    dtype, rank, contiguity, agreeing shapes and `check_fused_shape`.
    Returns (Q, L, R, cap, Dq, row width, filter word)."""
    dev = build.device_of(what, f_ids, f_dists, f_vis, q, qa, qb, adjacency,
                          data, meta0, meta1, tomb, labels)
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {dev}")
    qn, l_width = f_ids.shape
    cap, r = adjacency.shape
    checks = [(f_ids, "f_ids", torch.int32, 2),
              (f_dists, "f_dists", torch.float32, 2),
              (f_vis, "f_vis", torch.int32, 2),
              (q, "q", torch.float32, 2), (qa, "qa", torch.float32, 1),
              (qb, "qb", torch.float32, 1),
              (adjacency, "adjacency", torch.int32, 2),
              (meta0, "meta0", torch.float32, 1)]
    if quantized:
        if bits not in (1, 2, 4, 8):
            raise ValueError(f"bits must be 1, 2, 4 or 8, got {bits}")
        checks += [(data, "data", torch.uint8, 2),
                   (meta1, "meta1", torch.float32, 1)]
        row_width = data.shape[1]
        dq = row_width * (8 // bits)
    else:
        checks += [(data, "data", torch.float32, 2)]
        row_width = dq = data.shape[1]
    if tomb is not None:
        checks.append((tomb, "tomb", torch.uint8, 1))
    if labels is not None:
        checks.append((labels, "labels", torch.uint8, 2))
    for t, name, dt, nd in checks:
        build.require(t, name, dt, nd, dev)
    if (f_dists.shape != (qn, l_width) or f_vis.shape != (qn, l_width)
            or q.shape != (qn, dq)
            or qa.shape[0] != qn or qb.shape[0] != qn
            or data.shape[0] != cap or meta0.shape[0] != cap
            or (meta1 is not None and meta1.shape[0] != cap)):
        raise ValueError(f"{what}: operand shapes disagree")
    if tomb is not None and tomb.shape[0] * 8 < cap:
        raise ValueError("tombstone bitmap shorter than the table")
    fbw, fb_dev = 0, None
    if labels is not None:
        if labels.shape != (cap, 4) or labels.data_ptr() % 4:
            raise ValueError("labels must be a 4-byte aligned (cap, 4) plane")
        if (isinstance(fb, torch.Tensor) and fb.device == dev
                and fb.dtype == torch.uint8 and fb.numel() == 4
                and fb.is_contiguous() and fb.data_ptr() % 4 == 0):
            fb_dev = fb      # the kernels read the word through a pointer
        else:
            fbw = filter_word(fb)
    check_fused_shape(l_width, r, row_width * (1 if quantized else 4),
                      128 // bits if quantized else 4)
    return qn, l_width, r, cap, dq, row_width, fbw, fb_dev


def _n_valid_operand(n_valid, dev) -> tuple[int, torch.Tensor | None]:
    """(value, device pointer tensor) of `n_valid`: an int goes by value, a
    0-d int32 tensor on the kernel's device through its pointer."""
    if isinstance(n_valid, torch.Tensor):
        if (n_valid.device != dev or n_valid.dtype != torch.int32
                or n_valid.numel() != 1):
            raise ValueError("n_valid must be an int or a 0-d int32 tensor "
                             f"on {dev}")
        return 0, n_valid
    return int(n_valid), None


_SEARCH_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2          # frontier, Q, L
    + [ctypes.c_void_p, ctypes.c_int]                   # sched, iters
    + [ctypes.c_void_p, ctypes.c_int]                   # q, dq
    + [ctypes.c_void_p] * 3                             # qa, qb, adj
    + [ctypes.c_int] * 3                                # R, cap, nvalid
    + [ctypes.c_void_p, ctypes.c_int]                   # data, width
    + [ctypes.c_void_p] * 4 + [ctypes.c_uint32]         # meta, masks
    + [ctypes.c_void_p] * 2                             # nvalid, fb ptrs
    + [ctypes.c_int] * 3                                # q, bits, tel
    + [ctypes.c_void_p] * 6)                            # outs, stream
_HOP_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3          # frontier, Q, L, width
    + [ctypes.c_void_p, ctypes.c_int]                   # q, dq
    + [ctypes.c_void_p] * 3                             # qa, qb, adj
    + [ctypes.c_int] * 3                                # R, cap, nvalid
    + [ctypes.c_void_p, ctypes.c_int]                   # data, width
    + [ctypes.c_void_p] * 4 + [ctypes.c_uint32]         # meta, masks
    + [ctypes.c_void_p] * 2                             # nvalid, fb ptrs
    + [ctypes.c_int] * 3                                # q, bits, tel
    + [ctypes.c_void_p] * 6)                            # outs, stream


def fused_search_plain(f_ids, f_dists, f_vis, schedule, q, qa, qb,
                       adjacency, data, meta0, meta1, tomb, labels, fb,
                       n_valid: int, *, quantized: bool, bits: int,
                       max_iters: int, telemetry: bool = False):
    """Plain PyTorch version of `fused_search` (any device): the oracle
    loop over the same operands. Same arguments and outputs."""
    score = _operand_scorer(q, qa, qb, data, meta0, meta1, n_valid,
                            quantized=quantized, bits=bits)
    sched = [int(w) for w in schedule.tolist()]
    ids, dists, hops, tel = search_loop(
        f_ids, f_dists, f_vis.to(torch.bool), score_fn=score,
        adjacency=adjacency, n_valid=n_valid, schedule=sched,
        max_iters=max_iters, tombstone_bits=tomb, labels=labels,
        filter_bytes=fb, telemetry=telemetry)
    if telemetry:
        counters = torch.stack(tel[:3], dim=1)
        return ids, dists, hops, counters, tel[3]
    return ids, dists, hops


def _row_bytes(data, quantized: bool) -> tuple[int, int]:
    """(row bytes, metadata bytes) of a scored candidate: a packed code
    row and two floats, or a stored row and its squared norm."""
    if quantized:
        return data.shape[1], 8
    return data.shape[1] * data.element_size(), 4


def _search_cost(out, f_ids, f_dists, f_vis, schedule, q, qa, qb, adjacency,
                 data, meta0, meta1, tomb, labels, fb, n_valid, *,
                 quantized, bits, max_iters, telemetry, fake):
    """#1's work from the walk: its hops (the hop counts it returns;
    max_iters a query on fake operands) and its scored candidates (the
    telemetry's counter; without telemetry, or on fake operands, all R
    neighbours of every hop)."""
    qn, beam = f_ids.shape
    r = adjacency.shape[1]
    hops = qn * max_iters if fake else float(out[2].sum())
    scored = (float(out[3][:, 0].sum()) if telemetry and not fake
              else hops * r)
    return kernel_costs.fused_search(qn, beam, r, *_row_bytes(data,
                                                              quantized),
                                     q.shape[1], hops=hops, scored=scored)


def _search_out(f_ids, f_dists, f_vis, schedule, q, qa, qb, adjacency, data,
                meta0, meta1, tomb, labels, fb, n_valid, *, quantized, bits,
                max_iters, telemetry):
    qn, beam = f_ids.shape
    out = (torch.empty_like(f_ids), torch.empty_like(f_dists),
           torch.empty((qn,), dtype=torch.int32, device=f_ids.device))
    if telemetry:
        out += (torch.empty((qn, 3), dtype=torch.int32, device=f_ids.device),
                torch.empty((qn, max_iters), dtype=torch.int32,
                            device=f_ids.device))
    return out


def _hop_cost(out, f_ids, f_dists, f_vis, width, q, qa, qb, adjacency, data,
              meta0, meta1, tomb, labels, fb, n_valid, *, quantized, bits,
              telemetry, fake):
    """#4's work: the rows that expanded (every row on fake operands) and
    their scored candidates (the telemetry's, else all R neighbours)."""
    qn, beam = f_ids.shape
    r = adjacency.shape[1]
    active = qn if fake else float(out[3].sum())
    scored = (float(out[4][:, 0].sum()) if telemetry and not fake
              else active * r)
    return kernel_costs.fused_hop(qn, beam, r, *_row_bytes(data, quantized),
                                  q.shape[1], active=active, scored=scored)


def _hop_out(f_ids, f_dists, f_vis, width, q, qa, qb, adjacency, data, meta0,
             meta1, tomb, labels, fb, n_valid, *, quantized, bits, telemetry):
    qn = f_ids.shape[0]
    out = (torch.empty_like(f_ids), torch.empty_like(f_dists),
           torch.empty_like(f_ids),
           torch.empty((qn,), dtype=torch.int32, device=f_ids.device))
    if telemetry:
        out += (torch.empty((qn, 4), dtype=torch.int32, device=f_ids.device),)
    return out


def fused_search(f_ids, f_dists, f_vis, schedule, q, qa, qb, adjacency,
                 data, meta0, meta1, tomb, labels, fb, n_valid: int, *,
                 quantized: bool, bits: int, max_iters: int,
                 telemetry: bool = False):
    """The megakernel: whole search, one launch.

    f_ids/f_dists/f_vis: (Q, L) int32/f32/int32 initial frontier (sorted);
    schedule: (max_iters,) int32 per-hop widths; q: (Q, Dq) f32 (rotated
    query zero-padded to P*8/bits dims when quantized, else the query);
    qa/qb: (Q,) f32 (query_add/query_sumq, or |q|^2 and unused);
    adjacency: (cap, R) int32; data: (cap, P) uint8 packed codes or
    (cap, D) f32 rows; meta0/meta1: (cap,) f32 data_add/data_rescale, or
    squared norms and None; tomb: exclude-mode tombstone bitmap or None;
    labels/fb: exclude-mode label plane (cap, 4) uint8 + uint8[4] mask, or
    None; n_valid: an int or a 0-d int32 tensor on the same device.
    Returns (ids (Q, L), dists (Q, L), n_hops (Q,)) — plus
    (counters (Q, 3) [scored, masked, dups], occupancy (Q, max_iters))
    with telemetry. CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel(
            "fused_search", fused_search, _search_cost, _search_out, f_ids,
            f_dists, f_vis, schedule, q, qa, qb, adjacency, data, meta0,
            meta1, tomb, labels, fb, n_valid, quantized=quantized, bits=bits,
            max_iters=max_iters, telemetry=telemetry)
    dev = f_ids.device
    if dev.type == "cpu":
        return fused_search_plain(
            f_ids, f_dists, f_vis, schedule, q, qa, qb, adjacency, data,
            meta0, meta1, tomb, labels, fb, n_valid, quantized=quantized,
            bits=bits, max_iters=max_iters, telemetry=telemetry)
    qn, l_width, r, cap, dq, row_width, fbw, fb_dev = _check_operands(
        "fused_search", f_ids, f_dists, f_vis, q, qa, qb, adjacency, data,
        meta0, meta1, tomb, labels, fb, quantized=quantized, bits=bits)
    nv, nv_dev = _n_valid_operand(n_valid, dev)
    build.require(schedule, "schedule", torch.int32, 1, dev)
    if schedule.shape[0] < max_iters:
        raise ValueError("fused_search: operand shapes disagree")
    out_ids = torch.empty((qn, l_width), dtype=torch.int32, device=dev)
    out_dists = torch.empty((qn, l_width), dtype=torch.float32, device=dev)
    out_hops = torch.empty((qn,), dtype=torch.int32, device=dev)
    counters = occ = None
    if telemetry:
        counters = torch.empty((qn, 3), dtype=torch.int32, device=dev)
        occ = torch.empty((qn, max_iters), dtype=torch.int32, device=dev)
    if qn > 0:
        fn = build.entry("search_step", "fused_search_launch",
                         _SEARCH_ARGTYPES)
        err = build.call(fn, dev, build.ptr(f_ids), build.ptr(f_dists),
                         build.ptr(f_vis), qn, l_width, build.ptr(schedule),
                         max_iters, build.ptr(q), dq, build.ptr(qa),
                         build.ptr(qb), build.ptr(adjacency), r, cap, nv,
                         build.ptr(data), row_width, build.ptr(meta0),
                         build.ptr(meta1), build.ptr(tomb),
                         build.ptr(labels), fbw, build.ptr(nv_dev),
                         build.ptr(fb_dev), int(quantized), int(bits),
                         int(telemetry), build.ptr(out_ids),
                         build.ptr(out_dists), build.ptr(out_hops),
                         build.ptr(counters), build.ptr(occ))
        build.check(err, "fused_search")
        fused_search.launches += 1
    if telemetry:
        return out_ids, out_dists, out_hops, counters, occ
    return out_ids, out_dists, out_hops


fused_search.launches = 0


def fused_hop_plain(f_ids, f_dists, f_vis, width: int, q, qa, qb, adjacency,
                    data, meta0, meta1, tomb, labels, fb, n_valid: int, *,
                    quantized: bool, bits: int, telemetry: bool = False):
    """Plain PyTorch version of `fused_hop` (any device): the oracle's one
    hop (`ref.fused_hop_ref`) over the same operands. Same arguments and
    outputs."""
    score = _operand_scorer(q, qa, qb, data, meta0, meta1, n_valid,
                            quantized=quantized, bits=bits)
    out = fused_hop_ref(f_ids, f_dists, f_vis.to(torch.bool), score_fn=score,
                        adjacency=adjacency, n_valid=n_valid, width=width,
                        tombstone_bits=tomb, labels=labels, filter_bytes=fb,
                        telemetry=telemetry)
    ids, dists, vis, picked = out[:4]
    res = (ids, dists, vis.to(torch.int32), picked.to(torch.int32))
    if telemetry:
        return res + (torch.stack(out[4], dim=1),)
    return res


def fused_hop(f_ids, f_dists, f_vis, width: int, q, qa, qb, adjacency, data,
              meta0, meta1, tomb, labels, fb, n_valid: int, *,
              quantized: bool, bits: int, telemetry: bool = False):
    """One hop of the fused search for every query, one launch.

    Operands as `fused_search`, with the hop's frontier `width` in place
    of the schedule; the frontier must be sorted by distance, as every
    frontier `fused_operands` or an earlier hop makes is (the kernel's
    merge relies on it; the plain version does not). Returns (ids, dists, visited (Q, L) int32, increment
    (Q,) int32: 1 where the row expanded a node) — plus a (Q, 4) int32
    [scored, masked, dups, occupancy] block with telemetry. A row with no
    unvisited slot comes back unchanged with increment 0. CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel(
            "fused_hop", fused_hop, _hop_cost, _hop_out, f_ids, f_dists,
            f_vis, width, q, qa, qb, adjacency, data, meta0, meta1, tomb,
            labels, fb, n_valid, quantized=quantized, bits=bits,
            telemetry=telemetry)
    dev = f_ids.device
    if dev.type == "cpu":
        return fused_hop_plain(
            f_ids, f_dists, f_vis, width, q, qa, qb, adjacency, data, meta0,
            meta1, tomb, labels, fb, n_valid, quantized=quantized, bits=bits,
            telemetry=telemetry)
    qn, l_width, r, cap, dq, row_width, fbw, fb_dev = _check_operands(
        "fused_hop", f_ids, f_dists, f_vis, q, qa, qb, adjacency, data,
        meta0, meta1, tomb, labels, fb, quantized=quantized, bits=bits)
    nv, nv_dev = _n_valid_operand(n_valid, dev)
    if width < 0:
        raise ValueError(f"width must be >= 0, got {width}")
    out_ids = torch.empty((qn, l_width), dtype=torch.int32, device=dev)
    out_dists = torch.empty((qn, l_width), dtype=torch.float32, device=dev)
    out_vis = torch.empty((qn, l_width), dtype=torch.int32, device=dev)
    out_inc = torch.empty((qn,), dtype=torch.int32, device=dev)
    counters = (torch.empty((qn, 4), dtype=torch.int32, device=dev)
                if telemetry else None)
    if qn > 0:
        fn = build.entry("search_step", "fused_hop_launch", _HOP_ARGTYPES)
        err = build.call(fn, dev, build.ptr(f_ids), build.ptr(f_dists),
                         build.ptr(f_vis), qn, l_width, int(width),
                         build.ptr(q), dq, build.ptr(qa), build.ptr(qb),
                         build.ptr(adjacency), r, cap, nv, build.ptr(data),
                         row_width, build.ptr(meta0), build.ptr(meta1),
                         build.ptr(tomb), build.ptr(labels), fbw,
                         build.ptr(nv_dev), build.ptr(fb_dev),
                         int(quantized), int(bits), int(telemetry),
                         build.ptr(out_ids), build.ptr(out_dists),
                         build.ptr(out_vis), build.ptr(out_inc),
                         build.ptr(counters))
        build.check(err, "fused_hop")
        fused_hop.launches += 1
    if telemetry:
        return out_ids, out_dists, out_vis, out_inc, counters
    return out_ids, out_dists, out_vis, out_inc


fused_hop.launches = 0


def _entry_ids(medoid, num_q: int, dev) -> torch.Tensor:
    """(Q, 1) int32 of the entry point: a host int, or a 0-d device tensor
    (read on the device, so a captured search follows its value)."""
    if isinstance(medoid, torch.Tensor):
        return medoid.to(device=dev, dtype=torch.int32).reshape(1, 1).expand(
            num_q, 1).contiguous()
    return torch.full((num_q, 1), medoid, dtype=torch.int32, device=dev)


_SCHEDULES: dict = {}


def _schedule_tensor(schedule: tuple, dev) -> torch.Tensor:
    """The per-hop widths as an int32 tensor on `dev`, made once a
    schedule and card and never written: a search captured in a CUDA
    graph reads it without a host-to-device copy inside the capture. On
    the CPU (no capture) it is made anew, so a dry run's fake tensor is
    never kept."""
    if torch.device(dev).type != "cuda":
        return torch.tensor(schedule, dtype=torch.int32, device=dev)
    key = (schedule, str(dev))
    t = _SCHEDULES.get(key)
    if t is None:
        t = _SCHEDULES[key] = torch.tensor(schedule, dtype=torch.int32,
                                           device=dev)
    return t


def fused_operands(graph: VamanaGraph, *, beam_width: int, max_iters: int,
                   beam_schedule: tuple | None = None,
                   queries: torch.Tensor | None = None,
                   vectors: torch.Tensor | None = None,
                   vec_sqnorm: torch.Tensor | None = None,
                   codes: RaBitQCodes | None = None,
                   rq_query: RaBitQQuery | None = None,
                   tombstone_bits: torch.Tensor | None = None,
                   traverse_deleted: bool = True,
                   labels: torch.Tensor | None = None,
                   filter_bytes: torch.Tensor | None = None,
                   filter_exclude: bool = False) -> dict:
    """The keyword arguments of `fused_search` for one search: the initial
    frontier (medoid in slot 0, scored with the plain scorer as the
    unfused loop scores it), the per-hop schedule, the query operands and
    the table operands. Quantized when `codes` is given, else exact."""
    quantized = codes is not None
    adj = graph.adjacency
    dev = adj.device
    if quantized:
        num_q = rq_query.q_rot.shape[0]
        init_ids = _entry_ids(graph.medoid, num_q, dev)
        d0 = make_rabitq_scorer(codes, rq_query)(init_ids)
        bits = codes.bits
        d_need = codes.packed.shape[1] * (8 // bits)
        q = rq_query.q_rot.to(torch.float32)
        if q.shape[1] < d_need:   # unpacked padding dims x zero q = inert
            q = torch.nn.functional.pad(q, (0, d_need - q.shape[1]))
        qa = rq_query.query_add.to(torch.float32)
        qb = rq_query.query_sumq.to(torch.float32)
        data, meta0, meta1 = codes.packed, codes.data_add, codes.data_rescale
    else:
        num_q = queries.shape[0]
        init_ids = _entry_ids(graph.medoid, num_q, dev)
        d0 = make_exact_scorer(vectors, queries, graph.n_valid,
                               vec_sqnorm)(init_ids)
        bits = 0
        q = queries.to(torch.float32)
        qa = (q * q).sum(dim=-1)
        qb = torch.zeros_like(qa)
        data, meta0, meta1 = vectors, vec_sqnorm, None

    # exclude-mode liveness / label filter ride the kernel epilogue;
    # traverse mode filters only the final frontier (shared epilogue)
    tomb = (tombstone_bits if tombstone_bits is not None
            and not traverse_deleted else None)
    use_filt = labels is not None and filter_exclude

    f_ids, f_dists, f_vis = init_frontier(graph.medoid, d0, num_q,
                                          beam_width)
    sched = _schedule_tensor(expand_schedule(beam_schedule, beam_width,
                                             max_iters), dev)
    return dict(f_ids=f_ids, f_dists=f_dists, f_vis=f_vis.to(torch.int32),
                schedule=sched,
                q=q.contiguous(), qa=qa.contiguous(), qb=qb.contiguous(),
                adjacency=adj, data=data, meta0=meta0, meta1=meta1,
                tomb=tomb, labels=labels if use_filt else None,
                fb=filter_bytes if use_filt else None, n_valid=graph.n_valid,
                quantized=quantized, bits=bits, max_iters=max_iters)


def hop_operands(ops: dict) -> tuple[tuple, dict]:
    """Split `fused_operands`' dict into the (f_ids, f_dists, f_vis)
    frontier and the keyword operands `fused_hop` takes beside it."""
    skip = ("f_ids", "f_dists", "f_vis", "schedule", "max_iters")
    return ((ops["f_ids"], ops["f_dists"], ops["f_vis"]),
            {k: v for k, v in ops.items() if k not in skip})


def hop_loop(ops: dict, schedule: tuple, *, telemetry: bool = False):
    """The hop-mode search from `fused_operands`' initial frontier: a host
    loop that launches one `fused_hop` per iteration while any row has an
    unvisited slot, up to `max_iters`, adding each hop's increments and
    counters and writing its occupancy column at hop t.

    Each iteration's `any()` is a device-to-host sync, by design (the
    JAX version's `while_loop` condition): a search of h loop iterations
    makes h + 1 syncs, or h when it stops at max_iters. Returns (f_ids,
    f_dists, n_hops, telemetry (scored, masked, dups, occ_log) or None),
    unfinalized, like `ref.search_loop`."""
    (f_ids, f_dists, f_vis), hop_ops = hop_operands(ops)
    max_iters = ops["max_iters"]
    q, dev = f_ids.shape[0], f_ids.device
    hops = torch.zeros((q,), dtype=torch.int32, device=dev)
    if telemetry:
        counts = torch.zeros((q, 3), dtype=torch.int32, device=dev)
        occ_log = torch.zeros((q, max_iters), dtype=torch.int32, device=dev)
    for it in range(max_iters):
        if not bool(((f_ids >= 0) & (f_vis == 0)).any()):
            break
        out = fused_hop(f_ids, f_dists, f_vis, schedule[it], **hop_ops,
                        telemetry=telemetry)
        f_ids, f_dists, f_vis, inc = out[:4]
        hops += inc
        if telemetry:
            counts += out[4][:, :3]
            occ_log[:, it] = out[4][:, 3]
    tel = ((counts[:, 0], counts[:, 1], counts[:, 2], occ_log)
           if telemetry else None)
    return f_ids, f_dists, hops, tel


def fused_beam_search(graph: VamanaGraph, *, mode: str, beam_width: int,
                      max_iters: int, beam_schedule: tuple | None = None,
                      queries: torch.Tensor | None = None,
                      vectors: torch.Tensor | None = None,
                      vec_sqnorm: torch.Tensor | None = None,
                      codes: RaBitQCodes | None = None,
                      rq_query: RaBitQQuery | None = None,
                      tombstone_bits: torch.Tensor | None = None,
                      traverse_deleted: bool = True,
                      labels: torch.Tensor | None = None,
                      filter_bytes: torch.Tensor | None = None,
                      filter_exclude: bool = False,
                      telemetry: bool = False) -> BeamSearchResult:
    """Fused greedy beam search — exact (vectors) or quantized (codes).

    mode: "megakernel" (one `fused_search` launch, frontier on-chip
    throughout) or "hop" (`hop_loop`: one `fused_hop` launch per hop,
    host-side convergence check). Both run the same hop body, so they
    return the same frontier, hops and telemetry. Returns the standard
    `BeamSearchResult`; visited logs are not kept by the fused paths and
    come back as -1/+inf fills.
    """
    if mode not in ("hop", "megakernel"):
        raise ValueError(f"mode must be 'hop' or 'megakernel', got {mode!r}")
    ops = fused_operands(
        graph, beam_width=beam_width, max_iters=max_iters,
        beam_schedule=beam_schedule, queries=queries, vectors=vectors,
        vec_sqnorm=vec_sqnorm, codes=codes, rq_query=rq_query,
        tombstone_bits=tombstone_bits, traverse_deleted=traverse_deleted,
        labels=labels, filter_bytes=filter_bytes,
        filter_exclude=filter_exclude)
    tel = None
    if mode == "megakernel":
        out = fused_search(**ops, telemetry=telemetry)
        f_ids, f_dists, hops = out[:3]
        if telemetry:
            counters, occ_log = out[3:]
            tel = SearchTelemetry(counters[:, 0], counters[:, 1],
                                  counters[:, 2], occ_log)
    else:
        f_ids, f_dists, hops, t = hop_loop(
            ops, expand_schedule(beam_schedule, beam_width, max_iters),
            telemetry=telemetry)
        if telemetry:
            tel = SearchTelemetry(*t)
    f_ids, f_dists = finalize_frontier(f_ids, f_dists, tombstone_bits,
                                       labels=labels,
                                       filter_bytes=filter_bytes)
    num_q, dev = f_ids.shape[0], f_ids.device
    return BeamSearchResult(
        frontier_ids=f_ids, frontier_dists=f_dists,
        visited_ids=torch.full((num_q, max_iters), -1, dtype=torch.int32,
                               device=dev),
        visited_dists=torch.full((num_q, max_iters), _INF,
                                 dtype=torch.float32, device=dev),
        n_hops=hops, telemetry=tel)
