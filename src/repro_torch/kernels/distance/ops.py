"""Exact squared-L2 kernels and their plain versions: `gather_l2` (bulk
"chunked" loads), `gather_l2_tiled` (one row at a time) and `pairwise_l2`
(every query-row pair).

`gather_l2` replaces `gather_l2_chunked_pallas` (`repro/kernels/distance/
distance_kernel.py:130`) together with its wrapper's XLA gather
(`repro/kernels/distance/ops.py:74`): the kernel reads the candidate rows
itself, so no (Q, K, D) candidate buffer is ever built. `gather_l2_tiled`
replaces `gather_l2_tiled_pallas` (`distance_kernel.py:90`), the paper's
latency-exposed "tiled" load strategy, with the same function:

    out[q, k] = max(|q|^2 - 2 q.c + |c|^2, 0),  c = table[ids[q, k]]
              = +inf where ids[q, k] < 0

`pairwise_l2` replaces `pairwise_l2_pallas` (`distance_kernel.py:58`):
out[q, c] = max(|q|^2 - 2 q.x_c + |x_c|^2, 0) over all pairs, inputs cast
to float32 as the JAX wrapper casts them. Its kernel takes the products on
the tensor cores, exactly: each operand splits into three bf16 parts
(`bf16_parts`), and a block takes, a k-chunk at a time, only the products
of parts that its tile's values need (`pairwise_tensor_flops` counts
them). The kernels mask ragged Q, C and D themselves: nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import pairwise_l2_squared
from repro_torch.kernels import build
from repro_torch.roofline import kernel_costs
from repro_torch.roofline import op_analyzer as _oa

_INF = float("inf")
# pairwise_l2's block tile (queries and rows) and k-chunk (dims), the
# granularity of its vote on the parts a chunk needs
PAIRWISE_TILE = 128
PAIRWISE_CHUNK = 32
# the kernel's grid holds the row tiles in its y dimension (at most 65,535)
PAIRWISE_MAX_ROWS = 65535 * PAIRWISE_TILE
FLOAT_INPUTS = (torch.float32, torch.bfloat16, torch.float16)
STRATEGIES = ("chunked", "tiled")


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


def _gather_launch(kernel: str, q: torch.Tensor, table: torch.Tensor,
                   sqnorm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Check the operands of a gather kernel and launch it (`kernel` is
    the library and the prefix of its `<kernel>_launch` entry point)."""
    dev = build.device_of(kernel, q, table, sqnorm, ids)
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
        raise ValueError(f"{kernel} needs a non-empty table")
    fn = build.entry(kernel, f"{kernel}_launch",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    err = build.call(fn, dev, build.ptr(q), build.ptr(ids),
                     build.ptr(table), build.ptr(sqnorm), build.ptr(out), qn,
                     k, d, n)
    build.check(err, kernel)
    return out


def _gather_cost(out, q, table, sqnorm, ids, *, fake):
    """#2/#8's work on these operands: the valid ids' rows."""
    n_q, k = ids.shape
    n_valid = ids.numel() if fake else float((ids >= 0).sum())
    return kernel_costs.gather_l2(n_q, k, table.shape[1], n_valid=n_valid)


def _gather_out(q, table, sqnorm, ids):
    return torch.empty(ids.shape, dtype=torch.float32, device=ids.device)


def _device_of(t: torch.Tensor, kernel: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return t.device


def gather_l2(q: torch.Tensor, table: torch.Tensor, sqnorm: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 queries, (N, D) f32 table, (N,) f32 squared norms, (Q, K)
    int32 ids -> (Q, K) f32 squared L2, +inf for ids < 0 (ids past the
    table clamp to its last row).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel("gather_l2", gather_l2, _gather_cost,
                                 _gather_out, q, table, sqnorm, ids)
    if _device_of(ids, "gather_l2").type == "cpu":
        return gather_l2_plain(q, table, sqnorm, ids)
    out = _gather_launch("gather_l2", q, table, sqnorm, ids)
    gather_l2.launches += 1
    return out


gather_l2.launches = 0


def gather_l2_tiled(q: torch.Tensor, table: torch.Tensor,
                    sqnorm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`gather_l2`'s function and operands through the "tiled" kernel: one
    candidate row in flight per query at a time, in 4-byte loads. Its
    plain version is `gather_l2_plain`.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel("gather_l2_tiled", gather_l2_tiled,
                                 _gather_cost, _gather_out, q, table, sqnorm,
                                 ids)
    if _device_of(ids, "gather_l2_tiled").type == "cpu":
        return gather_l2_plain(q, table, sqnorm, ids)
    out = _gather_launch("gather_l2_tiled", q, table, sqnorm, ids)
    gather_l2_tiled.launches += 1
    return out


gather_l2_tiled.launches = 0


def pairwise_l2_plain(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device), JAX's `pairwise_l2_ref`: float32,
    |q|^2 - 2 q @ x.T + |x|^2 clamped at 0."""
    return pairwise_l2_squared(q, x)


def bf16_parts(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """float32 v -> its three bf16 parts, as float32 tensors, the way the
    kernels split it (`csrc/bf16_split.cuh`): each remainder rounded to
    nearest even, so v = h0 + h1 + h2 exactly."""
    v = v.to(torch.float32)
    h0 = v.to(torch.bfloat16).float()
    r1 = v - h0
    h1 = r1.to(torch.bfloat16).float()
    return h0, h1, (r1 - h1).to(torch.bfloat16).float()


def chunk_votes(v: torch.Tensor) -> torch.Tensor:
    """(N, D) operand -> (N tiles of PAIRWISE_TILE rows, D chunks of
    PAIRWISE_CHUNK dims) bool: True where the tile's chunk holds a value
    that is not a bf16 value, so `pairwise_l2`'s block takes its parts h1
    and h2 there (its vote). At least one chunk, as the kernel."""
    n, d = v.shape
    rest = v.to(torch.float32) != bf16_parts(v)[0]
    tiles = -(-n // PAIRWISE_TILE)
    chunks = max(1, -(-d // PAIRWISE_CHUNK))
    rest = torch.nn.functional.pad(
        rest, (0, chunks * PAIRWISE_CHUNK - d, 0, tiles * PAIRWISE_TILE - n))
    return rest.reshape(tiles, PAIRWISE_TILE, chunks,
                        PAIRWISE_CHUNK).any(3).any(1)


def pairwise_tensor_flops(q: torch.Tensor, x: torch.Tensor) -> float:
    """The tensor-core flops `pairwise_l2` takes on these operands: 2 per
    multiply-add of each product of parts it takes, over the true rows
    and dims. A tile pair's chunk takes h0.h0 alone, three products when
    one operand's tile votes for its parts, six when both do (those with
    i + j <= 2)."""
    vq, vx = chunk_votes(q).cpu(), chunk_votes(x).cpu()
    rq, rx = _tile_rows(q.shape[0]), _tile_rows(x.shape[0])
    aq, ax = float(rq.sum()), float(rx.sum())
    d = q.shape[1]
    total = 0.0
    for kc in range(-(-d // PAIRWISE_CHUNK)):
        dims = min(PAIRWISE_CHUNK, d - kc * PAIRWISE_CHUNK)
        pq, px = float(rq[vq[:, kc]].sum()), float(rx[vx[:, kc]].sum())
        # products a pair: 1 + 2 [q votes] + 2 [x votes] + [both]
        total += 2.0 * dims * (aq * ax + 2 * pq * ax + 2 * aq * px + pq * px)
    return total


def _tile_rows(n: int) -> torch.Tensor:
    """The true rows of each tile of PAIRWISE_TILE over n rows."""
    rows = torch.full((-(-n // PAIRWISE_TILE),), float(PAIRWISE_TILE),
                      dtype=torch.float64)
    if n:
        rows[-1] = n - (rows.shape[0] - 1) * PAIRWISE_TILE
    return rows


def check_pairwise_rows(cn: int) -> None:
    """The tables `pairwise_l2`'s kernel takes: at most PAIRWISE_MAX_ROWS
    rows a call (its grid's row tiles). Raises ValueError naming the
    limit."""
    if cn > PAIRWISE_MAX_ROWS:
        raise ValueError(f"pairwise_l2 takes at most {PAIRWISE_MAX_ROWS} "
                         f"rows per call, got {cn}")


def pairwise_occupancy() -> dict:
    """`pairwise_l2`'s kernel on the card: its registers a thread, resident
    blocks an SM (the CUDA occupancy API), shared bytes a block and local
    (spilled) bytes a thread."""
    fn = build.entry("pairwise_l2", "pairwise_l2_occupancy",
                     [ctypes.c_void_p])
    info = (ctypes.c_int * 4)()
    build.check(fn(ctypes.cast(info, ctypes.c_void_p)),
                "pairwise_l2 occupancy")
    return dict(zip(("registers", "blocks_per_sm", "smem_per_block",
                     "local_bytes"), info))


def _pairwise_cost(out, q, x, *, fake):
    """#7's work: the products of parts its votes take on these operands
    (on fake operands, all six products of every chunk)."""
    (n_q, d), c = q.shape, x.shape[0]
    flops = 12.0 * n_q * c * d if fake else pairwise_tensor_flops(q, x)
    return kernel_costs.pairwise_l2(n_q, c, d, tensor_flops=flops)


def _pairwise_out(q, x):
    return torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32,
                       device=q.device)


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D) queries x (C, D) rows -> (Q, C) f32 squared L2. float32,
    bfloat16 or float16 inputs, computed in float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel("pairwise_l2", pairwise_l2, _pairwise_cost,
                                 _pairwise_out, q, x)
    dev = _device_of(q, "pairwise_l2")
    if dev.type == "cpu":
        return pairwise_l2_plain(q, x)
    for t, name in ((q, "q"), (x, "x")):
        if t.dtype not in FLOAT_INPUTS:
            raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                             f"{FLOAT_INPUTS}")
    build.device_of("pairwise_l2", q, x)
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    build.require(q, "q", torch.float32, 2, dev)
    build.require(x, "x", torch.float32, 2, dev)
    qn, d = q.shape
    cn = x.shape[0]
    if x.shape[1] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)}")
    check_pairwise_rows(cn)
    out = torch.empty((qn, cn), dtype=torch.float32, device=dev)
    if qn == 0 or cn == 0:
        return out
    fn = build.entry("pairwise_l2", "pairwise_l2_launch",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    err = build.call(fn, dev, build.ptr(q), build.ptr(x), build.ptr(out),
                     qn, cn, d)
    build.check(err, "pairwise_l2")
    pairwise_l2.launches += 1
    return out


pairwise_l2.launches = 0


def make_kernel_scorer(vectors: torch.Tensor, queries: torch.Tensor,
                       n_valid: int, vec_sqnorm: torch.Tensor | None = None,
                       *, strategy: str = "chunked",
                       tombstone_bits: torch.Tensor | None = None,
                       labels: torch.Tensor | None = None,
                       filter_bytes: torch.Tensor | None = None):
    """Beam-search ScoreFn backed by a gather kernel (drop-in for
    `core.beam_search.make_exact_scorer`): `strategy="chunked"` scores
    through `gather_l2`, `"tiled"` through `gather_l2_tiled` (JAX's
    `make_kernel_scorer` argument; any other value raises). Out-of-range,
    tombstoned (exclude mode) and out-of-filter (exclude mode) ids become
    -1 before the kernel, which writes +inf for them: the scorer is
    self-masking."""
    from repro_torch.core.mutations import bitmap_gather, label_match_gather

    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got "
                         f"{strategy!r}")
    fn = gather_l2 if strategy == "chunked" else gather_l2_tiled

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
        return fn(q, v, vec_sqnorm, masked.to(torch.int32).contiguous())

    score.self_masking = True
    return score
