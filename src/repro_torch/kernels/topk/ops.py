"""Row-wise top-k (k smallest, ascending): the CUDA `topk` kernel and its
plain version.

Replaces `topk_pallas` (`repro/kernels/topk/topk_kernel.py:49`), the
unfused loop's `merge="kernel"` merge. Semantics are those of its oracle
`topk_ref` (`repro/kernels/topk/ref.py:11`): ascending, ties to the lower
position, every position taken once — so an all-+inf tail keeps its own
ids. (The Pallas kernel's min-extraction repeats an already-taken entry
into such a tail; ROADMAP queue C.)
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.roofline import kernel_costs
from repro_torch.roofline import op_analyzer as _oa

# one row of distances sits in a block's (default 48 KB) shared memory
MAX_COLUMNS = 12288
# rows up to this width run one warp a row (every merge of the search
# lanes: C = L + R); wider ones one block a row
WARP_MAX_COLUMNS = 256


def topk_plain(dists: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device): one stable sort per row."""
    sd, order = torch.sort(dists, dim=1, stable=True)
    return sd[:, :k].contiguous(), torch.gather(ids, 1, order[:, :k])


def _topk_cost(out, dists, ids, k, *, fake):
    return kernel_costs.topk(dists.shape[0], dists.shape[1], k)


def _topk_out(dists, ids, k):
    return (torch.empty((dists.shape[0], k), dtype=torch.float32,
                        device=dists.device),
            torch.empty((dists.shape[0], k), dtype=torch.int32,
                        device=dists.device))


def topk(dists: torch.Tensor, ids: torch.Tensor, k: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, C) f32 dists + (Q, C) int32 ids -> the k smallest per row,
    ascending: ((Q, k) f32, (Q, k) int32). CUDA tensors launch the kernel
    (or raise); CPU tensors take the plain version.

    The kernel's design follows the width, a dispatch on shape: rows of C
    <= WARP_MAX_COLUMNS run one warp a row (a bitonic sort of the row's
    (distance, position) pairs in the warp's registers), wider rows up to
    MAX_COLUMNS one block a row (stable ranks). Both give the one order
    of `topk_plain`."""
    if _oa.ACTIVE is not None:
        return _oa.ACTIVE.kernel("topk", topk, _topk_cost, _topk_out, dists,
                                 ids, k)
    dev = dists.device
    if dev.type == "cpu":
        return topk_plain(dists, ids, k)
    if dev.type != "cuda":
        raise ValueError(f"topk runs on cuda or cpu tensors, got {dev}")
    build.device_of("topk", dists, ids)
    build.require(dists, "dists", torch.float32, 2, dev)
    build.require(ids, "ids", torch.int32, 2, dev)
    qn, c = dists.shape
    if ids.shape != (qn, c):
        raise ValueError(f"ids {tuple(ids.shape)} do not match dists "
                         f"{tuple(dists.shape)}")
    if not 0 < k <= c:
        raise ValueError(f"k must be in [1, {c}], got {k}")
    if c > MAX_COLUMNS:
        raise ValueError(f"topk takes at most {MAX_COLUMNS} columns, got {c}")
    out_d = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    if qn == 0:
        return out_d, out_i
    fn = build.entry("topk", "topk_launch",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 3)
    err = build.call(fn, dev, build.ptr(dists), build.ptr(ids), qn, c, k,
                     build.ptr(out_d), build.ptr(out_i))
    build.check(err, "topk")
    topk.launches += 1
    return out_d, out_i


topk.launches = 0
