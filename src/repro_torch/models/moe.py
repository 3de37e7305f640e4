"""Top-k routed Mixture-of-Experts (PyTorch port of `repro.models.moe`;
granite-moe 32e/top-8, olmoe 64e/top-8).

Dispatch as the JAX package does it: tokens are scattered into
fixed-capacity per-expert buffers, at the route's rank among its
expert's routes (no dynamic shapes); routes past the capacity are
dropped (GShard-style). The
expert SwiGLU is then batched products over (C, E, cap, D) x (E, D, F).
`cfg.moe_dispatch_chunks` > 1 keeps chunk-local buffers, capacity
enforced per chunk, as in the JAX package.

Under a mesh (`sharding_rules` with a DeviceMesh installed, as the sharded
train step installs it) each rank runs its own rows (`rows_split()`: its
share of the batch over the data axes, or the whole batch), with the
expert weights gathered a block (`models/fsdp.py`), and the two modes of
the JAX package:
  * global dispatch (`moe_dispatch_chunks` >= 0; `_moe_global`): the
    single-device result over the global batch, as GSPMD partitions it.
    Capacity and keep come from the global chunk's token count; a route's
    position is its rank's local position plus the routes to the same
    (chunk, expert) on the earlier data ranks (an all-gather of the (C, E)
    counts; a rank's tokens are a contiguous run of the global order, so
    its pieces are whole chunks or a part of one). The rank's buffer holds
    only its own routes: min(cap, its tokens in the chunk) slots;
  * manual SPMD (-1; `_moe_slabs`, JAX's `_moe_shard_map`): a slab a
    device, each with its own capacity from its own token count, by JAX's
    shape rules (seq over "model" when it divides and S > 1, else batch
    over data + model when that divides, else no batch split where the
    batch does not split over data). Without a mesh -1 is one chunk, as
    in JAX.
On a model axis > 1 the tensor-parallel plan (`models/tensor_parallel.py`,
passed in as `tp`) splits the compute as JAX's rules do
(`src/repro/models/sharding_ctx.py:65`, `moe.py:121-132,206-214`):
  * global dispatch: the rank's rows enter as the MLP's column-parallel
    projection enters (the sequence gathered under SP), every model rank
    routes every token of them (the same bits through the same float32
    product, so the same routes), scatters only the routes to its E/tp
    experts ("expert" on "model") into an (E/tp, slots, D) buffer and
    leaves with the partial sums of their weighted outputs (reduce-scatter
    or all-reduce). JAX gives each (data, model) device whole chunks where
    `moe_dispatch_chunks` tiles data x model; the port keeps the expert
    split for every chunk count, which gives the same result;
  * manual SPMD: under SP the rank's slice of the residual is its slab;
    under `no_sp` it takes the slice (`split_seq`) and gathers the output
    back. Where the sequence does not split (decode's S = 1) the rows go
    over data + model where they divide, else every model rank repeats
    the slab, as JAX does; its gradient then counts a tp-th a rank.
The aux loss a rank returns under a mesh is its share: the shares of the
data ranks add up to the global aux (global dispatch: E · Σ_e f_e · Σ_local
p_e / T, from the global counts; manual SPMD: the mean over the slabs).
Under a plan each model rank takes its part of that share (its sequence
slice's p_e against the global f_e, or its slab's term of the mean), and
`reduce_from_region` sums the parts over "model": the value is whole on
every model rank, and the router's gradient, summed over "model", counts
it once.

Routing (`moe_routing`) is integer work that must equal the JAX
package's bit for bit:
  * top-k is a stable descending sort, so equal probabilities keep the
    lower expert first, as `lax.top_k` does (`torch.topk` promises no
    order among ties);
  * a route's position is the number of earlier routes of its chunk to
    the same expert — JAX's exclusive cumulative count over the (Tc*k, E)
    routing one-hot (float32, exact below 2**24 routes) — taken here from
    a stable sort of the routes by (chunk, expert), in int32, with no
    one-hot: the count's scan over (Tc*k, E) was most of an olmoe
    prefill on the card;
  * a dropped route is written to the extra row E of the buffer, which is
    discarded, so its duplicate (E, cap - 1) writes never reach an expert.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.layers import _frozen, _init_linear, dense_init
from repro_torch.models.sharding_ctx import (
    axis_sizes,
    current_mesh,
    data_rank,
    gather_over_data,
    rows_split,
)


class MoE(nn.Module):
    """router: an `nn.Linear` (E, D), stored float32 because routing
    reads it in float32; w_gate/w_up (E, D, F) and w_down (E, F, D): the
    JAX package's layout, in the parameter dtype."""

    def __init__(self, router: nn.Linear, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.router = router
        self.w_gate = _frozen(w_gate)
        self.w_up = _frozen(w_up)
        self.w_down = _frozen(w_down)


def moe_init(generator, cfg: ModelConfig,
             dtype: torch.dtype | None = None) -> MoE:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    dt = dtype or getattr(torch, cfg.dtype)
    return MoE(_init_linear(generator, cfg, d, e, torch.float32),
               dense_init(generator, (e, d, f), in_axis=1, dtype=dt),
               dense_init(generator, (e, d, f), in_axis=1, dtype=dt),
               dense_init(generator, (e, f, d), in_axis=1, dtype=dt))


def moe_spec(cfg: ModelConfig) -> dict:
    return {"router": ("embed", None), "w_gate": ("expert", "embed", None),
            "w_up": ("expert", "embed", None),
            "w_down": ("expert", None, "embed")}


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Buffer slots an expert takes for `tokens` routed tokens: the
    capacity factor's share rounded up to a multiple of 8, at least 8."""
    cap = int(cfg.capacity_factor * tokens * cfg.experts_per_token
              / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)


def moe_routing(logits: torch.Tensor, k: int, cap: int) -> dict:
    """Routing of float32 router logits (C, Tc, E): {"probs" (C, Tc, E),
    "top_p" (C, Tc, k) renormalised, "top_e" (C, Tc, k) int64, "pos" and
    "keep" (C, Tc*k): each route's slot in its expert's buffer (int32) and
    whether it is below the capacity, "counts" (C, E) int64: the routes
    to each expert}. Routes are ordered token-major, then by rank."""
    c, tc, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # a route's slot: its rank among its chunk's routes to its expert
    group = (top_e.reshape(c, tc * k)
             + e * torch.arange(c, device=logits.device)[:, None]).reshape(-1)
    order = torch.sort(group, stable=True).indices
    # the routes to each (chunk, expert), at a static (C·E,) shape (a
    # dry run's fake tensors cannot size bincount's data-dependent output)
    counts = torch.zeros(c * e, dtype=torch.int64, device=logits.device
                         ).index_add_(0, group, torch.ones_like(group))
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=logits.device)
    pos = (rank - start[group]).to(torch.int32).reshape(c, tc * k)
    return {"probs": probs, "top_p": top_p, "top_e": top_e, "pos": pos,
            "keep": pos < cap, "counts": counts.reshape(c, e)}


def moe(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); the aux loss discarded (serving)."""
    return moe_with_aux(params, x, cfg)[0]


def moe_with_aux(params: MoE, x: torch.Tensor, cfg: ModelConfig,
                 tp: "tpm.Plan | None" = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), the Switch load-balance loss
    E * mean over chunks of sum_e f_e * P_e, float32; under a mesh this
    rank's share of it, see the module note). Under a tensor-parallel
    plan `tp` x is the residual as the plan carries it (this rank's slice
    of the sequence under SP) and so is the output."""
    mesh = current_mesh()
    if mesh is not None and hasattr(mesh, "get_group"):
        if cfg.moe_dispatch_chunks == -1:
            return _moe_slabs(params, x, cfg, mesh, tp)
        return _moe_global(params, x, cfg, mesh, tp)
    b, s, d = x.shape
    t = b * s
    chunks = cfg.moe_dispatch_chunks
    if chunks <= 1 or t % chunks:
        chunks = 1
    out, aux = _chunked(params, x.reshape(chunks, t // chunks, d), cfg)
    return out.reshape(b, s, d), aux


def _chunked(params: MoE, xt: torch.Tensor, cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, Tc, D) chunks, each with its own capacity: (out (C, Tc, D),
    E * mean over chunks of sum_e f_e * P_e)."""
    c, tc, _ = xt.shape
    cap = capacity(cfg, tc)
    r = _route(params, xt, cfg, cap)
    f_e = r["counts"].float() / tc                            # (C, E)
    aux = cfg.num_experts * torch.mean(
        torch.sum(f_e * r["probs"].mean(1), dim=-1))
    return _experts(params, xt, r, r["pos"], r["keep"], cap), aux.float()


def _route(params: MoE, xt: torch.Tensor, cfg: ModelConfig, cap: int
           ) -> dict:
    logits = F.linear(xt.float(), params.router.weight.float())
    return moe_routing(logits, cfg.experts_per_token, cap)


def _experts(params: MoE, xt: torch.Tensor, r: dict, pos: torch.Tensor,
             keep: torch.Tensor, slots: int, first: int = 0) -> torch.Tensor:
    """The routes of (C, T, D) tokens through (C, E' + 1, slots, D)
    buffers at `pos` (each route's slot; dropped routes go to row E'),
    the batched expert SwiGLU and the weighted combine: (C, T, D).
    `params` holds E' experts, the global experts [first, first + E'):
    the routes to the others are dropped here too (a model rank's experts
    under global dispatch; every expert otherwise)."""
    chunks, t, d = xt.shape
    e = params.w_gate.shape[0]
    k = r["top_e"].shape[-1]
    dt = xt.dtype
    expert = r["top_e"].reshape(chunks, t * k) - first
    mine = keep & (expert >= 0) & (expert < e)
    expert = expert.clamp(0, e - 1)
    slot = torch.clamp(pos.long(), max=slots - 1)
    cidx = torch.arange(chunks, device=xt.device)[:, None].expand(-1, t * k)
    row = torch.where(mine, expert, e)                        # drop -> row E'
    src = torch.repeat_interleave(xt, k, dim=1)               # (C, T*k, D)
    buf = torch.zeros((chunks, e + 1, slots, d), dtype=dt, device=xt.device
                      ).index_put((cidx, row, slot), src)[:, :e]

    h = F.silu(torch.einsum("cend,edf->cenf", buf, params.w_gate.to(dt)))
    h = h * torch.einsum("cend,edf->cenf", buf, params.w_up.to(dt))
    out_buf = torch.einsum("cenf,efd->cend", h, params.w_down.to(dt))

    # gather back and combine; dropped routes contribute zero
    gathered = out_buf[cidx, expert, slot]
    gathered = torch.where(mine[..., None], gathered, 0)
    weights = r["top_p"].reshape(chunks, t * k).to(dt)
    return (gathered * weights[..., None]).reshape(chunks, t, k, d).sum(2)


def _own_tokens(b: int, s: int, tp: "tpm.Plan", device) -> torch.Tensor:
    """(B, S) float32: 1 at the tokens whose aux term this model rank
    takes, its slice of the sequence (all of them on rank 0 where the
    sequence does not split), else 0."""
    if s % tp.size:
        return torch.full((b, s), float(tp.rank == 0), device=device)
    start, n = tp.seq_slice(s)
    pos = torch.arange(s, device=device)
    return ((pos >= start) & (pos < start + n)).float().expand(b, s)


def _moe_global(params: MoE, x: torch.Tensor, cfg: ModelConfig, mesh,
                tp: "tpm.Plan | None" = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Global dispatch on this rank's rows: the single-device result over
    the global batch (see the module note); returns (out, aux share).
    Under a plan this rank's experts' part of it (see the module note)."""
    if tp is not None:
        # src/repro/models/moe.py:83: the tokens enter whole ("act_embed"
        # replicated), as the MLP's column-parallel projection enters
        x = tpm.enter_columns(x, tp)
    b, s, d = x.shape
    n, rank = data_rank(mesh)
    split = rows_split()
    if not split:           # every rank routes the whole batch
        n_all, n, rank = n, 1, 0
    t_all = b * s * n
    chunks = cfg.moe_dispatch_chunks
    if chunks <= 1 or t_all % chunks:
        chunks = 1
    tc = t_all // chunks
    cap = capacity(cfg, tc)
    if chunks % n == 0:     # whole chunks a rank
        pieces, t, per_chunk = chunks // n, tc, 1
    elif n % chunks == 0:   # a chunk over `per_chunk` ranks
        pieces, t, per_chunk = 1, b * s, n // chunks
    else:
        raise ValueError(f"{chunks} MoE dispatch chunks neither split over "
                         f"nor gather {n} data shards")
    xt = x.reshape(pieces, t, d)
    r = _route(params, xt, cfg, cap)
    local, counts, keep, slots = r["pos"], r["counts"], r["keep"], cap
    if per_chunk > 1:
        peers = gather_over_data(counts, mesh)                # (n, 1, E)
        first = rank - rank % per_chunk
        prefix = peers[first:rank].sum(0)                     # (1, E)
        counts = peers[first:first + per_chunk].sum(0)
        expert = r["top_e"].reshape(1, -1)
        r["pos"] = r["pos"] + torch.gather(prefix, 1, expert).to(
            r["pos"].dtype)
        keep = r["keep"] = r["pos"] < cap
        # the buffer holds this rank's routes only, at their local rank
        slots = min(cap, t)
    f_e = counts.float() / tc
    if tp is None:
        # this rank's share: its tokens' probabilities over the chunk's
        # tokens (factors of exactly 1 on one rank: the single-device
        # arithmetic)
        p_e = r["probs"].mean(1) * (t / tc)
    else:
        # this model rank's part of it: its own tokens' probabilities
        own = _own_tokens(b, s, tp, x.device).reshape(pieces, t, 1)
        p_e = (r["probs"] * own).sum(1) / tc
    aux = cfg.num_experts * torch.mean(torch.sum(f_e * p_e, dim=-1)) * (
        pieces / chunks)
    if not split:
        aux = aux / n_all
    if tp is None:
        out = _experts(params, xt, r, local, keep, slots)
        return out.reshape(b, s, d), aux.float()
    out = _experts(params, xt, r, local, keep, slots,
                   first=tp.rank * params.w_gate.shape[0])
    return (tpm.leave_rows(out.reshape(b, s, d), tp),
            tpm.reduce_from_region(aux.float(), tp))


def slab_shape(b: int, s: int, mesh) -> tuple[int, int]:
    """(rows, positions) of one device's token slab of a global (b, s)
    batch under JAX's `_moe_shard_map` shape rules
    (`src/repro/models/moe.py:208-214`)."""
    sizes = axis_sizes(mesh)
    n = data_rank(mesh)[0]
    model_n = sizes.get("model", 1)
    rows = b // n if b % n == 0 else b      # no batch split otherwise
    if "model" in sizes and s % model_n == 0 and s > 1:
        return rows, s // model_n
    if "model" in sizes and b % (n * model_n) == 0:
        return b // (n * model_n), s
    return rows, s


def _moe_slabs(params: MoE, x: torch.Tensor, cfg: ModelConfig, mesh,
               tp: "tpm.Plan | None" = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's `_moe_shard_map` on this rank's rows: each slab of them a
    chunk with its own capacity; returns (out, aux share: the mean over
    the slabs divided among the data shards). Without a plan the rank
    runs every slab of its rows; under one, its own (see the module
    note)."""
    b, s, d = x.shape
    n = data_rank(mesh)[0]
    if tp is None:
        bl, sl = slab_shape(b * n if rows_split() else b, s, mesh)
        out, aux = _slabs(params, x, cfg, bl, sl)
        return out, aux / n
    s_all = s * tp.size if tp.sp else s
    bl, sl = slab_shape(b * n if rows_split() else b, s_all, mesh)
    if sl < s_all:
        # the sequence over "model": the rank's slice is its slab
        xs = x if tp.sp else tpm.split_seq(x, tp)
        out, aux = _slabs(params, xs, cfg, bl, sl)
        if not tp.sp:
            out = tpm.gather_seq(out, tp, split_grad=True)
    elif bl * tp.size <= b:
        # the rows over data + model: this rank's block of its rows
        xs = tpm.split_seq(x.transpose(0, 1), tp).transpose(0, 1)
        out, aux = _slabs(params, xs, cfg, bl, sl)
        out = tpm.gather_seq(out.transpose(0, 1), tp,
                             split_grad=True).transpose(0, 1)
    else:
        # every model rank repeats the slabs (JAX's replicated slab): a
        # tp-th of the gradient a rank, summed over "model" by the
        # weights' mode and `copy_to_region`
        out, aux = _slabs(params, tpm.copy_to_region(x, tp), cfg, bl, sl)
        if out.requires_grad:
            out = out.detach() + (out - out.detach()) / tp.size
    return out, tpm.reduce_from_region(aux / (n * tp.size), tp)


def _slabs(params: MoE, x: torch.Tensor, cfg: ModelConfig, bl: int,
           sl: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) as (B/bl)·(S/sl) slabs of (bl, sl), each a chunk:
    (out (B, S, D), the mean of the slabs' aux)."""
    b, s, d = x.shape
    nb, ns = b // bl, s // sl
    slabs = x.reshape(nb, bl, ns, sl, d).transpose(1, 2).reshape(
        nb * ns, bl * sl, d)
    out, aux = _chunked(params, slabs, cfg)
    return out.reshape(nb, ns, bl, sl, d).transpose(1, 2).reshape(b, s, d), aux
