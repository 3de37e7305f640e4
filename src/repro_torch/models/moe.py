"""Top-k routed Mixture-of-Experts (PyTorch port of `repro.models.moe`;
granite-moe 32e/top-8, olmoe 64e/top-8).

Dispatch as the JAX package does it: tokens are scattered into
fixed-capacity per-expert buffers, at the route's rank among its
expert's routes (no dynamic shapes); routes past the capacity are
dropped (GShard-style). The
expert SwiGLU is then batched products over (C, E, cap, D) x (E, D, F).
`cfg.moe_dispatch_chunks` > 1 keeps chunk-local buffers, capacity
enforced per chunk, as in the JAX package. Its manual-SPMD mode
(`_moe_shard_map`, a mesh of devices) is not ported (ROADMAP.md A6).

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
from repro_torch.models.layers import _frozen, _init_linear, dense_init


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


def moe_with_aux(params: MoE, x: torch.Tensor, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), the Switch load-balance loss
    E * mean over chunks of sum_e f_e * P_e, float32)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    chunks = cfg.moe_dispatch_chunks
    if chunks <= 1 or t % chunks:
        chunks = 1
    tc = t // chunks
    cap = capacity(cfg, tc)
    dt = x.dtype

    xt = x.reshape(chunks, tc, d)
    r = moe_routing(F.linear(xt.float(), params.router.weight.float()), k,
                    cap)
    f_e = r["counts"].float() / tc                            # (C, E)
    aux = e * torch.mean(torch.sum(f_e * r["probs"].mean(1), dim=-1))

    expert = r["top_e"].reshape(chunks, tc * k)
    pos, keep = r["pos"].long(), r["keep"]
    slot = torch.clamp(pos, max=cap - 1)
    cidx = torch.arange(chunks, device=x.device)[:, None].expand(-1, tc * k)
    row = torch.where(keep, expert, e)                        # drop -> row E
    src = torch.repeat_interleave(xt, k, dim=1)               # (C, Tc*k, D)
    buf = torch.zeros((chunks, e + 1, cap, d), dtype=dt, device=x.device
                      ).index_put((cidx, row, slot), src)[:, :e]

    h = F.silu(torch.einsum("cend,edf->cenf", buf, params.w_gate.to(dt)))
    h = h * torch.einsum("cend,edf->cenf", buf, params.w_up.to(dt))
    out_buf = torch.einsum("cenf,efd->cend", h, params.w_down.to(dt))

    # gather back and combine; dropped routes contribute zero
    gathered = out_buf[cidx, expert, slot]
    gathered = torch.where(keep[..., None], gathered, 0)
    weights = r["top_p"].reshape(chunks, tc * k).to(dt)
    comb = (gathered * weights[..., None]).reshape(chunks, tc, k, d).sum(2)
    return comb.reshape(b, s, d), aux.float()
