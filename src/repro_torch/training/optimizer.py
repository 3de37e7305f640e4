"""AdamW + LR schedules (PyTorch port of `repro.training.optimizer`).

Schedules: cosine (default), WSD (warmup-stable-decay — MiniCPM's
schedule, arXiv:2404.06395), constant. All pure functions of the step, in
float32 arithmetic as the JAX package computes them, so restarts are
exact.

`adamw_update` is the JAX package's update written out: float32 moments,
global-norm clipping (the norm reported before clipping), bias
correction, decoupled weight decay on every leaf (norm scales included),
the update computed in float32 and cast to the parameter's dtype. It
updates the parameters, the moments and the gradients IN PLACE, one leaf
at a time, where the JAX package returns new trees: at full width a second
copy of the parameters and moments would not fit beside them.
`torch.optim.AdamW` is not this function (moments in the parameter's
dtype, clipping elsewhere).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    schedule: str = "cosine"          # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1           # WSD: final fraction spent decaying
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule_fn(cfg: OptimizerConfig, step: int) -> float:
    """The learning rate at `step`, computed in float32."""
    f32 = np.float32
    s = f32(step)
    warm = np.minimum(s / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    total = float(cfg.total_steps)
    if cfg.schedule == "cosine":
        frac = np.clip((s - f32(cfg.warmup_steps))
                       / f32(max(total - cfg.warmup_steps, 1)), 0.0, 1.0)
        base = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * f32(0.5) \
            * (f32(1) + np.cos(f32(np.pi) * frac))
    elif cfg.schedule == "wsd":
        decay_start = total * (1 - cfg.decay_frac)
        frac = np.clip((s - f32(decay_start))
                       / f32(max(total - decay_start, 1)), 0.0, 1.0)
        base = f32(1.0) - f32(1 - cfg.min_lr_frac) * frac
    elif cfg.schedule == "constant":
        base = f32(1.0)
    else:
        raise ValueError(cfg.schedule)
    return float(f32(cfg.peak_lr) * warm * f32(base))


def adamw_init(params: nn.Module) -> dict:
    """Zero float32 moments keyed by parameter name, and step 0."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.named_parameters()}
    return {"m": zeros(), "v": zeros(), "step": 0}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: dict[str, torch.Tensor],
                 opt_state: dict, params: nn.Module | dict,
                 grad_norm: torch.Tensor | None = None
                 ) -> tuple[nn.Module | dict, dict, dict]:
    """One AdamW step with global-norm clipping, in place (see the module
    note); `grads` is keyed by parameter name, `params` a module or a dict
    {name: tensor}. `grad_norm`, when given, is the clipping norm of the
    full gradients (the sharded step updates local shards). Returns
    (params, new opt_state, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads.values()) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = np.float32(step)
    mhat_c = float(np.float32(1) / (np.float32(1) - np.float32(b1) ** t))
    vhat_c = float(np.float32(1) / (np.float32(1) - np.float32(b2) ** t))
    lr = schedule_fn(cfg, step)
    m_all, v_all = opt_state["m"], opt_state["v"]
    named = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    for name, p in named:
        g = grads[name].float().mul_(scale)
        m = m_all[name].mul_(b1).add_(g, alpha=1 - b1)
        v = v_all[name].mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        u = (m * mhat_c).div_((v * vhat_c).sqrt_().add_(cfg.eps))
        p32 = p.float()
        u.add_(p32, alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(u, alpha=lr)
        else:
            p.copy_(p32.sub_(u, alpha=lr))
    return params, {"m": m_all, "v": v_all, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
