"""Building-block layers (PyTorch port of `repro.models.layers`).

Conventions:
  * parameters live in small `nn.Module`s, created frozen
    (`requires_grad=False`); training makes them trainable
    (`training/train_loop.py` `init_train_state`). Matrices are stored in
    a parameter dtype: `cfg.dtype` by default (the serving storage), or
    float32 for training's master weights, as the JAX package stores them.
    Every use casts the matrix to the activations' dtype (`x @
    w.astype(dt)` in the JAX package; a no-op when the storage already is
    `cfg.dtype`). Norm scales are float32;
  * projections are bias-free `nn.Linear` holders, so a weight is stored
    (out, in), the transpose of the JAX package's (in, out) matrix
    (`models/convert.py` carries JAX parameters across);
  * matching *_spec fns return the JAX tree's shape holding LOGICAL
    axis names (tuples in the JAX layout: (in, out) matrices);
    `models/convert.py` `named_specs` keys them by the port's parameter
    names and `launch/shardings.py` maps them to the mesh;
  * every init fn draws from an explicit `torch.Generator` on the
    parameters' device, in float32 before any cast, so the float32 and
    the `cfg.dtype` storage come from the same draws. Its numbers differ
    from `jax.random`'s: the tests carry JAX's parameters across instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tensor_parallel as tpm


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0, *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in float32 on the generator's device, then
    cast to `dtype`."""
    std = shape[in_axis] ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(std).to(dtype)


def linear(weight: torch.Tensor) -> nn.Linear:
    """A bias-free `nn.Linear` holding `weight` (out, in) as it is (no
    default initialisation runs)."""
    out_f, in_f = weight.shape
    lin = nn.Linear(in_f, out_f, bias=False, device="meta")
    lin.weight = _frozen(weight)
    return lin


def _init_linear(generator, cfg: ModelConfig, in_f: int, out_f: int,
                 dtype: torch.dtype | None = None) -> nn.Linear:
    # drawn straight into (out, in) storage; fan-in in_f as in JAX
    return linear(dense_init(generator, (out_f, in_f), in_axis=1,
                             dtype=dtype or torch_dtype(cfg)))


def dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """x @ W for a bias-free projection, W cast to x's dtype at use."""
    return F.linear(x, lin.weight.to(x.dtype))


# ------------------------------------------------------------------ RMSNorm
class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _frozen(scale.to(torch.float32))


def rmsnorm_init(cfg: ModelConfig, dim: int | None = None,
                 device=None) -> RMSNorm:
    return RMSNorm(torch.ones((dim or cfg.d_model,), dtype=torch.float32,
                              device=device))


def rmsnorm_spec(cfg: ModelConfig, dim_name: str = "embed") -> dict:
    return {"scale": (dim_name,)}


def rmsnorm(params: RMSNorm, x: torch.Tensor, eps: float,
            reduce=None, width: int | None = None) -> torch.Tensor:
    """float32 statistics and scale, cast back to x's dtype. With `reduce`
    x holds a model rank's channels of a `width`-channel norm, and
    `reduce` sums a (..., 1) channel sum over the ranks that hold the
    others (`tensor_parallel.channel_sum`): the forward's sum of squares
    and the backward's sum of dy·x. Under autograd `_RMSNorm` (the same
    forward ops, a leaner backward); without it the ops themselves, with
    no Function's overhead a call (decode is host-bound)."""
    if torch.is_grad_enabled():
        return _RMSNorm.apply(x, params.scale, eps, reduce, width)
    return _rmsnorm_ops(x, params.scale, eps, reduce, width)[0]


def sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """(..., 1) float32: the sum of squares of x over its channels."""
    xf = x.float()
    return (xf * xf).sum(-1, keepdim=True)


def _rmsnorm_ops(x, scale, eps, reduce=None, width=None):
    """(the normed x in x's dtype, the inverse norms (..., 1))."""
    xf = x.float()
    if reduce is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = reduce(sum_of_squares(xf)) / width
    r = torch.rsqrt(var + eps)
    return (xf * r * scale).to(x.dtype), r


class _RMSNorm(torch.autograd.Function):
    """RMSNorm whose backward keeps x as given and the (..., 1) inverse
    norms, not float32 copies of x: autograd on the plain formula saves
    two (x.float() and the normed x), 8 B a token a channel, which at a
    training shape is a residual's worth four times over. The forward is
    the plain formula's ops; the backward recomputes x.float() and sums
    the same terms (the gradient through the norm and through the
    statistics, whose channel sum `reduce` sums over the ranks of a split
    width: each rank scales its own channels by the statistics)."""

    @staticmethod
    def forward(ctx, x, scale, eps, reduce, width):
        out, r = _rmsnorm_ops(x, scale, eps, reduce, width)
        ctx.save_for_backward(x, r, scale)
        ctx.reduce, ctx.width = reduce, width or x.shape[-1]
        return out

    @staticmethod
    def backward(ctx, g):
        x, r, scale = ctx.saved_tensors
        xf = x.float()
        g32 = g.float()
        dscale = None
        if ctx.needs_input_grad[1]:
            dscale = (g32 * (xf * r)).reshape(-1, xf.shape[-1]).sum(0)
        dy = g32 * scale
        # d var through rsqrt, then the mean over the channels
        dsum = (dy * xf).sum(-1, keepdim=True)
        if ctx.reduce is not None:
            dsum = ctx.reduce(dsum)
        dvar = dsum * (-0.5 * r.pow(3))
        dsq = dvar / ctx.width
        dx = dy * r + dsq * xf + dsq * xf
        return dx.to(x.dtype), dscale, None, None, None


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)                       # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, Dh), positions broadcastable to (..., S). The
    half-split rotation: (x1, x2) are the two halves of the head dim, not
    interleaved pairs; angles in float32."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)
    ang = positions[..., :, None, None].float() * inv   # (..., S, 1, Dh/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- SwiGLU MLP
class MLP(nn.Module):
    def __init__(self, w_gate: nn.Linear, w_up: nn.Linear, w_down: nn.Linear):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def mlp_init(generator, cfg: ModelConfig, d_ff: int | None = None,
             dtype: torch.dtype | None = None) -> MLP:
    d_ff = d_ff or cfg.d_ff
    return MLP(_init_linear(generator, cfg, cfg.d_model, d_ff, dtype),
               _init_linear(generator, cfg, cfg.d_model, d_ff, dtype),
               _init_linear(generator, cfg, d_ff, cfg.d_model, dtype))


def mlp_spec(cfg: ModelConfig) -> dict:
    return {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
            "w_down": ("ff", "embed")}


def mlp(params: MLP, x: torch.Tensor, cfg: ModelConfig,
        tp: "tpm.Plan | None" = None) -> torch.Tensor:
    """SwiGLU. Under a tensor-parallel plan, column-parallel gate and up on
    this rank's ff columns over the whole sequence and a row-parallel down
    whose partial sums go back onto the residual
    (`src/repro/models/layers.py:88-90`: "act_ff", "res_seq")."""
    if tp is not None:
        x = tpm.enter_columns(x, tp)
    h = F.silu(dense(x, params.w_gate)) * dense(x, params.w_up)
    out = dense(h, params.w_down)
    return tpm.leave_rows(out, tp) if tp is not None else out


# -------------------------------------------------------------- Embedding
class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _frozen(table)                    # (padded_vocab, D)


def embedding_init(generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None) -> Embedding:
    return Embedding(dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                in_axis=1, dtype=dtype or torch_dtype(cfg)))


def embedding_spec(cfg: ModelConfig) -> dict:
    return {"table": ("vocab", "embed")}


def embed(params: Embedding, tokens: torch.Tensor, cfg: ModelConfig,
          tp: "tpm.Plan | None" = None) -> torch.Tensor:
    """The rows of `tokens`. Under a tensor-parallel plan the residual it
    starts (`src/repro/models/layers.py:101-105`: "res_seq") is this
    rank's slice of the sequence (whole under no_sp), from this rank's
    vocabulary rows where the padded vocab tiles the model axis."""
    dt = torch_dtype(cfg)
    if tp is not None and tp.vocab:
        return tpm.vocab_parallel_embed(params.table, tokens, dt, tp)
    out = params.table.to(dt)[tokens.long()]
    return tpm.split_seq(out, tp) if tp is not None and tp.sp else out


class Unembed(nn.Module):
    def __init__(self, w_out: nn.Linear):
        super().__init__()
        self.w_out = w_out                             # weight (V, D)


def unembed_init(generator, cfg: ModelConfig,
                 dtype: torch.dtype | None = None) -> Unembed:
    return Unembed(_init_linear(generator, cfg, cfg.d_model,
                                cfg.padded_vocab, dtype))


def unembed_spec(cfg: ModelConfig) -> dict:
    return {"w_out": ("embed", "vocab")}


def unembed(params: Unembed | None, x: torch.Tensor, cfg: ModelConfig,
            embed_params: Embedding | None = None,
            tp: "tpm.Plan | None" = None) -> torch.Tensor:
    """Logits over the padded vocab. Tied: x @ table.T. Under a
    tensor-parallel plan the whole sequence's logits on this rank's
    vocabulary columns where the padded vocab tiles the model axis
    (`src/repro/models/layers.py:118-122`: "act_vocab"), else all of them
    on every rank; x is the residual as the plan carries it."""
    if tp is not None:
        if tp.sp:
            x = tpm.gather_seq(x, tp, split_grad=not tp.vocab)
        elif tp.vocab:
            x = tpm.copy_to_region(x, tp)
    if cfg.tie_embeddings and embed_params is not None:
        return F.linear(x, embed_params.table.to(torch_dtype(cfg)))
    return dense(x, params.w_out)
