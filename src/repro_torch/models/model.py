"""Model assembly: init / forward / prefill / decode (PyTorch port of
`repro.models.model`, dense family).

The dense family is pre-norm GQA attention + SwiGLU MLP. The JAX package
stacks the layers along a leading axis and scans them; here they are an
`nn.ModuleList` walked by a Python loop (`models/convert.py` splits JAX's
stacked tree). `cfg.remat == "full"` wraps each block in
`torch.utils.checkpoint` under autograd, as `_maybe_remat` wraps the scan
body. `loss_fn` is the JAX package's. The other families (moe, vlm,
audio, ssm, hybrid) are not ported yet: they raise, naming ROADMAP.md A7.

Decode threads an explicit state dict {"k", "v": (L, B, S_cache, Hk, Dh)
caches in `cfg.dtype`, "pos": int}. `prefill` and `decode_step` write the
caches in place (see `decode_attention`).

Entry points that create state (`init_params`, `init_decode_state`) run on
the card unless given `device="cpu"`; with no GPU they raise.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    Attention,
    attention,
    attention_init,
    decode_attention,
)
from repro_torch.models.layers import (
    MLP,
    Embedding,
    RMSNorm,
    Unembed,
    embed,
    embedding_init,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    torch_dtype,
    unembed,
    unembed_init,
)

PORTED_FAMILIES = ("dense",)
AUX_LOSS_WEIGHT = 0.01


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md A7); the port runs {PORTED_FAMILIES}")


class Block(nn.Module):
    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm, mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class Model(nn.Module):
    """The parameters: embedding, blocks, final norm, unembed (None when
    the embeddings are tied)."""

    def __init__(self, embed: Embedding, blocks: list[Block],
                 final_norm: RMSNorm, unembed: Unembed | None):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.unembed = unembed

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


# ================================================================== init
def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None, param_dtype: torch.dtype | None = None) -> Model:
    """Random parameters from a seed (or a generator on `device`), frozen:
    matrices in `param_dtype` (None: `cfg.dtype`, the serving storage;
    torch.float32: training's master weights, the same draws), norm
    scales float32."""
    _require_dense(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}")
    emb = embedding_init(generator, cfg, param_dtype)
    unemb = (None if cfg.tie_embeddings
             else unembed_init(generator, cfg, param_dtype))
    blocks = [Block(rmsnorm_init(cfg, device=dev),
                    attention_init(generator, cfg, param_dtype),
                    rmsnorm_init(cfg, device=dev),
                    mlp_init(generator, cfg, dtype=param_dtype))
              for _ in range(cfg.num_layers)]
    return Model(emb, blocks, rmsnorm_init(cfg, device=dev), unemb)


def param_count(params: Model) -> int:
    return sum(p.numel() for p in params.parameters())


# ================================================================ forward
def _tokens(params: Model, batch: dict) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=params.device)


def _logits(params: Model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.unembed, x, cfg, embed_params=params.embed)


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


def _block(blk: Block, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    x = x + attention(blk.attn, rmsnorm(blk.ln1, x, eps), cfg, positions)
    return x + mlp(blk.mlp, rmsnorm(blk.ln2, x, eps), cfg)


def forward(params: Model, cfg: ModelConfig, batch: dict,
            with_aux: bool = False, return_hidden: bool = False):
    """Full-sequence forward. batch: {"tokens": (B, S)}. Returns logits
    (B, S, padded V) [, aux loss (0 for the dense family)];
    return_hidden=True returns the final-norm hidden states instead
    (retrieval embeddings for serving/rag.py)."""
    _require_dense(cfg)
    x = embed(params.embed, _tokens(params, batch), cfg)
    positions = _positions(x.shape[1], x.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for blk in params.blocks:
        if remat:
            # the recompute in the backward re-runs the block's forward
            # (and so relaunches the flash forward #11)
            x = checkpoint(_block, blk, x, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(blk, x, cfg, positions)
    out = (rmsnorm(params.final_norm, x, cfg.norm_eps) if return_hidden
           else _logits(params, cfg, x))
    if with_aux:
        return out, torch.zeros((), dtype=torch.float32, device=x.device)
    return out


def loss_fn(params: Model, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy + AUX_LOSS_WEIGHT * aux (JAX
    `model.py:233-252`). batch: {"tokens", "labels": (B, S) int}; negative
    labels are masked out. Logits in float32, the vocab padding columns
    at -1e30. Returns (total, {"ce", "aux"})."""
    logits, aux = forward(params, cfg, batch, with_aux=True)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    loss = cross_entropy(logits, labels, cfg.vocab_size)
    return loss + AUX_LOSS_WEIGHT * aux, {"ce": loss, "aux": aux}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0, in float32, the padding
    columns past `vocab_size` at -1e30."""
    # in place on the float32 copy, which nothing else holds: one fewer
    # (B, S, V) float32 tensor at full width
    logits = logits.float().masked_fill_(
        torch.arange(logits.shape[-1], device=logits.device) >= vocab_size,
        -1e30)
    labels = labels.long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    return ((logz - gold) * valid).sum() / valid.sum().clamp(min=1.0)


# ================================================================= decode
def _kv_shape(cfg: ModelConfig, batch: int, max_len: int, n_stack: int):
    window = cfg.sliding_window
    s = min(max_len, window) if window else max_len
    return (n_stack, batch, s, cfg.num_kv_heads, cfg.head_dim)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict:
    """Zero KV caches (L, B, S_cache, Hk, Dh) in cfg.dtype and pos 0."""
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode state")
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = _kv_shape(cfg, batch, max_len, cfg.num_layers)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


def decode_step(params: Model, cfg: ModelConfig, state: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One token for the whole batch. tokens: (B, 1) int. Returns
    (logits (B, 1, V), new state); the caches are updated in place."""
    _require_dense(cfg)
    x = embed(params.embed, _tokens(params, {"tokens": tokens}), cfg)
    pos = int(state["pos"])
    eps = cfg.norm_eps
    for i, blk in enumerate(params.blocks):
        h, _, _ = decode_attention(
            blk.attn, rmsnorm(blk.ln1, x, eps), cfg, state["k"][i],
            state["v"][i], pos, window=cfg.sliding_window)
        x = x + h
        x = x + mlp(blk.mlp, rmsnorm(blk.ln2, x, eps), cfg)
    logits = _logits(params, cfg, x)
    return logits, {"k": state["k"], "v": state["v"], "pos": pos + 1}


def _place_kv(cache: torch.Tensor, kv: torch.Tensor) -> None:
    """Write one layer's prompt K or V (B, S, Hk, Dh) at slots [0, S);
    windowed caches keep the tail (ring slots align when S % window == 0)."""
    s_cache = cache.shape[1]
    if kv.shape[1] > s_cache:
        kv = kv[:, -s_cache:]
    cache[:, :kv.shape[1]] = kv.to(cache.dtype)


def prefill(params: Model, cfg: ModelConfig, batch: dict, max_len: int,
            last_only: bool = False) -> tuple[torch.Tensor, dict]:
    """Process a prompt, returning (logits, primed decode state).

    Assumes prompt length <= cache capacity (and <= window for windowed
    archs). last_only=True computes logits ONLY for the final position:
    serving samples from it alone, and the (B, S, V) logits go away.
    """
    _require_dense(cfg)
    x = embed(params.embed, _tokens(params, batch), cfg)
    b, s, _ = x.shape
    positions = _positions(s, x.device)
    eps = cfg.norm_eps
    state = init_decode_state(cfg, b, max_len, device=x.device)
    for i, blk in enumerate(params.blocks):
        h, (k, v) = attention(blk.attn, rmsnorm(blk.ln1, x, eps), cfg,
                              positions, return_kv=True)
        _place_kv(state["k"][i], k)
        _place_kv(state["v"][i], v)
        x = x + h
        x = x + mlp(blk.mlp, rmsnorm(blk.ln2, x, eps), cfg)
    state["pos"] = s
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x), state
