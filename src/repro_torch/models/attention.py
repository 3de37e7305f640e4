"""GQA attention: blockwise / flash-kernel prefill + cached decode (PyTorch
port of `repro.models.attention`).

The full-sequence path dispatches on `cfg.use_flash_kernel` exactly as
the JAX package does: the flash-attention kernel (`kernels/
flash_attention`: CUDA on the card, its plain version on the CPU; under
autograd its `torch.autograd.Function`, forward #11 and backward #12), or
`blockwise_attention`, a plain copy of the JAX blockwise loop that is the
alternative and the numerical reference (differentiable by autograd).
The JAX package's sharding constraints (`constrain`, ported in
`models/sharding_ctx.py`) are not threaded here: the sharded train step
gathers the parameters and runs this code on plain local tensors, so no
DTensor reaches the kernels. Under its tensor-parallel plan
(`models/tensor_parallel.py`) `attention` takes JAX's two branches
(`src/repro/models/attention.py:55-65`) by hand: this rank's heads, or,
where the kv heads do not tile the model axis, its slice of the queries
against the all-gathered K/V.

GQA: q heads H = G * Hk grouped as (B, S, Hk, G, Dh), so query head `hi`
reads KV head `hi // G`.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import tensor_parallel as tpm
from repro_torch.models.layers import (
    _init_linear,
    apply_rope,
    dense,
    linear,
)

_NEG = -1e30


class Attention(nn.Module):
    def __init__(self, wq: nn.Linear, wk: nn.Linear, wv: nn.Linear,
                 wo: nn.Linear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def attention_init(generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None) -> Attention:
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return Attention(_init_linear(generator, cfg, d, h * dh, dtype),
                     _init_linear(generator, cfg, d, hk * dh, dtype),
                     _init_linear(generator, cfg, d, hk * dh, dtype),
                     _init_linear(generator, cfg, h * dh, d, dtype))


def attention_spec(cfg: ModelConfig) -> dict:
    return {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}


def _project_qkv(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, heads: int = 0):
    """q, k, v of x at `positions`; `heads` (0: all): the number of local q
    heads when the weights are this rank's rows (the kv heads in
    proportion)."""
    b, s, _ = x.shape
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if heads:
        h, hk = heads, hk * heads // h
    q = dense(x, params.wq).reshape(b, s, h, dh)
    k = dense(x, params.wk).reshape(b, s, hk, dh)
    v = dense(x, params.wv).reshape(b, s, hk, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_offset: int = 0, window: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 1024
                        ) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, Hk, Dh) -> (B, Sq, H, Dh).

    q_offset: absolute position of q[0] relative to k[0] (prefill = 0).
    window > 0 limits attention to the last `window` key positions.
    Online softmax over KV chunks per Q chunk, all in float32.
    """
    b, sq, h, dh = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = dh ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq, nkv = sq // q_chunk, skv // kv_chunk
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"blockwise_attention: chunks ({q_chunk}, "
                         f"{kv_chunk}) do not divide ({sq}, {skv})")
    dev = q.device
    qg = q.reshape(b, nq, q_chunk, hk, g, dh).float()
    kc = k.reshape(b, nkv, kv_chunk, hk, dh).float()
    vc = v.reshape(b, nkv, kv_chunk, hk, dh).float()
    q_pos = torch.arange(sq, device=dev).reshape(nq, q_chunk) + q_offset
    k_pos = torch.arange(skv, device=dev).reshape(nkv, kv_chunk)

    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi]                                  # (B, Tq, Hk, G, Dh)
        qp = q_pos[qi]
        m = torch.full((b, hk, g, q_chunk), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hk, g, q_chunk, dh), dtype=torch.float32,
                          device=dev)
        for ki in range(nkv):
            kp = k_pos[ki]
            s_blk = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, kc[:, ki]) * scale
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kp[None, :] <= qp[:, None]
            if window > 0:
                mask &= kp[None, :] > (qp[:, None] - window)
            s_blk = torch.where(mask, s_blk, _NEG)
            new_m = torch.maximum(m, s_blk.amax(-1))
            p = torch.exp(s_blk - new_m[..., None])
            corr = torch.exp(m - new_m)
            l = l * corr + p.sum(-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bhgqk,bkhd->bhgqd", p, vc[:, ki]))
            m = new_m
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,Hk,G,Tq,Dh)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,Tq,Hk,G,Dh)
    out = torch.cat(outs, dim=1).reshape(b, sq, h, dh)
    return out.to(q.dtype)


def _attend(q, k, v, cfg: ModelConfig, q_offset: int = 0) -> torch.Tensor:
    """The flash kernels (#11/#12 under autograd, #10 otherwise) or the
    blockwise loop, as `cfg.use_flash_kernel` says."""
    causal = cfg.causal and not cfg.is_encoder
    if cfg.use_flash_kernel:
        return flash_attention(
            q, k, v, causal=causal, window=cfg.sliding_window,
            q_offset=q_offset, block_q=min(cfg.attn_chunk_q, 256),
            block_kv=cfg.attn_chunk_kv)
    return blockwise_attention(
        q, k, v, causal=causal, window=cfg.sliding_window, q_offset=q_offset,
        q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv)


def attention(params: Attention, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, return_kv: bool = False,
              tp: "tpm.Plan | None" = None, cache_slots: int = 0):
    """Full-sequence attention sublayer (prefill / forward). Under a
    tensor-parallel plan x is the residual as the plan carries it and so
    is the result (`_tp_attention`); there `return_kv` returns the K/V of
    this rank's shard of a cache of `cache_slots` slots a rank."""
    if tp is not None:
        return _tp_attention(params, x, cfg, tp,
                             cache_slots if return_kv else 0)
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, cfg)
    out = dense(out.reshape(b, s, cfg.num_heads * cfg.head_dim), params.wo)
    if return_kv:
        return out, (k, v)
    return out


def _tp_attention(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                  tp: "tpm.Plan", cache_slots: int = 0):
    """Attention split over the model axis, JAX's two branches
    (`src/repro/models/attention.py:55-65`):

      * heads ("act_heads"/"act_kv" on "model", where the kv heads tile
        it): the whole sequence (all-gathered under SP) projected onto
        this rank's h/tp q and hk/tp kv heads, the kernels at the local
        head count, the row-parallel `wo`, and its partial sums
        reduce-scattered back onto the residual (`:153`, "res_seq");
      * context parallel ("attn_seq" on "model"): q, k, v from this rank's
        slice of the sequence (split off the whole residual under no_sp)
        at their global positions, K/V all-gathered (their gradients
        reduce-scattered), the kernels with `q_offset` at the slice's
        start, and `wo` on the local rows, whole (a serving plan keeps
        the weights' shards: they are gathered here).

    With `cache_slots` (prefill) it returns (out, (k, v)) for this rank's
    shard of the cache: its kv heads over the prompt, or the rows of the
    gathered K/V in its slice [rank·cache_slots, (rank+1)·cache_slots) of
    the cache's positions (none where the prompt ends before it)."""
    if tp.heads:
        x = tpm.enter_columns(x, tp)
        b, s, _ = x.shape
        heads = cfg.num_heads // tp.size
        q, k, v = _project_qkv(params, x, cfg, _positions(0, s, x.device),
                               heads)
        out = _attend(q, k, v, cfg)
        out = dense(out.reshape(b, s, heads * cfg.head_dim), params.wo)
        out = tpm.leave_rows(out, tp)
        return (out, (k, v)) if cache_slots else out
    if not tp.sp:
        x = tpm.split_seq(x, tp)
    if tp.serving:
        params = Attention(*(linear(tpm.all_gather(w.weight, tp, d))
                             for w, d in ((params.wq, 0), (params.wk, 0),
                                          (params.wv, 0), (params.wo, 1))))
    b, n, _ = x.shape
    start = tp.rank * n
    q, k, v = _project_qkv(params, x, cfg, _positions(start, n, x.device))
    k, v = tpm.gather_seq(k, tp), tpm.gather_seq(v, tp)
    out = _attend(q, k, v, cfg, q_offset=start)
    out = dense(out.reshape(b, n, cfg.num_heads * cfg.head_dim), params.wo)
    out = out if tp.sp else tpm.gather_seq(out, tp, split_grad=True)
    if not cache_slots:
        return out
    lo = tp.rank * cache_slots
    return out, (k[:, lo:lo + cache_slots], v[:, lo:lo + cache_slots])


def _positions(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32,
                        device=device)[None, :]


def decode_attention(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                     *, window: int = 0, tp: "tpm.Plan | None" = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode with a KV cache.

    x: (B, 1, D); k_cache/v_cache: (B, S_max, Hk, Dh); pos: number of
    tokens already in the cache (= this token's position). For window
    caches, S_max == window and writes wrap (ring buffer). The new K/V row
    is written into the caches IN PLACE (the JAX package returns updated
    copies; a copy of a full-width cache per token would cost its size).
    Returns (out (B, 1, D), k_cache, v_cache). Under a serving plan x is
    whole on every rank and the caches are this rank's shard, as JAX's
    `decode_state_shardings` lays them out
    (`src/repro/launch/shardings.py:63-73`): where the kv heads tile the
    model axis, its h/tp q and hk/tp kv heads (column-parallel projections
    on its weight shards) against its (B, S_max, hk/tp, Dh) cache and the
    row-parallel `wo`, its partial sums all-reduced; else its slice of
    the cache's sequence (`_split_kv_decode`).
    """
    if tp is not None and not tp.heads:
        return _split_kv_decode(params, x, cfg, k_cache, v_cache, pos,
                                window, tp)
    b = x.shape[0]
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hk
    heads = h if tp is None else h // tp.size
    s_max = k_cache.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions, heads)

    slot = pos % s_max if window > 0 else pos
    _write_slot(k_cache, v_cache, k, v, slot)
    out = _decode_core(q.reshape(b, 1, heads // g, g, dh).float(), k_cache,
                       v_cache, pos, window)
    out = dense(out.reshape(b, 1, heads * dh).to(x.dtype), params.wo)
    if tp is not None:
        out = tpm.reduce_from_region(out, tp)
    return out, k_cache, v_cache


def _write_slot(k_cache, v_cache, k, v, slot: int) -> None:
    if not 0 <= slot < k_cache.shape[1]:
        raise IndexError(f"decode position {slot} past the cache's "
                         f"{k_cache.shape[1]} slots")
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)


def _decode_core(qg: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: int, window: int
                 ) -> torch.Tensor:
    """The query (B, 1, Hk, G, Dh) float32 against the whole cache at
    `pos`: (B, 1, Hk, G, Dh) float32 (JAX's einsum, masked softmax,
    einsum)."""
    s_max = k_cache.shape[1]
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg,
                          k_cache.float()) * (qg.shape[-1] ** -0.5)
    s_idx = torch.arange(s_max, device=qg.device)
    if window > 0:
        # ring buffer: slots hold the last min(pos+1, window) positions, so
        # every slot written so far is within the window by construction
        written = min(pos + 1, s_max)
        valid = s_idx < max(written, 1)
    else:
        valid = s_idx <= pos
    scores = torch.where(valid[None, None, None, None, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqs,bshd->bqhgd", p, v_cache.float())


def decode_partials(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor) -> tuple:
    """One slice's partial softmax terms for split-KV decode: the query
    (B, 1, Hk, G, Dh) float32 against k/v (B, n, Hk, Dh), `valid` (n,) the
    slots it reads. Returns (m, l, o) float32 as
    `tensor_parallel.combine_partials` takes them: m (B, Hk, G, 1) the row
    max (-1e30 where no slot is valid), l the sum of exp(s - m) over the
    valid slots only (0 for an empty slice, not a softmax over unwritten
    slots), o (B, Hk, G, 1, Dh) the sum of exp(s - m)·v."""
    s = torch.einsum("bqhgd,bshd->bhgqs", qg,
                     k.float()) * (qg.shape[-1] ** -0.5)
    s = torch.where(valid, s, _NEG)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("bhgqs,bshd->bhgqd", p, v.float())


def _split_kv_decode(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                     window: int, tp: "tpm.Plan"):
    """Split-KV decode: q, k and v projected column-parallel on the rank's
    weight shards and all-gathered (every rank holds the token's whole q);
    only the rank whose slice [rank·n, (rank+1)·n) holds slot `pos` writes
    the new row; every rank scores its slice (`decode_partials`), the
    partials are combined over "model" (`tensor_parallel.
    combine_over_model`), and `wo` runs row-parallel on the rank's block of
    the heads' columns, all-reduced."""
    b = x.shape[0]
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hk
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if window:
        raise ValueError("split-KV decode has no ring buffer: a windowed "
                         "cache must tile the model axis by its kv heads")
    q, k, v = (tpm.all_gather(dense(x, w), tp, 2)
               for w in (params.wq, params.wk, params.wv))
    q = apply_rope(q.reshape(b, 1, h, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, 1, hk, dh), positions, cfg.rope_theta)
    v = v.reshape(b, 1, hk, dh)
    n = k_cache.shape[1]
    start = tp.rank * n
    if start <= pos < start + n:
        _write_slot(k_cache, v_cache, k, v, pos - start)
    valid = torch.arange(start, start + n, device=x.device) <= pos
    m, l, o = decode_partials(q.reshape(b, 1, hk, g, dh).float(), k_cache,
                              v_cache, valid)
    out = tpm.combine_over_model(m, l, o, tp)          # (B, Hk, G, 1, Dh)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h * dh).to(x.dtype)
    cols = h * dh // tp.size
    out = dense(out[..., tp.rank * cols:(tp.rank + 1) * cols], params.wo)
    return tpm.reduce_from_region(out, tp), k_cache, v_cache
