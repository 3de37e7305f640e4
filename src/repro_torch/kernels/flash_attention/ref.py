"""Oracle for the flash-attention kernels: the blockwise attention of the
model substrate (`models/attention.py`), as in the JAX package."""

from __future__ import annotations

import torch

from repro_torch.models.attention import blockwise_attention


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, q_chunk=min(64, q.shape[1]),
                               kv_chunk=min(64, k.shape[1]))
