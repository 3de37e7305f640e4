"""Batched decode serving loop (PyTorch port of `repro.serving.serve_loop`).

`make_serve_step` returns the one-token step; `generate` is the host
loop (greedy or temperature sampling). Greedy decoding is the argmax
over the PADDED vocab, as in the JAX package, and matches it token for
token; temperature sampling draws from a `torch.Generator`, whose bits
cannot match `jax.random`.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import synchronize
from repro_torch.models.model import Model, decode_step, prefill


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens (B,1)) -> (logits (B,1,V), state')."""

    def serve_step(params, state, tokens):
        return decode_step(params, cfg, state, tokens)

    return serve_step


@torch.inference_mode()
def generate(params: Model, cfg: ModelConfig, prompts, *,
             max_new_tokens: int, max_len: int | None = None,
             temperature: float = 0.0, seed: int = 0,
             timings: dict | None = None) -> torch.Tensor:
    """Greedy/temperature generation. prompts: (B, S) int -> (B, S +
    max_new_tokens) int32. `timings`, when given, receives the seconds of
    the prefill (with its first token) and of the decode steps, each
    ending in a device synchronisation."""
    dev = params.device
    prompts = torch.as_tensor(prompts, device=dev).to(torch.int32)
    b, s = prompts.shape
    max_len = max_len or (s + max_new_tokens)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if temperature > 0.0 else None)
    t0 = time.perf_counter()
    logits, state = prefill(params, cfg, {"tokens": prompts},
                            max_len=max_len)
    step = make_serve_step(cfg)
    cur = _sample(logits[:, -1], temperature, gen)
    if timings is not None:
        synchronize(dev)
        t1 = time.perf_counter()
        timings["prefill_s"] = t1 - t0
    out = [prompts, cur]
    for _ in range(max_new_tokens - 1):
        logits, state = step(params, state, cur)
        cur = _sample(logits[:, -1], temperature, gen)
        out.append(cur)
    if timings is not None:
        synchronize(dev)
        timings["decode_s"] = time.perf_counter() - t1
    return torch.cat(out, dim=1)


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator | None) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
