"""int8 gradient compression for the data-parallel all-reduce (PyTorch
port of `repro.training.compression`).

Per-leaf symmetric int8 quantization with stochastic rounding, in the JAX
package's float32 arithmetic: scale = max|g| / 127 + 1e-30, codes =
clip(round_half_even(g / scale + u), -127, 127) with u uniform in
[-0.5, 0.5), so the compressed gradient is an unbiased estimator.
`compressed_psum` sums a gradient dict over a process group: an
all_reduce(MAX) of the scales, a requantisation to the global scale, an
int32 all_reduce(SUM) of the codes (the JAX package sums int32 too), and
a dequantisation.

The noise comes from an explicit `torch.Generator` (one for each rank),
drawn leaf by leaf in the dict's order; the private `_compress_leaf` and
`_compressed_psum` take it as tensors (the latter through a function of
the leaf), so the tests feed them the draws
`jax.random.uniform` makes. Correctness depends on the names, never on
the order of the leaves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _uniform(generator: torch.Generator, g: torch.Tensor) -> torch.Tensor:
    """Uniform noise in [-0.5, 0.5), float32, of g's shape, on g's
    device."""
    u = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                   device=g.device)
    return u.sub_(0.5)


def _compress_leaf(g: torch.Tensor, noise: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    g = g.float()
    scale = g.abs().max() / 127.0 + 1e-30
    q = torch.round(g / scale + noise).clamp_(-127, 127).to(torch.int8)
    return q, scale


def compress_leaf(generator: torch.Generator, g: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 leaf -> (int8 codes, float32 scale). Stochastic rounding."""
    return _compress_leaf(g, _uniform(generator, g))


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(generator: torch.Generator, grads: dict
                  ) -> tuple[dict, dict]:
    """({name: codes}, {name: scale}) of a gradient dict."""
    out = {n: compress_leaf(generator, g) for n, g in grads.items()}
    return ({n: q for n, (q, _) in out.items()},
            {n: s for n, (_, s) in out.items()})


def decompress_tree(qs: dict, scales: dict) -> dict:
    return {n: decompress_leaf(q, scales[n]) for n, q in qs.items()}


def _compressed_psum(grads: dict, group, noise) -> dict:
    """`noise(name, g)` gives each leaf's uniform draws."""
    qs, scales = {}, {}
    for n, g in grads.items():
        qs[n], scales[n] = _compress_leaf(g, noise(n, g))
    names = list(grads)
    local = torch.stack([scales[n] for n in names])
    glob = local.clone()
    dist.all_reduce(glob, op=dist.ReduceOp.MAX, group=group)
    out = {}
    for i, n in enumerate(names):
        # requantize against the global scale so the int sum is consistent
        codes = torch.round(qs.pop(n).float() * (local[i] / glob[i])).to(
            torch.int32)
        dist.all_reduce(codes, op=dist.ReduceOp.SUM, group=group)
        out[n] = codes.float() * glob[i]
    return out


def compressed_psum(grads: dict, group, generator: torch.Generator
                    ) -> dict:
    """The sum of a gradient dict over `group` (a process group; a mesh
    dimension's is `mesh.get_group(axis)`) through int8 codes. Returns
    float32 tensors."""
    return _compressed_psum(grads, group,
                            lambda n, g: _uniform(generator, g))
