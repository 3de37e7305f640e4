"""Carry JAX parameter and train-state trees across to the port, and back.

`params_from_jax(arrays, cfg)` takes the tree `repro.models.init_params`
returns, as numpy arrays (`jax.device_get` of it), and builds the same
function in the port's storage:
  * the stacked leading layer axis of `arrays["blocks"]` is split into
    one `Block` per layer;
  * every projection matrix is transposed from JAX's (in, out) to the
    (out, in) storage of `nn.Linear`; the embedding table stays
    (padded_vocab, D);
  * matrices are cast to `dtype` (None: `cfg.dtype`, the serving storage;
    torch.float32 keeps the JAX package's float32 masters), norm scales
    kept float32.
`named_from_jax` gives any JAX-layout tree (the parameters, or an AdamW
moment of them) keyed by the port's parameter names, and `to_jax_layout`
maps the port's parameters (or a moment dict keyed by their names) back
to the JAX tree as numpy arrays, so the tests compare leaf by leaf and
`training/checkpoint.py` writes and reads the JAX package's checkpoints.
Both take the layout from a `ModelConfig` or from a `Model` itself (its
layer count and whether the embeddings are tied are all they need).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.layers import (
    MLP,
    Embedding,
    RMSNorm,
    Unembed,
    linear,
    torch_dtype,
)
from repro_torch.models.model import Block, Model, _require_dense

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")


def _layout(cfg: ModelConfig | Model) -> tuple[int, bool]:
    """(layers, tied embeddings) of a config, or of a dense Model."""
    if isinstance(cfg, Model):
        return len(cfg.blocks), cfg.unembed is None
    _require_dense(cfg)
    return cfg.num_layers, cfg.tie_embeddings


def _leaves(cfg: ModelConfig | Model):
    """(port parameter name, JAX path, layer or None, transposed) for
    every parameter, in the port's `named_parameters()` order."""
    num_layers, tied = _layout(cfg)
    out = [("embed.table", ("embed", "table"), None, False)]
    for i in range(num_layers):
        pre = f"blocks.{i}"
        out.append((f"{pre}.ln1.scale", ("blocks", "ln1", "scale"), i, False))
        out += [(f"{pre}.attn.{w}.weight", ("blocks", "attn", w), i, True)
                for w in _ATTN]
        out.append((f"{pre}.ln2.scale", ("blocks", "ln2", "scale"), i, False))
        out += [(f"{pre}.mlp.{w}.weight", ("blocks", "mlp", w), i, True)
                for w in _MLP]
    out.append(("final_norm.scale", ("final_norm", "scale"), None, False))
    if not tied:
        out.append(("unembed.w_out.weight", ("unembed", "w_out"), None,
                    True))
    return out


def named_from_jax(arrays: dict, cfg: ModelConfig | Model
                   ) -> dict[str, np.ndarray]:
    """{port parameter name: float32 array in the port's layout} from a
    JAX-layout tree (the parameters, or an AdamW moment of them)."""
    out = {}
    for name, path, layer, transposed in _leaves(cfg):
        a = arrays
        for key in path:
            a = a[key]
        a = np.asarray(a if layer is None else a[layer], np.float32)
        out[name] = np.ascontiguousarray(a.T if transposed else a)
    return out


def params_from_jax(arrays: dict, cfg: ModelConfig, device=None,
                    dtype: torch.dtype | None = None) -> Model:
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg)
    named = named_from_jax(arrays, cfg)

    def mat(name) -> torch.Tensor:
        return torch.tensor(named[name], dtype=dt, device=dev)

    def norm(name) -> RMSNorm:
        return RMSNorm(torch.tensor(named[name], device=dev))

    blocks = []
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        blocks.append(Block(
            norm(f"{pre}.ln1.scale"),
            Attention(*(linear(mat(f"{pre}.attn.{w}.weight")) for w in _ATTN)),
            norm(f"{pre}.ln2.scale"),
            MLP(*(linear(mat(f"{pre}.mlp.{w}.weight")) for w in _MLP))))
    unemb = (None if cfg.tie_embeddings
             else Unembed(linear(mat("unembed.w_out.weight"))))
    return Model(Embedding(mat("embed.table")), blocks,
                 norm("final_norm.scale"), unemb)


def to_jax_layout(params, cfg: ModelConfig | Model) -> dict:
    """The port's parameters (a `Model`, or a dict {parameter name:
    tensor} such as an AdamW moment) as the JAX package's tree of float32
    numpy arrays: layers stacked, projections back to (in, out)."""
    named = (dict(params.named_parameters()) if isinstance(params, Model)
             else params)
    tree: dict = {}
    num_layers = _layout(cfg)[0]
    for name, path, layer, transposed in _leaves(cfg):
        # a copy: the arrays must not follow later in-place updates
        a = named[name].detach().to("cpu", torch.float32, copy=True).numpy()
        a = a.T if transposed else a
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if layer is None:
            node[path[-1]] = a
        else:
            node.setdefault(path[-1], [None] * num_layers)[layer] = a
    for sub in ("ln1", "attn", "ln2", "mlp"):
        for key, layers in tree["blocks"][sub].items():
            tree["blocks"][sub][key] = np.stack(layers)
    return tree
