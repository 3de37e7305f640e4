"""Carry JAX parameter and train-state trees across to the port, and back.

`params_from_jax(arrays, cfg)` takes the tree `repro.models.init_params`
returns, as numpy arrays (`jax.device_get` of it), and builds the same
function in the port's storage:
  * the stacked leading axes of the JAX tree are split into the port's
    module lists: one `Block` a layer of `blocks`, one `Pair` a layer of
    `pairs`, and `mamba_groups`, stacked twice (groups x `attn_every`),
    into a list of groups of `MambaLayer`s;
  * every projection matrix is transposed from JAX's (in, out) to the
    (out, in) storage of `nn.Linear`; the embedding table, the expert
    stacks (E, D, F) / (E, F, D), the conv kernels (K, C) and the sLSTM's
    recurrent matrices keep JAX's layout;
  * the storage dtypes are `init_params`' (matrices in `dtype`, None:
    `cfg.dtype`; float32 where the port always keeps float32).
`named_from_jax` gives any JAX-layout tree (the parameters, or an AdamW
moment of them) keyed by the port's parameter names, and `to_jax_layout`
maps the port's parameters (or a moment dict keyed by their names) back
to the JAX tree as numpy arrays, so the tests compare leaf by leaf and
`training/checkpoint.py` writes and reads the JAX package's checkpoints.
Both take the layout from a `ModelConfig` or from a `Model` (its `cfg`).
`named_specs` maps a tree of logical sharding names in the JAX layout
(`models/model.py` `param_specs`) the same way: a stacked leaf drops its
leading names, one for each stacked axis, and a transposed leaf reverses
its two names.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, init_params

# (JAX key, port suffix, transposed) of each parameter of a sub-tree
_NORM = (("scale", "scale", False),)
_ATTN = tuple((w, f"{w}.weight", True) for w in ("wq", "wk", "wv", "wo"))
_MLP = tuple((w, f"{w}.weight", True) for w in ("w_gate", "w_up", "w_down"))
_MOE = (("router", "router.weight", True), ("w_gate", "w_gate", False),
        ("w_up", "w_up", False), ("w_down", "w_down", False))
_MAMBA = (("in_proj", "in_proj.weight", True), ("conv_w", "conv_w", False),
          ("conv_b", "conv_b", False), ("a_log", "a_log", False),
          ("d_skip", "d_skip", False), ("dt_bias", "dt_bias", False),
          ("norm_scale", "norm.scale", False),
          ("out_proj", "out_proj.weight", True))
_MLSTM = (("w_up", "w_up.weight", True), ("conv_w", "conv_w", False),
          ("conv_b", "conv_b", False),
          *((w, f"{w}.weight", True) for w in ("w_q", "w_k", "w_v", "w_i",
                                                "w_f")),
          ("f_bias", "f_bias", False), ("w_o_gate", "w_o_gate.weight", True),
          ("norm_scale", "norm.scale", False),
          ("w_down", "w_down.weight", True))
_SLSTM = (("w_in", "w_in.weight", True), ("r", "r", False),
          ("bias", "bias", False), ("w_ff_up", "w_ff_up.weight", True),
          ("w_ff_down", "w_ff_down.weight", True))


def _leaves(cfg: ModelConfig | Model):
    """(port parameter name, JAX path, index into the JAX leaf's stacked
    axes, transposed) for every parameter."""
    if isinstance(cfg, Model):
        cfg = cfg.cfg
    out = []

    def add(port: str, jax_path: tuple, index: tuple, table) -> None:
        out.extend((f"{port}.{suffix}", jax_path + (key,), index, t)
                   for key, suffix, t in table)

    if cfg.frontend == "frames":
        out.append(("frontend.proj.weight", ("frontend", "proj"), (), True))
    else:
        out.append(("embed.table", ("embed", "table"), (), False))
    fam = cfg.family
    if fam == "ssm":
        for i in range(cfg.num_layers // 2):
            for sub, table in (("ln1", _NORM), ("mlstm", _MLSTM),
                               ("ln2", _NORM), ("slstm", _SLSTM)):
                add(f"pairs.{i}.{sub}", ("pairs", sub), (i,), table)
    elif fam == "hybrid":
        for g in range(cfg.num_layers // cfg.attn_every):
            for j in range(cfg.attn_every):
                for sub, table in (("ln", _NORM), ("mamba", _MAMBA)):
                    add(f"mamba_groups.{g}.{j}.{sub}", ("mamba_groups", sub),
                        (g, j), table)
        add("shared_attn.ln", ("shared_attn", "ln"), (), _NORM)
        add("shared_attn.attn", ("shared_attn", "attn"), (), _ATTN)
    else:
        ffn = ("moe", _MOE) if fam == "moe" else ("mlp", _MLP)
        for i in range(cfg.num_layers):
            for sub, table in (("ln1", _NORM), ("attn", _ATTN),
                               ("ln2", _NORM), ffn):
                add(f"blocks.{i}.{sub}", ("blocks", sub), (i,), table)
    out.append(("final_norm.scale", ("final_norm", "scale"), (), False))
    if not cfg.tie_embeddings:
        out.append(("unembed.w_out.weight", ("unembed", "w_out"), (), True))
    return out


def named_from_jax(arrays: dict, cfg: ModelConfig | Model
                   ) -> dict[str, np.ndarray]:
    """{port parameter name: float32 array in the port's layout} from a
    JAX-layout tree (the parameters, or an AdamW moment of them)."""
    out = {}
    for name, path, index, transposed in _leaves(cfg):
        a = arrays
        for key in path:
            a = a[key]
        a = np.asarray(a[index] if index else a, np.float32)
        out[name] = np.ascontiguousarray(a.T if transposed else a)
    return out


def named_specs(spec_tree: dict, cfg: ModelConfig | Model
                ) -> dict[str, tuple]:
    """{port parameter name: logical spec in the port's layout} from a
    JAX-layout spec tree (`param_specs(cfg)`)."""
    out = {}
    for name, path, index, transposed in _leaves(cfg):
        spec = spec_tree
        for key in path:
            spec = spec[key]
        spec = tuple(spec)[len(index):]
        out[name] = spec[::-1] if transposed else spec
    return out


@torch.no_grad()
def params_from_jax(arrays: dict, cfg: ModelConfig, device=None,
                    dtype: torch.dtype | None = None) -> Model:
    """The port's `Model` holding the numbers of a JAX parameter tree, in
    `init_params`' storage (matrices in `dtype`, None: `cfg.dtype`)."""
    model = init_params(cfg, 0, device=device, param_dtype=dtype)
    named = named_from_jax(arrays, cfg)
    params = dict(model.named_parameters())
    if set(params) != set(named):
        raise ValueError(f"{cfg.name}: the layouts differ in "
                         f"{sorted(set(params) ^ set(named))[:4]}")
    for name, p in params.items():
        p.copy_(torch.tensor(named[name]))
    return model


def to_jax_layout(params, cfg: ModelConfig | Model) -> dict:
    """The port's parameters (a `Model`, or a dict {parameter name:
    tensor} such as an AdamW moment) as the JAX package's tree of float32
    numpy arrays: layers stacked (mamba_groups twice), projections back
    to (in, out)."""
    named = (dict(params.named_parameters()) if isinstance(params, Model)
             else params)
    stacked: dict = {}
    tree: dict = {}
    for name, path, index, transposed in _leaves(cfg):
        # a copy: the arrays must not follow later in-place updates
        a = named[name].detach().to("cpu", torch.float32, copy=True).numpy()
        a = a.T if transposed else a
        if index:
            stacked.setdefault(path, {})[index] = a
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    for path, parts in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _stack(parts)
    return tree


def _stack(parts: dict) -> np.ndarray:
    """{index tuple: array} -> one array stacked along len(index) leading
    axes, in index order."""
    keys = sorted(parts)
    shape = tuple(max(k[d] for k in keys) + 1 for d in range(len(keys[0])))
    out = np.stack([parts[k] for k in keys])
    return out.reshape(shape + out.shape[1:])
