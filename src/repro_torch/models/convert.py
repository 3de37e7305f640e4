"""Carry a JAX parameter tree across to the port's `Model`.

`params_from_jax(arrays, cfg)` takes the tree `repro.models.init_params`
returns, as numpy arrays (`jax.device_get` of it), and builds the same
function in the port's storage:
  * the stacked leading layer axis of `arrays["blocks"]` is split into
    one `Block` per layer;
  * every projection matrix is transposed from JAX's (in, out) to the
    (out, in) storage of `nn.Linear`; the embedding table stays
    (padded_vocab, D);
  * matrices are cast to `cfg.dtype`, norm scales kept float32.
The tests use it to feed both packages the same weights; real checkpoints
would load the same way.
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


def params_from_jax(arrays: dict, cfg: ModelConfig, device=None) -> Model:
    _require_dense(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def mat(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), dtype=dt, device=dev)

    def lin(a):                      # JAX (in, out) -> nn.Linear (out, in)
        return linear(mat(a).T.contiguous())

    def norm(scale) -> RMSNorm:
        return RMSNorm(torch.tensor(np.asarray(scale, np.float32),
                                    device=dev))

    blk = arrays["blocks"]              # every leaf (L, ...)
    attn, mlp = blk["attn"], blk["mlp"]
    blocks = [Block(norm(blk["ln1"]["scale"][i]),
                    Attention(lin(attn["wq"][i]), lin(attn["wk"][i]),
                              lin(attn["wv"][i]), lin(attn["wo"][i])),
                    norm(blk["ln2"]["scale"][i]),
                    MLP(lin(mlp["w_gate"][i]), lin(mlp["w_up"][i]),
                        lin(mlp["w_down"][i])))
              for i in range(cfg.num_layers)]
    unemb = (None if cfg.tie_embeddings
             else Unembed(lin(arrays["unembed"]["w_out"])))
    return Model(Embedding(mat(arrays["embed"]["table"])), blocks,
                 norm(arrays["final_norm"]["scale"]), unemb)
