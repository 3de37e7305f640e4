"""LM model substrate (PyTorch port of `repro.models`, all six families):
`nn.Module` parameters + plain functions, as the JAX package's pytrees +
pure functions."""

from repro_torch.models.model import (
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    param_count,
    prefill,
)

__all__ = [
    "init_params", "forward", "init_decode_state", "decode_step", "prefill",
    "param_count", "loss_fn",
]
