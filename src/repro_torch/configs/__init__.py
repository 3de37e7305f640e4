"""Architecture registry: the 10 assigned archs (exact public configs).

``get_config(name)`` returns the full-scale ModelConfig; every config
module also exposes CONFIG. ``--arch <id>`` in the launchers resolves here.
The port's copy of `repro.configs`; the ANNS dataset table lives in
`repro_torch.data.synthetic`.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig
from repro_torch.configs import (
    stablelm_1_6b,
    stablelm_3b,
    starcoder2_7b,
    minicpm_2b,
    granite_moe_1b_a400m,
    olmoe_1b_7b,
    chameleon_34b,
    xlstm_125m,
    zamba2_2_7b,
    hubert_xlarge,
)

ARCHS: dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (
        stablelm_1_6b, stablelm_3b, starcoder2_7b, minicpm_2b,
        granite_moe_1b_a400m, olmoe_1b_7b, chameleon_34b, xlstm_125m,
        zamba2_2_7b, hubert_xlarge,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if cfg.is_encoder and shape.kind in ("decode", "long_decode"):
        return False, "encoder-only arch has no decode step"
    if shape.kind == "long_decode" and not cfg.is_recurrent:
        return False, ("pure full-attention arch: 500k decode needs "
                       "sub-quadratic attention (skip per spec)")
    return True, ""


__all__ = [
    "ARCHS", "get_config", "cell_is_runnable",
    "ModelConfig", "ShapeConfig", "SHAPES",
]
