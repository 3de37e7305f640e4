"""Three-term roofline (PyTorch port of `repro.roofline.analysis`).

    compute    = FLOPs      / (chips * peak_FLOPs)
    memory     = bytes      / (chips * HBM_bw)
    collective = coll_bytes / (chips * link_bw)

The counts come from `roofline/op_analyzer.py` (the ops a step
dispatches, and each hand-written kernel's work from
`roofline/kernel_costs.py`), per device; collective bytes are the
result bytes of each collective, the payload a device receives. There
is no HLO here, so `collective_bytes_from_hlo` has no counterpart.

The card's peaks are NVIDIA's data-sheet figures for the H100 SXM
(`nvidia-smi`: "NVIDIA H100 80GB HBM3, 700.00 W"): 3.35 TB/s of HBM3,
989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s float32 outside
them, and NVLink at 450 GB/s each way (900 GB/s per card counting both
directions): the link rate is the rate at which a card receives, which is
what the result-bytes convention counts.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float        # per chip, bf16 (the tensor cores)
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link (H100: NVLink, each way)
    f32_flops: float | None = None   # per chip, float32 (None: peak_flops)


# NVIDIA H100 80GB HBM3, 700.00 W (data sheet, SXM)
H100 = HwSpec(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
              ici_bw=450e9, f32_flops=67e12)


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, n_chips: int = 1,
                   hw: HwSpec = H100, *,
                   f32_flops: float = 0.0) -> dict[str, float]:
    """Seconds per step for each roofline term + the dominant one.

    Pass per-device counts with n_chips=1, as the JAX package does.
    `f32_flops` is the part of `flops` that runs at the float32 rate
    (`hw.f32_flops`); the rest runs at `hw.peak_flops`. With it 0 the
    terms are JAX's `roofline_terms`'."""
    f32_rate = hw.f32_flops or hw.peak_flops
    compute = ((flops - f32_flops) / (n_chips * hw.peak_flops)
               + f32_flops / (n_chips * f32_rate))
    memory = bytes_accessed / (n_chips * hw.hbm_bw)
    collective = collective_bytes / (n_chips * hw.ici_bw)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    return {
        **terms,
        "dominant": dom,
        "bound_s": bound,
        # achievable fraction of the compute roof given the other terms
        "roofline_fraction": compute / bound if bound > 0 else 0.0,
    }


def model_flops(n_params_active: int, n_tokens: int,
                training: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D for a train step (2 fwd + 4 bwd per param-token),
    2*N*D for inference."""
    mult = 6.0 if training else 2.0
    return mult * n_params_active * n_tokens
