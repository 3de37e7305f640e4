"""Roofline analysis of the port's steps (PyTorch port of
`repro.roofline`): the H100's peaks and the three terms (`analysis`),
each hand-written kernel's work by formula (`kernel_costs`), and the
dispatch-level counter that replaces the HLO parser (`op_analyzer`)."""

from repro_torch.roofline.analysis import (
    H100,
    HwSpec,
    model_flops,
    roofline_terms,
)

__all__ = ["H100", "HwSpec", "model_flops", "roofline_terms"]
