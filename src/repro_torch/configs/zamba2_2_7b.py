"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242].

54 Mamba2 layers (d_state=64) with ONE shared-parameter GQA attention block
applied every 6 layers (9 applications). At 500k decode the shared block
runs on a 4096-token sliding window (full attention there would be the
quadratic path the spec excludes); Mamba2 state carries the long range.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state_dim=64, ssm_expand=2, ssm_chunk=64, attn_every=6,
    sliding_window=4096,
)
