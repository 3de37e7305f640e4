"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447].

The conv waveform frontend is a STUB per spec: input_specs() supplies
precomputed frame embeddings (B, S, 1280); the backbone is the exact
48L/1280 bidirectional transformer with 504 HuBERT cluster targets.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, is_encoder=True, frontend="frames",
)
