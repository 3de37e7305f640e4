"""minicpm-2b [dense] — llama-like, WSD schedule [arXiv:2404.06395].

The WSD (warmup-stable-decay) schedule lives in training/optimizer.py
and is selected by this config's schedule hint (see launch/train.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, rope_theta=10000.0,
    tie_embeddings=True,   # MiniCPM ties embeddings
)
SCHEDULE = "wsd"
