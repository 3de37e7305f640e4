"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

The modality frontend is a STUB per spec: input_specs() supplies
interleaved text + VQ image token ids; the backbone below is the exact
48L/8192 transformer with GQA kv=8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, rope_theta=10000.0,
)
