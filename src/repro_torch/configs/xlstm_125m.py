"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

12 layers = 6 scanned (mLSTM, sLSTM) pairs. d_ff=0 per spec: the blocks
carry their own internal up/down projections (xLSTM block design).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm_heads=4, ssm_chunk=128,
)
