"""GQA flash-attention forward kernels (`csrc/flash_attention.cu`) and
their plain versions."""
