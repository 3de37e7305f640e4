"""GQA flash-attention kernels — the forwards (`csrc/flash_attention.cu`)
and the backward (`csrc/flash_attention_bwd.cu`) — their plain versions
and the autograd Function that joins them."""
