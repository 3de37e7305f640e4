"""Exact squared-L2 kernels: `gather_l2` (`csrc/gather_l2.cu`, "chunked"
loads), `gather_l2_tiled` (`csrc/gather_l2_tiled.cu`, "tiled" loads) and
`pairwise_l2` (`csrc/pairwise_l2.cu`, all pairs)."""
