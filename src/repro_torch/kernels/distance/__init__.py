"""Exact squared-L2 gather-distance kernel (`csrc/gather_l2.cu`)."""
