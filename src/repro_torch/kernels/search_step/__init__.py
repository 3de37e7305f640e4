"""Fused whole-search megakernel (`csrc/search_step.cu`), its plain
version, and the oracle it is held against (`ref.py`)."""
