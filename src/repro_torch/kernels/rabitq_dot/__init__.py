"""Fused RaBitQ search-step kernel (`csrc/rabitq_search_step.cu`)."""
