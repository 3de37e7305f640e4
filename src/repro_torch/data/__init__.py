"""Deterministic synthetic ANNS data (pure numpy)."""
