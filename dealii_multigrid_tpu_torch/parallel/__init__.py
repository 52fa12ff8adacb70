"""Partitioning policies and their quality metrics (host-side, NumPy only)."""
