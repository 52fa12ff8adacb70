"""Operators, transfers and kernels of the hybrid patch engine."""
