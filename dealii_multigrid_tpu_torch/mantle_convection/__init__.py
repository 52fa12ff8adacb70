"""Boussinesq convection on the port's Stokes models (the reference points its
mantle-convection workload at an external ASPECT fork)."""
