"""Octree meshes, DoF numbering and hanging-node constraints (NumPy)."""
