"""Annealed Langevin sampling on SE(3)."""
