"""Annealed Langevin sampling on SE(3) and the training-time diffusion."""
