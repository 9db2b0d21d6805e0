"""Equivariant layers, tensor products, graph attention and the fused edge kernel."""
