"""Irreps metadata, group-theory constants, SH, Wigner-D and quaternion algebra."""
