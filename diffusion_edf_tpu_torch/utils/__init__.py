"""Utilities: profiling (``profiling.py``)."""
